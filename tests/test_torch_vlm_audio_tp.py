"""The VLM and audio families on sharded parameters (llama-3.2-vision-11b's
gated cross blocks and whisper-tiny's encoder-decoder, over "model")
against the one-process port and the JAX package, on the CPU.

The reference's reduced llama-3.2-vision-11b (one unit: 4 attention
blocks and a cross block over 16 vision states 64 wide) and whisper-tiny
(2 encoder and 2 decoder layers over 32 frames; its 4 heads padded to 16)
are built once each, float32.  Every cross block's gates start at 0, and
``tanh(0)`` shuts the cross path, so the reference's numpy tree gets
``GATES`` first; both packages then read it (the port through
``params_from_jax``).  Gloo ranks (``spawn_ranks``; the bodies are
``tests/torch_ranks.py``, which imports no JAX) place it on a ("data",
"model") mesh by the reference's ``param_shardings`` (``Model.place``)
and run, inside ``use_mesh``, on (1, 2) and at the same time on (2, 2):

* the forward, a prefill and three decode steps (teacher-forced), the
  vision states or frames in the batch: logits against the one-process
  port within ``TP_ATOL`` (float32 in other summation orders: the
  row-parallel products are summed across ranks) and against the
  reference within ``LOGIT_ATOL``; with ``quantize_dense`` the int8
  activations and int32 ``int_matmul`` products bit-identical to the
  quantization and product of their gathered operands, the logits within
  ``QUANT_LOGIT_ATOL`` of the reference;
* one AdamW step (ZeRO-1 moments), the gates' gradients included: the
  loss within ``LOSS_ATOL``, every gradient leaf within ``GRAD_RTOL`` of
  its largest element of one process's, the update within ``OPT_RTOL`` /
  ``OPT_ATOL`` of one process's AdamW fed the ranks' gradients;
* the attention caches (``k``, ``v``, ``ck``, ``cv``) of ``init_cache``,
  of prefill and of ``cache_shardings`` alike: heads over "model", rows
  over "data";
* the collectives of a forward, a prefill and a decode step: all-reduces
  only, one a row-parallel product (``wo``, the cross block's ``wo``, the
  MLP's ``down``) and one for the vocab-split token lookup, which never
  moves ``tok_emb``.

Then, without ranks: ``Model.param_specs`` of the full configs against
the reference's ``param_shardings`` leaf for leaf on four meshes.
"""
import concurrent.futures
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import get_config as jget_config
from repro.distributed import sharding as jshard
from repro.models import api as japi

from repro_torch.configs.base import get_config
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.api import Model, params_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ranks  # noqa: E402
from test_torch_moe_tp import SPEC_MESHES, _port_names  # noqa: E402

VLM, AUDIO = "llama-3.2-vision-11b", "whisper-tiny"
#: case -> arch
CASES = {"vlm": VLM, "audio": AUDIO}
SHAPES = [(1, 2), (2, 2)]
QUANTS = (False, True)
B, S, PROMPT = 2, 19, 16
#: the cross blocks' gates in the shared tree: tanh(0.5) ~ 0.46 on the
#: attention, tanh(1.0) ~ 0.76 on the MLP
GATES = {"gate_attn": 0.5, "gate_mlp": 1.0}
#: sharded against one process: float32 in other summation orders
#: (tests/test_torch_ssm_tp.py's; observed <= 7.5e-6 on these logits)
TP_ATOL = 5e-5
#: against the reference: tests/test_torch_ssm_tp.py's
LOGIT_ATOL, QUANT_LOGIT_ATOL, LOSS_ATOL = 1e-4, 0.3, 1e-5
#: a step against one process: tests/test_torch_ssm_tp.py's (observed
#: <= 3.0e-6 of each leaf's largest element)
GRAD_RTOL, OPT_RTOL, OPT_ATOL = 5e-5, 1e-6, 1e-6
TRAIN_B, TRAIN_S, LR = 4, 16, 1e-3
LOGITS = ["forward", "prefill", "decode0", "decode1", "decode2"]


def _cfgs(case, **kw):
    return (jget_config(CASES[case]).reduced(**kw),
            get_config(CASES[case]).reduced(**kw))


def _with_gates(tree: dict, cfg) -> dict:
    """The reference's VLM tree with every cross block's gates at GATES."""
    unit = list(tree["unit"])
    for u, bt in enumerate(cfg.layer_pattern()[:len(unit)]):
        if bt == "cross":
            unit[u] = {**unit[u], **{k: np.full_like(unit[u][k], v)
                                     for k, v in GATES.items()}}
    return {**tree, "unit": tuple(unit)}


def _extras(cfg, rng, b: int) -> dict:
    """The batch's inputs beside the tokens, float32 N(0, 1)."""
    if cfg.family == "vlm":
        return {"vision": rng.normal(0, 1, (b, cfg.vision_tokens,
                                            cfg.vision_dim))
                .astype(np.float32)}
    return {"frames": rng.normal(0, 1, (b, cfg.encoder_seq, cfg.d_model))
            .astype(np.float32)}


def _inputs() -> dict:
    """Per case: the reference's parameters as numpy (gates open), the
    tokens, the extras and the training batch."""
    rng = np.random.RandomState(7)
    out = {}
    for case in CASES:
        jc, tc = _cfgs(case)
        tree = jax.tree_util.tree_map(
            np.asarray, japi.Model(jc).init(jax.random.PRNGKey(0)))
        if jc.family == "vlm":
            tree = _with_gates(tree, jc)
        toks = rng.randint(0, tc.vocab_size, (B, S)).astype(np.int32)
        train = rng.randint(0, tc.vocab_size, (TRAIN_B, TRAIN_S + 1)) \
            .astype(np.int32)
        out[case] = {"tree": tree, "toks": toks,
                     "extras": _extras(tc, rng, B),
                     "batch": {"tokens": train[:, :-1],
                               "targets": train[:, 1:],
                               **_extras(tc, rng, TRAIN_B)}}
    return out


def _reference(inputs) -> dict:
    """Per case, the reference's serving logits in each mode."""
    out = {}
    for case in CASES:
        inp = inputs[case]
        jp = jax.tree_util.tree_map(jnp.asarray, inp["tree"])
        toks, extras = inp["toks"], {k: jnp.asarray(v)
                                     for k, v in inp["extras"].items()}
        for quant in QUANTS:
            jc, _ = _cfgs(case, quantize_dense=quant)
            m = japi.Model(jc)
            decode = jax.jit(m.decode_step)
            o = out.setdefault(case, {})[quant] = {"forward": np.asarray(
                jax.jit(m.forward)(jp, {"tokens": jnp.asarray(toks),
                                        **extras}))}
            logits, cache = jax.jit(m.prefill, static_argnames="max_seq")(
                jp, {"tokens": jnp.asarray(toks[:, :PROMPT]), **extras},
                max_seq=S + 1)
            o["prefill"] = np.asarray(logits)
            for i in range(PROMPT, S):
                logits, cache = decode(jp, jnp.asarray(toks[:, i:i + 1]),
                                       cache)
                o[f"decode{i - PROMPT}"] = np.asarray(logits)
    return out


def _single(inputs) -> dict:
    """The one-process port on the same weights and inputs."""
    out = {}
    for case in CASES:
        inp = inputs[case]
        o = out[case] = {}
        for quant in QUANTS:
            _, cfg = _cfgs(case, quantize_dense=quant)
            o[quant] = torch_ranks.lm_serve_outputs(
                Model(cfg, "cpu"), params_from_jax(cfg, inp["tree"], "cpu"),
                inp["toks"], PROMPT, S + 1, inp["extras"])
        _, cfg = _cfgs(case)
        o["train"] = torch_ranks.grad_step(
            Model(cfg, "cpu"), params_from_jax(cfg, inp["tree"], "cpu"),
            {k: torch.from_numpy(v) for k, v in inp["batch"].items()}, LR)
    return out


@pytest.fixture(scope="module")
def results():
    """The ranks' results on (1, 2) and, at the same time, on (2, 2);
    meanwhile, in this process, the reference's logits and the
    one-process port's results."""
    inputs = _inputs()
    cases = {c: (CASES[c], inputs[c]["tree"], inputs[c]["toks"], PROMPT,
                 S + 1, inputs[c]["extras"], inputs[c]["batch"], QUANTS)
             for c in CASES}

    def run(shape):
        return spawn_ranks(torch_ranks.vlm_audio_tp_body,
                           shape[0] * shape[1], device="cpu",
                           args=(cases, shape, LR))
    with concurrent.futures.ThreadPoolExecutor(len(SHAPES)) as pool:
        futures = {shape: pool.submit(run, shape) for shape in SHAPES}
        theirs = _reference(inputs)
        one = _single(inputs)
        return {"runs": {s: f.result() for s, f in futures.items()},
                "single": one, "ref": theirs, "inputs": inputs}


@pytest.fixture(scope="module")
def runs(results):
    return results["runs"]


def test_ranks_import_no_jax_and_shard_the_heads(runs):
    for shape, ranks in runs.items():
        assert not any(r["jax"] for r in ranks), shape
    v = runs[(1, 2)][0]["vlm"]["local"]
    # layer 4 is the unit's cross block: 16 padded heads of 32, 8 a rank;
    # its keys and values project the 64-wide vision states
    assert v["layers.4.cross.wq"] == ((128, 256), ["R", "S(1)"])
    assert v["layers.4.cross.wk"] == ((64, 256), ["R", "S(1)"])
    assert v["layers.4.cross.wv"] == ((64, 256), ["R", "S(1)"])
    assert v["layers.4.cross.wo"] == ((256, 128), ["R", "S(0)"])
    for name in ("gate_attn", "gate_mlp", "norm1", "norm2"):
        assert v[f"layers.4.{name}"][1] == ["R", "R"], name
    assert v["layers.4.mlp.down"] == ((128, 128), ["R", "S(0)"])
    assert v["tok_emb"] == ((256, 128), ["R", "S(0)"])
    a = runs[(1, 2)][0]["audio"]["local"]
    # whisper's 4 heads padded to 16, 8 a rank
    assert a["enc.0.attn.wq"] == ((128, 256), ["R", "S(1)"])
    assert a["dec.1.self.wo"] == ((256, 128), ["R", "S(0)"])
    assert a["dec.1.cross.wk"] == ((128, 256), ["R", "S(1)"])
    assert a["dec.0.mlp.up"] == ((128, 128), ["R", "S(1)"])
    for name in ("enc.0.ln1.w", "dec.1.ln3.b", "enc_ln.w", "dec_ln.b"):
        assert a[name][1] == ["R", "R"], name
    assert a["tok_emb"] == ((256, 128), ["R", "S(0)"])
    assert a["lm_head"] == ((128, 256), ["R", "S(1)"])
    # (2, 2): the weights split over "model" alone
    assert runs[(2, 2)][0]["vlm"]["local"]["layers.4.cross.wq"] \
        == ((128, 256), ["R", "S(1)"])


SERVE = [(case, quant, shape) for case in CASES for quant in QUANTS
         for shape in SHAPES]


@pytest.mark.parametrize("case,quant,shape", SERVE)
def test_serving_matches_one_process_and_the_reference(results, case, quant,
                                                       shape):
    runs = results["runs"][shape]
    got = runs[0][case][f"serve/{quant}"]
    one, theirs = results["single"][case][quant], results["ref"][case][quant]
    atol = QUANT_LOGIT_ATOL if quant else LOGIT_ATOL
    for name in LOGITS:
        if not quant:        # int8 ties may flip between float orders
            np.testing.assert_allclose(got[name], one[name], atol=TP_ATOL,
                                       rtol=0, err_msg=name)
        np.testing.assert_allclose(got[name], theirs[name], atol=atol,
                                   rtol=0, err_msg=name)
    for r in runs[1:]:           # every rank holds the same whole logits
        np.testing.assert_array_equal(r[case][f"serve/{quant}"]["decode2"],
                                      got["decode2"])


def test_the_cross_path_is_open(results):
    """The gates let the vision states and frames reach the logits: the
    reference's forward moves when they change."""
    inputs = results["inputs"]
    for case in CASES:
        jc, _ = _cfgs(case)
        jp = jax.tree_util.tree_map(jnp.asarray, inputs[case]["tree"])
        extras = {k: jnp.asarray(v[::-1])
                  for k, v in inputs[case]["extras"].items()}
        moved = np.asarray(japi.Model(jc).forward(
            jp, {"tokens": jnp.asarray(inputs[case]["toks"]), **extras}))
        want = results["ref"][case][False]["forward"]
        assert np.abs(moved - want).max() > 100 * LOGIT_ATOL, case


@pytest.mark.parametrize("case,shape", [(c, s) for c in CASES
                                        for s in SHAPES])
def test_int8_is_bit_identical(runs, case, shape):
    """The first quantized linears (an MLP's up, gate and down, or up and
    down): the sharded int8 activations equal the quantization of their
    gathered input, and the int32 products the exact product of the
    gathered int8 operands."""
    from repro_torch.core.quantization import symmetric_quantize
    r = runs[shape][0][case]["serve/True"]
    assert len(r["quant"]) == 6
    for (xq, acc), (x, wq) in zip(r["quant"], r["quant_inputs"]):
        assert xq.dtype == np.int8 and acc.dtype == np.int32
        q, _ = symmetric_quantize(torch.from_numpy(x), bits=8)
        np.testing.assert_array_equal(xq, q.numpy())
        np.testing.assert_array_equal(
            acc, (xq.astype(np.int64) @ wq.astype(np.int64))
            .astype(np.int32))


@pytest.mark.parametrize("case,shape", [(c, s) for c in CASES
                                        for s in SHAPES])
def test_train_step_matches_one_process(results, case, shape):
    runs = results["runs"][shape]
    got, want = runs[0][case]["train"], results["single"][case]["train"]
    assert abs(got["loss"] - want["loss"]) <= LOSS_ATOL
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=GRAD_RTOL)
    assert got["grads"].keys() == want["grads"].keys()
    if case == "vlm":            # the open gates take a gradient
        for name in GATES:
            assert abs(float(want["grads"][f"layers.4.{name}"])) > 1e-4
    for name, g in want["grads"].items():
        scale = float(np.abs(g).max()) or 1.0
        err = float(np.abs(got["grads"][name] - g).max())
        assert err <= GRAD_RTOL * scale, (name, err, scale)
    from repro_torch.optim.adam import AdamW
    _, cfg = _cfgs(case)
    params = params_from_jax(cfg, results["inputs"][case]["tree"],
                             "cpu").trainable_()
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    opt = AdamW(lr=LR)
    opt.update({n: torch.from_numpy(g) for n, g in got["grads"].items()},
               opt.init(params), params)
    for name, p in params.named_parameters():
        np.testing.assert_allclose(got["update"][name],
                                   (p.detach() - before[name]).numpy(),
                                   rtol=OPT_RTOL, atol=OPT_ATOL,
                                   err_msg=name)
    for r in runs[1:]:           # every rank ends with the same
        assert r[case]["train"]["loss"] == got["loss"]


#: the attention caches' names a layer of each case: the VLM's 4
#: attention blocks ``k``/``v``, its cross block ``ck``/``cv``; whisper's
#: decoder layers all four
CACHE_NAMES = {"vlm": [(i, n) for i in range(4) for n in ("k", "v")]
               + [(4, "ck"), (4, "cv")],
               "audio": [(i, n) for i in range(2)
                         for n in ("k", "v", "ck", "cv")]}


@pytest.mark.parametrize("case,shape", [(c, s) for c in CASES
                                        for s in SHAPES])
def test_caches_are_laid_out_alike(runs, case, shape):
    """Heads over "model" (16 padded, 8 a rank), rows over "data": the
    same for ``init_cache``'s, prefill's and ``cache_shardings``'."""
    lay = runs[shape][0][case]["layouts"]
    assert sorted(lay["prefill"]) == sorted(CACHE_NAMES[case])
    rows = B // shape[0]
    for key in CACHE_NAMES[case]:
        pl, local = lay["prefill"][key]
        assert pl == ["S(0)" if shape[0] > 1 else "R", "S(1)"], key
        assert local[:2] == (rows, 8), key
        assert lay["init"][key] == lay["prefill"][key], key
        assert lay["specs"][key] == pl, key


def _all_reduces(case: str, call: str) -> int:
    """The layout's count: one all-reduce a row-parallel product (2 a
    VLM layer, self- or cross-attention; 2 a whisper encoder layer, 3 a
    decoder layer) and one for the vocab-split lookup."""
    _, cfg = _cfgs(case)
    if case == "vlm":
        return 1 + 2 * cfg.n_layers
    enc = 0 if call == "decode" else 2 * cfg.encoder_layers
    return 1 + enc + 3 * cfg.n_layers


@pytest.mark.parametrize("case,shape", [(c, s) for c in CASES
                                        for s in SHAPES])
def test_serving_makes_all_reduces_only(runs, case, shape):
    for r in runs[shape]:
        got = r[case]["collectives"]
        for call in ("forward", "prefill", "decode"):
            assert got[call] == {"all-reduce": _all_reduces(case, call)}, \
                (call, got[call])
            assert got[call + "/port"] == 0, call
        assert got["tok_emb_kept"]


# -- without ranks -------------------------------------------------------------

def _names(path, cfg) -> list:
    """The port's leaf names of the reference's leaf at ``path``: the
    encoder-decoder's stacked ``enc`` / ``dec`` leaf is one per layer."""
    keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
    if keys[0] in ("enc", "dec"):
        n = cfg.encoder_layers if keys[0] == "enc" else cfg.n_layers
        rest = ".".join(map(str, keys[1:]))
        return [f"{keys[0]}.{i}.{rest}" for i in range(n)]
    return _port_names(path, cfg)


@pytest.mark.parametrize("mesh_key", list(SPEC_MESHES))
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_param_specs_of_the_full_configs_match_the_reference(arch,
                                                              mesh_key):
    cfg, jcfg = get_config(arch), jget_config(arch)
    shape, axes = SPEC_MESHES[mesh_key]
    model = Model(cfg, "cpu")
    got = model.param_specs(SimpleNamespace(mesh_dim_names=axes,
                                            shape=shape),
                            model.param_shapes())
    shapes = jax.eval_shape(japi.Model(jcfg).init, jax.random.PRNGKey(0))
    want = jshard.param_shardings(AbstractMesh(shape, axes), shapes,
                                  tp_dense=jcfg.tp_dense)
    flat = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: hasattr(x, "spec"))[0]
    seen = set()
    for path, sharding in flat:
        spec = tuple(sharding.spec)
        for name in _names(path, cfg):
            per_layer = name.split(".")[0] in ("layers", "enc", "dec") \
                and name.split(".")[1].isdigit()
            mine = spec[1:] if per_layer else spec
            if per_layer:
                assert spec[:1] in ((), (None,)), (name, spec)
            assert got[name] == mine, (name, got[name], mine)
            seen.add(name)
    assert seen == set(got)
    assert cfg.tp_dense and not cfg.fsdp
