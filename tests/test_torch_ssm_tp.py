"""The recurrent families on sharded parameters (xlstm-350m's mLSTM and
sLSTM, hymba-1.5b's selective SSM beside its attention heads, over
"model") against the one-process port and the JAX package, on the CPU.

The reference's reduced xlstm-350m (7 mLSTM and 1 sLSTM layers), the same
with one mLSTM head (``n_heads=1``: "model" = 2 does not divide it, so
its q, k and v are gathered to the whole head and the cell runs on every
rank) and hymba-1.5b (2 layers, 8 meta tokens; its 16 query heads, 5
padded, and 16 KV heads, 1 padded, split over "model") are built once
each, float32; their parameters reach every process through
``params_from_jax``.  Gloo ranks
(``spawn_ranks``; the bodies are ``tests/torch_ranks.py``, which imports
no JAX) place them on a ``("data", "model")`` mesh by the reference's
``param_shardings`` (``Model.place``) and run, inside ``use_mesh``, on
(1, 2), and beside it on (2, 2) xlstm's training step:

* the forward, a prefill and three decode steps (teacher-forced): logits
  against the one-process port within ``TP_ATOL`` (float32 in other
  summation orders: the row-parallel products are summed across ranks)
  and against the reference within ``LOGIT_ATOL``; hymba with
  ``quantize_dense`` too, its int8 activations and int32 ``int_matmul``
  products bit-identical to the quantization and product of their
  gathered operands, its logits within ``QUANT_LOGIT_ATOL``;
* one AdamW step (ZeRO-1 moments): the loss within ``LOSS_ATOL`` and
  every gradient leaf within ``GRAD_RTOL`` of its largest element of one
  process's; the update within ``OPT_RTOL`` / ``OPT_ATOL`` of one
  process's AdamW fed the ranks' gradients (an element whose gradient is
  below AdamW's eps moves by ~lr times its gradient over eps: the
  sLSTM's input-gate bias has 128 such, ~1e-10, set by float order);
* the decode states laid out as the mixers read them
  (``sharding.state_spec``): ``init_cache``'s, prefill's and
  ``cache_shardings``' alike.

Then, without ranks: ``Model.param_specs`` of the full configs against
the reference's ``param_shardings`` leaf for leaf on four meshes, and the
full configs' state layouts on the production mesh.
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
from repro.models import transformer as jtransformer

from repro_torch.configs.base import get_config
from repro_torch.distributed.sharding import state_spec
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.api import Model, params_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ranks  # noqa: E402
from test_torch_moe_tp import SPEC_MESHES, _port_names  # noqa: E402

#: case -> (arch, reduced() overrides, B, S, prompt)
CASES = {"xlstm": ("xlstm-350m", {}, 2, 19, 16),
         "xlstm-1head": ("xlstm-350m", {"n_heads": 1}, 2, 19, 16),
         "hymba": ("hymba-1.5b", {}, 2, 19, 16)}
#: quantize_dense modes served: xlstm has no dense MLP to quantize
QUANTS = {"xlstm": (False,), "xlstm-1head": (False,),
          "hymba": (False, True)}
#: sharded against one process: float32 in other summation orders
#: (tests/test_torch_tp.py's; observed <= 3e-6 on logits of |x| <= ~5)
TP_ATOL = 5e-5
#: against the reference: tests/test_torch_families.py's and
#: tests/test_torch_tp.py's
LOGIT_ATOL, QUANT_LOGIT_ATOL, LOSS_ATOL = 1e-4, 0.3, 1e-5
#: a step against one process: each gradient leaf over its largest
#: element (observed <= 3.1e-6); the update from equal gradients
#: (tests/test_torch_lm_train.py's OPT_RTOL, OPT_ATOL: the global norm
#: sums in another order)
GRAD_RTOL, OPT_RTOL, OPT_ATOL = 5e-5, 1e-6, 1e-6
TRAIN_B, TRAIN_S, LR = 4, 16, 1e-3
LOGITS = ["forward", "prefill", "decode0", "decode1", "decode2"]


def _cfgs(case, **kw):
    arch, over = CASES[case][:2]
    return (jget_config(arch).reduced(**over, **kw),
            get_config(arch).reduced(**over, **kw))


def _inputs() -> dict:
    """Per case: the reference's parameters as numpy and the tokens; the
    training batch."""
    rng = np.random.RandomState(7)
    out = {"batch": {k: rng.randint(0, 512, (TRAIN_B, TRAIN_S))
                     .astype(np.int32) for k in ("tokens", "targets")}}
    for case, (_, _, b, s, _) in CASES.items():
        jc, _ = _cfgs(case)
        jp = japi.Model(jc).init(jax.random.PRNGKey(0))
        out[case] = {"tree": jax.tree_util.tree_map(np.asarray, jp),
                     "toks": rng.randint(0, 512, (b, s)).astype(np.int32)}
    return out


def _reference(inputs) -> dict:
    """Per case, the reference's serving logits in each mode."""
    out = {}
    for case, (_, _, _, s, prompt) in CASES.items():
        jp = jax.tree_util.tree_map(jnp.asarray, inputs[case]["tree"])
        toks = inputs[case]["toks"]
        for quant in QUANTS[case]:
            jc, _ = _cfgs(case, quantize_dense=quant)
            m = japi.Model(jc)
            logits, _ = jax.jit(jtransformer.lm_forward,
                                static_argnums=0)(jc, jp, jnp.asarray(toks))
            o = out.setdefault(case, {})[quant] = {
                "forward": np.asarray(logits)}
            logits, cache = m.prefill(jp, {"tokens": jnp.asarray(
                toks[:, :prompt])}, max_seq=s + 1)
            o["prefill"] = np.asarray(logits)
            for i in range(prompt, s):
                logits, cache = m.decode_step(
                    jp, jnp.asarray(toks[:, i:i + 1]), cache)
                o[f"decode{i - prompt}"] = np.asarray(logits)
    return out


def _single(inputs) -> dict:
    """The one-process port on the same weights and inputs."""
    out = {}
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    for case, (_, _, _, s, prompt) in CASES.items():
        tree, toks = inputs[case]["tree"], inputs[case]["toks"]
        o = out[case] = {}
        for quant in QUANTS[case]:
            _, cfg = _cfgs(case, quantize_dense=quant)
            o[quant] = torch_ranks.lm_serve_outputs(
                Model(cfg, "cpu"), params_from_jax(cfg, tree, "cpu"), toks,
                prompt, s + 1)
        _, cfg = _cfgs(case)
        o["train"] = torch_ranks.grad_step(
            Model(cfg, "cpu"), params_from_jax(cfg, tree, "cpu"), batch, LR)
    return out


@pytest.fixture(scope="module")
def results():
    """The ranks' results on (1, 2) and, at the same time, xlstm's training
    step on (2, 2); meanwhile, in this process, the reference's logits and
    the one-process port's results."""
    inputs = _inputs()
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}

    def cases(names, serve):
        return {c: (*CASES[c][:2], inputs[c]["tree"], inputs[c]["toks"],
                    CASES[c][4], CASES[c][3] + 1,
                    QUANTS[c] if serve else (), True) for c in names}

    def run(shape, names, serve):
        return spawn_ranks(torch_ranks.ssm_tp_body, shape[0] * shape[1],
                           device="cpu",
                           args=(cases(names, serve), shape, batch, LR))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        pair = pool.submit(run, (1, 2), list(CASES), True)
        square = pool.submit(run, (2, 2), ["xlstm"], False)
        theirs = _reference(inputs)
        one = _single(inputs)
        return {"runs": {(1, 2): pair.result(), (2, 2): square.result()},
                "single": one, "ref": {**inputs, **{
                    c: {**inputs[c], **theirs[c]} for c in CASES}}}


@pytest.fixture(scope="module")
def runs(results):
    return results["runs"]


@pytest.fixture(scope="module")
def single(results):
    return results["single"]


@pytest.fixture(scope="module")
def ref(results):
    return results["ref"]


def test_ranks_import_no_jax_and_shard_the_mixers(runs):
    for shape, ranks in runs.items():
        assert not any(r["jax"] for r in ranks), shape
    x = runs[(1, 2)][0]["xlstm"]["local"]
    # mLSTM: d_inner 256 split by columns, the gates' weights whole
    assert x["layers.0.mlstm.w_up"] == ((128, 128), ["R", "S(1)"])
    assert x["layers.0.mlstm.wq"] == ((256, 128), ["R", "S(1)"])
    assert x["layers.0.mlstm.w_down"] == ((128, 128), ["R", "S(0)"])
    assert x["layers.0.mlstm.w_if"] == ((256, 8), ["R", "R"])
    # sLSTM (layer 7): w_x's four gate blocks split, r whole
    assert x["layers.7.slstm.w_x"] == ((128, 256), ["R", "S(1)"])
    assert x["layers.7.slstm.r"] == ((4, 32, 128), ["R", "R"])
    h = runs[(1, 2)][0]["hymba"]["local"]
    # SSM: w_in column-, w_bc and w_dt row-parallel; attention 16 heads
    # (5 padded) over 2 ranks
    assert h["layers.0.ssm.w_in"] == ((128, 128), ["R", "S(1)"])
    assert h["layers.0.ssm.w_dt"] == ((128, 256), ["R", "S(0)"])
    assert h["layers.0.ssm.dt_bias"] == ((256,), ["R", "R"])
    assert h["layers.0.attn.wq"] == ((128, 256), ["R", "S(1)"])


SERVE = [(case, quant) for case in CASES for quant in QUANTS[case]]


@pytest.mark.parametrize("case,quant", SERVE)
def test_serving_matches_one_process_and_the_reference(runs, single, ref,
                                                       case, quant):
    got = runs[(1, 2)][0][case][f"serve/{quant}"]
    one, theirs = single[case][quant], ref[case][quant]
    atol = QUANT_LOGIT_ATOL if quant else LOGIT_ATOL
    for name in LOGITS:
        if not quant:        # int8 ties may flip between float orders
            np.testing.assert_allclose(got[name], one[name], atol=TP_ATOL,
                                       rtol=0, err_msg=name)
        np.testing.assert_allclose(got[name], theirs[name], atol=atol,
                                   rtol=0, err_msg=name)
    for r in runs[(1, 2)][1:]:     # every rank holds the same whole logits
        np.testing.assert_array_equal(r[case][f"serve/{quant}"]["decode2"],
                                      got["decode2"])


def test_hymba_int8_is_bit_identical(runs):
    """The first quantized linears (an MLP's up, gate, down): the sharded
    int8 activations equal the quantization of their gathered input, and
    the int32 products the exact product of the gathered int8 operands."""
    from repro_torch.core.quantization import symmetric_quantize
    r = runs[(1, 2)][0]["hymba"]["serve/True"]
    assert len(r["quant"]) == 6
    for (xq, acc), (x, wq) in zip(r["quant"], r["quant_inputs"]):
        assert xq.dtype == np.int8 and acc.dtype == np.int32
        q, _ = symmetric_quantize(torch.from_numpy(x), bits=8)
        np.testing.assert_array_equal(xq, q.numpy())
        np.testing.assert_array_equal(
            acc, (xq.astype(np.int64) @ wq.astype(np.int64))
            .astype(np.int32))


TRAIN = [(case, (1, 2)) for case in CASES] + [("xlstm", (2, 2))]


@pytest.mark.parametrize("case,shape", TRAIN)
def test_train_step_matches_one_process(runs, single, ref, case, shape):
    got, want = runs[shape][0][case]["train"], single[case]["train"]
    assert abs(got["loss"] - want["loss"]) <= LOSS_ATOL
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=GRAD_RTOL)
    assert got["grads"].keys() == want["grads"].keys()
    for name, g in want["grads"].items():
        scale = float(np.abs(g).max()) or 1.0
        err = float(np.abs(got["grads"][name] - g).max())
        assert err <= GRAD_RTOL * scale, (name, err, scale)
    from repro_torch.optim.adam import AdamW
    _, cfg = _cfgs(case)
    params = params_from_jax(cfg, ref[case]["tree"], "cpu").trainable_()
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    opt = AdamW(lr=LR)
    opt.update({n: torch.from_numpy(g) for n, g in got["grads"].items()},
               opt.init(params), params)
    for name, p in params.named_parameters():
        np.testing.assert_allclose(got["update"][name],
                                   (p.detach() - before[name]).numpy(),
                                   rtol=OPT_RTOL, atol=OPT_ATOL,
                                   err_msg=name)
    for r in runs[shape][1:]:          # every rank ends with the same
        assert r[case]["train"]["loss"] == got["loss"]


#: (case, layer) -> the state layouts on (1, 2): (group, field) ->
#: placements and local shape (B = 2, whole over the one "data" rank)
LAYOUTS = {
    ("xlstm", 0): {("mlstm", "c"): (["R", "S(1)"], (2, 2, 64, 64)),
                   ("mlstm", "n"): (["R", "S(1)"], (2, 2, 64)),
                   ("mlstm", "m"): (["R", "S(1)"], (2, 2)),
                   ("mlstm", "conv"): (["R", "S(2)"], (2, 3, 128))},
    ("xlstm", 7): {(("slstm", f)): (["R", "R"], (2, 128))
                   for f in ("c", "n", "h", "m")},
    ("xlstm-1head", 0): {("mlstm", "c"): (["R", "R"], (2, 1, 256, 256)),
                         ("mlstm", "n"): (["R", "R"], (2, 1, 256)),
                         ("mlstm", "m"): (["R", "R"], (2, 1)),
                         ("mlstm", "conv"): (["R", "S(2)"], (2, 3, 128))},
    ("hymba", 0): {("ssm", "h"): (["R", "S(1)"], (2, 128, 8)),
                   ("ssm", "conv"): (["R", "S(2)"], (2, 3, 128)),
                   ("kv", "k"): (["R", "S(1)"], (2, 8, 28, 32))},
}


@pytest.mark.parametrize("case,layer", list(LAYOUTS))
def test_decode_states_are_laid_out_as_the_mixers_read_them(runs, case,
                                                            layer):
    lay = runs[(1, 2)][0][case]["layouts"]
    for (group, field), want in LAYOUTS[case, layer].items():
        got = tuple(lay["prefill"][layer][group][field])
        assert got == want, (group, field)
        assert tuple(lay["init"][layer][group][field]) == want
        assert lay["specs"][layer][group][field] == want[0]


# -- without ranks -------------------------------------------------------------

@pytest.mark.parametrize("mesh_key", list(SPEC_MESHES))
@pytest.mark.parametrize("arch", ["xlstm-350m", "hymba-1.5b"])
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
        for name in _port_names(path, cfg):
            mine = spec[1:] if name.startswith("layers.") else spec
            assert got[name] == mine, (name, got[name], mine)
            seen.add(name)
    assert seen == set(got)
    assert cfg.tp_dense and not cfg.fsdp


#: the full configs' states on the production mesh (16 data x 16 model):
#: decode_32k's 128 rows over "data"; xlstm's 4 mLSTM heads do not divide
#: over 16 "model" ranks, so they stay whole
PRODUCTION = [
    ("mlstm", "c", (128, 4, 512, 512), ("data", None, None, None)),
    ("mlstm", "conv", (128, 3, 2048), ("data", None, "model")),
    ("slstm", "h", (128, 1024), ("data", None)),
    ("ssm", "h", (128, 3200, 16), ("data", "model", None)),
    ("ssm", "conv", (1, 3, 3200), (None, None, "model")),
]


@pytest.mark.parametrize("group,field,shape,want", PRODUCTION)
def test_state_specs_on_the_production_mesh(group, field, shape, want):
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(16, 16))
    assert state_spec(group, field, shape, mesh) == want
