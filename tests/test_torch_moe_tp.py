"""The MoE family on sharded parameters (expert parallel over "model",
FSDP over the data axes) against the one-process port and the JAX
package, on the CPU.

The reference's reduced qwen2-moe-a2.7b and dbrx-132b (float32; dbrx keeps
its 16 routing groups) are built once each; their parameters reach every
process through ``params_from_jax``.  Both take more experts than
``reduced()``'s 4, so that each "model" rank of two holds real ones:
qwen2-moe 12 padded to 16 (its padding on rank 1, as the full config's 60
of 64), dbrx 16, top-4 as the full configs.  Gloo ranks
(``spawn_ranks``; the bodies are ``tests/torch_ranks.py``, which imports
no JAX) place them on a ``("data", "model")`` mesh by the reference's
specs (``Model.place``: qwen2-moe ``param_shardings``, dbrx
``param_shardings_fsdp``) and run, inside ``use_mesh``, on (2, 2), then
beside it on (1, 2):

* the forward with its aux loss, a prefill and three decode steps
  (teacher-forced): logits against the one-process port within
  ``TP_ATOL`` (float32 in other summation orders: each rank combines its
  experts' share, the shares summed over "model") and against the
  reference within ``LOGIT_ATOL`` / ``QUANT_LOGIT_ATOL``; the aux loss
  within ``AUX_ATOL`` / ``LOSS_ATOL``.  The prompt's 32 tokens split into
  dbrx's 16 groups, 8 a data rank; the forward's 38 and a decode step's 2
  do not, so one group spans both data ranks;
* with ``quantize_dense`` (qwen2-moe's shared expert) the int8
  activations and int32 ``int_matmul`` products bit-identical to one
  process's;
* two AdamW steps (ZeRO-1 moments; dbrx's FSDP leaves gathered for use,
  their gradients reduce-scattered): losses within ``LOSS_ATOL``, grad
  norms within ``GNORM_RTOL`` of one process's;
* the (2, 2) state saved and restored onto (1, 2) bit for bit;
  ``Model.init_placed`` (each layer placed as it is drawn) equal to
  ``place(init())``;
* at the full configs' capacity factor (``DROP``: 1.25, so tokens drop),
  the routers' expert ids and kept (token, slot) pairs on (2, 2) equal to
  one process's, at the prefill and at each decode step.

Then, without ranks: ``Model.param_specs`` of the full configs against the
reference's ``param_shardings`` / ``param_shardings_fsdp`` leaf for leaf
on four meshes, and ``Model.place`` of the full configs on a fake (2, 2)
mesh in a subprocess.  About 60 s in one process.
"""
import concurrent.futures
import os
import subprocess
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
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models.api import Model, params_from_jax
from repro_torch.models.transformer import unit_pattern

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: each arch's overrides of reduced() (module docstring)
ARCHS = {"qwen2-moe-a2.7b": {"n_experts": 12, "n_experts_per_tok": 4},
         "dbrx-132b": {"n_experts": 16, "n_experts_per_tok": 4}}
#: quantize_dense modes: dbrx has no dense MLP for it to quantize
QUANTS = {"qwen2-moe-a2.7b": (False, True), "dbrx-132b": (False,)}
#: the full configs' capacity factor, where tokens drop
DROP = {"moe_capacity_factor": 1.25}
#: sharded against one process: float32 in other summation orders
#: (tests/test_torch_tp.py's; observed <= 3e-6 on logits of |x| <= ~5)
TP_ATOL, AUX_ATOL = 5e-5, 1e-6
#: against the reference: tests/test_torch_families.py's
LOGIT_ATOL, QUANT_LOGIT_ATOL, LOSS_ATOL = 1e-4, 0.3, 1e-5
#: an int8 rounding tie's width in float32 inputs of |x| <= ~5 that
#: differ in their last bits (the scaled value's distance from k + 0.5)
TIE = 1e-4
#: two train steps against one process (tests/test_torch_tp.py's)
GNORM_RTOL = 1e-5
B, S, PROMPT, MAX_SEQ = 2, 19, 16, 24
TRAIN_B, TRAIN_S, STEPS, LR = 4, 16, 2, 1e-3
MESHES = [(1, 2), (2, 2)]
LOGITS = ["forward", "prefill", "decode0", "decode1", "decode2"]


def _jcfg(arch, **kw):
    return jget_config(arch).reduced(**ARCHS[arch], **kw)


def _cfg(arch, **kw):
    return get_config(arch).reduced(**ARCHS[arch], **kw)


@pytest.fixture(scope="module")
def ref():
    """Per arch: the reference's parameters as numpy and its serving
    logits and aux loss in each mode; the inputs."""
    rng = np.random.RandomState(5)
    toks = rng.randint(0, 512, (B, S)).astype(np.int32)
    batch = {k: rng.randint(0, 512, (TRAIN_B, TRAIN_S)).astype(np.int32)
             for k in ("tokens", "targets")}
    out = {"toks": toks, "batch": batch}
    for arch in ARCHS:
        jp = japi.Model(_jcfg(arch)).init(jax.random.PRNGKey(0))
        r = out[arch] = {"tree": jax.tree_util.tree_map(np.asarray, jp)}
        for quant in QUANTS[arch]:
            jc = _jcfg(arch, quantize_dense=quant)
            m = japi.Model(jc)
            logits, aux = jax.jit(jtransformer.lm_forward,
                                  static_argnums=0)(jc, jp, jnp.asarray(toks))
            o = {"forward": np.asarray(logits), "aux": float(aux)}
            logits, cache = m.prefill(jp, {"tokens": jnp.asarray(
                toks[:, :PROMPT])}, max_seq=MAX_SEQ)
            o["prefill"] = np.asarray(logits)
            for i in range(PROMPT, S):
                logits, cache = m.decode_step(
                    jp, jnp.asarray(toks[:, i:i + 1]), cache)
                o[f"decode{i - PROMPT}"] = np.asarray(logits)
            r[quant] = o
    return out


@pytest.fixture(scope="module")
def single(ref):
    """The one-process port on the same weights and inputs."""
    out = {}
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    for arch in ARCHS:
        o = out[arch] = {}
        tree = ref[arch]["tree"]
        for quant in QUANTS[arch]:
            cfg = _cfg(arch, quantize_dense=quant)
            o[quant] = torch_ranks.moe_serve_outputs(
                Model(cfg, "cpu"), params_from_jax(cfg, tree, "cpu"),
                ref["toks"], PROMPT, MAX_SEQ)
        cfg = _cfg(arch, **DROP)
        o["routes"] = torch_ranks.moe_routes(
            Model(cfg, "cpu"), params_from_jax(cfg, tree, "cpu"),
            ref["toks"], PROMPT, MAX_SEQ)
        cfg = _cfg(arch)
        o["train"] = torch_ranks.lm_train_outputs(
            Model(cfg, "cpu"), params_from_jax(cfg, tree, "cpu"), batch,
            STEPS, LR)
    return out


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    """Every rank's results on (2, 2), which saves its trained state, and,
    at the same time, on (1, 2), which restores that state at its end."""
    ckpt = str(tmp_path_factory.mktemp("moe_ckpt"))
    cases = {arch: (ARCHS[arch], ref[arch]["tree"], QUANTS[arch], DROP)
             for arch in ARCHS}
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}

    def run(shape, save, restore):
        return spawn_ranks(torch_ranks.moe_tp_body, shape[0] * shape[1],
                           device="cpu",
                           args=(cases, shape, ref["toks"], PROMPT, MAX_SEQ,
                                 batch, STEPS, LR, save, restore))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pair = pool.submit(run, (1, 2), None, ckpt)
        out = {(2, 2): run((2, 2), ckpt, None)}
        out[(1, 2)] = pair.result()
    return out


@pytest.mark.parametrize("arch", list(ARCHS))
def test_ranks_import_no_jax_and_split_the_experts(runs, arch):
    for shape, ranks in runs.items():
        assert not any(r["jax"] for r in ranks), shape
    # 16 experts a layer, 8 a "model" rank; dbrx's FSDP: d_model (128)
    # of w_gate [16, 128, 64] and the router [128, 16] over "data" too
    local = runs[(2, 2)][0][arch]["local"]
    if arch == "dbrx-132b":
        assert local["w_gate"] == ((8, 64, 64), ["S(1)", "S(0)"])
        assert local["router"] == ((64, 8), ["S(0)", "S(1)"])
    else:
        assert local["w_gate"] == ((8, 128, 64), ["R", "S(0)"])
        assert local["router"] == ((128, 8), ["R", "S(1)"])
    assert runs[(1, 2)][0][arch]["local"]["w_down"][0] == (8, 64, 128)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_placed_equals_place_of_init(runs, arch):
    """Each layer laid out as it is drawn: every rank's shards equal
    ``place(init())``'s, leaf for leaf."""
    for shape, ranks in runs.items():
        for r in ranks:
            assert r[arch]["init_placed"] == [], shape


CASES = [(arch, shape, quant) for arch in ARCHS for shape in MESHES
         for quant in QUANTS[arch]]


@pytest.mark.parametrize("arch,shape,quant", CASES)
def test_serving_matches_one_process_and_the_reference(runs, single, ref,
                                                       arch, shape, quant):
    got = runs[shape][0][arch][f"serve/{quant}"]
    one, theirs = single[arch][quant], ref[arch][quant]
    atol = QUANT_LOGIT_ATOL if quant else LOGIT_ATOL
    for name in LOGITS:
        np.testing.assert_allclose(got[name], one[name], atol=TP_ATOL,
                                   rtol=0, err_msg=name)
        np.testing.assert_allclose(got[name], theirs[name], atol=atol,
                                   rtol=0, err_msg=name)
    assert abs(got["aux"] - one["aux"]) <= AUX_ATOL
    assert abs(got["aux"] - theirs["aux"]) <= LOSS_ATOL
    for r in runs[shape][1:]:     # every rank holds the same whole logits
        np.testing.assert_array_equal(r[arch][f"serve/{quant}"]["decode2"],
                                      got["decode2"])
        assert r[arch][f"serve/{quant}"]["aux"] == got["aux"]


@pytest.mark.parametrize("shape", MESHES)
def test_shared_expert_int8_is_bit_identical(runs, single, shape):
    """The shared expert's first 6 quantized linears (2 layers' up, gate,
    down): the sharded int8 activations equal the quantization of their
    gathered input, and the int32 products the exact product of the
    gathered int8 operands, bit for bit.  Against one process, whose
    inputs differ from the ranks' in float32's last bits (the experts'
    shares summed over "model"), an int8 value may differ only where that
    run's scaled input lies within ``TIE`` of a rounding tie."""
    from repro_torch.core.quantization import symmetric_quantize
    r = runs[shape][0]["qwen2-moe-a2.7b"]["serve/True"]
    one = single["qwen2-moe-a2.7b"][True]
    assert len(r["quant"]) == len(one["quant"]) == 6
    flips = 0
    for (xq, acc), (x, wq), (oxq, _), (ox, _) in zip(
            r["quant"], r["quant_inputs"], one["quant"], one["quant_inputs"]):
        assert xq.dtype == np.int8 and acc.dtype == np.int32
        q, _ = symmetric_quantize(torch.from_numpy(x), bits=8)
        np.testing.assert_array_equal(xq, q.numpy())
        np.testing.assert_array_equal(
            acc, (xq.astype(np.int64) @ wq.astype(np.int64))
            .astype(np.int32))
        differ = xq != oxq
        scaled = ox / (np.abs(ox).max() / 127.0)
        assert np.all(np.abs(np.abs(scaled - np.floor(scaled)) - 0.5)
                      [differ] < TIE)
        flips += int(differ.sum())
    assert flips <= 4


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_steps_match_one_process(runs, single, arch, shape):
    got, want = runs[shape][0][arch]["train"], single[arch]["train"]
    np.testing.assert_allclose(got["loss"], want["loss"], atol=LOSS_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=GNORM_RTOL)
    assert got["loss"][1] < got["loss"][0]
    if shape == (2, 2):          # ZeRO-1: the moments split over "data"
        assert "S(" in got["m_placements"][0]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_a_2x2_state_restores_on_1x2_bit_for_bit(runs, arch):
    saved = runs[(2, 2)][0][arch]["saved"]
    for r in runs[(1, 2)]:
        restored = r[arch]["restored"]
        assert restored.keys() == saved.keys()
        for name, value in saved.items():
            np.testing.assert_array_equal(restored[name], value,
                                          err_msg=name)
        # laid out on (1, 2): nothing over the one-rank "data" axis
        assert r[arch]["restored_placements"]["layers.0.moe.w_gate"] \
            == ["R", "S(0)"]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_drop_sets_equal_one_process(runs, single, arch):
    """Router calls: a prefill's (one a layer), then each decode step's;
    a rank routes its data rank's rows (ranks 0, 1: data 0; 2, 3: data
    1), alike on both "model" ranks."""
    ranks = [r[arch]["routes"] for r in runs[(2, 2)]]
    want = single[arch]["routes"]
    layers = _cfg(arch).n_layers
    assert len(want) == layers * (1 + S - PROMPT)
    dropped = []
    for i, (gidx, kept) in enumerate(want):
        for mr in (0, 1):
            rows = [ranks[2 * dr + mr][i] for dr in (0, 1)]
            np.testing.assert_array_equal(
                np.concatenate([g for g, _ in rows]), gidx, err_msg=str(i))
            np.testing.assert_array_equal(
                np.concatenate([k for _, k in rows]), kept, err_msg=str(i))
        dropped.append(int((~kept).sum()))
    # tokens drop at the prefill and at a decode step, where one group
    # spans both data ranks
    assert sum(dropped[:layers]) > 0 and sum(dropped[layers:]) > 0


# -- without ranks -------------------------------------------------------------

SPEC_MESHES = {"production": ((16, 16), ("data", "model")),
               "multi-pod": ((2, 16, 16), ("pod", "data", "model")),
               "(1, 2)": ((1, 2), ("data", "model")),
               "(2, 2)": ((2, 2), ("data", "model"))}


def _port_names(path, cfg) -> list:
    """The port's leaf names of the reference's leaf at ``path``: a
    stacked ``unit[u]`` leaf is layer ``r * len(unit) + u`` of each rep
    ``r``."""
    keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
    if keys[0] != "unit":
        return [".".join(map(str, keys))]
    unit, reps = unit_pattern(cfg)
    rest = ".".join(map(str, keys[2:]))
    return [f"layers.{r * len(unit) + keys[1]}.{rest}" for r in range(reps)]


@pytest.mark.parametrize("mesh_key", list(SPEC_MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_of_the_full_configs_match_the_reference(arch,
                                                              mesh_key):
    cfg, jcfg = get_config(arch), jget_config(arch)
    shape, axes = SPEC_MESHES[mesh_key]
    model = Model(cfg, "cpu")
    got = model.param_specs(SimpleNamespace(mesh_dim_names=axes,
                                            shape=shape),
                            model.param_shapes())
    shapes = jax.eval_shape(japi.Model(jcfg).init, jax.random.PRNGKey(0))
    jfn = (jshard.param_shardings_fsdp if cfg.fsdp
           else jshard.param_shardings)
    want = jfn(AbstractMesh(shape, axes), shapes)
    flat = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: hasattr(x, "spec"))[0]
    seen = set()
    for path, sharding in flat:
        spec = tuple(sharding.spec)
        for name in _port_names(path, cfg):
            # a port layer is one slice of the stacked leaf
            mine = spec[1:] if name.startswith("layers.") else spec
            if name.startswith("layers."):
                assert spec[:1] in ((), (None,)), (name, spec)
            assert got[name] == mine, (name, got[name], mine)
            seen.add(name)
    assert seen == set(got)
    assert cfg.fsdp == (arch == "dbrx-132b")


PLACE = r"""
import json, sys, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs.base import get_config
from repro_torch.distributed.act_sharding import use_mesh
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.api import Model
out = {}
with fake_world(4):
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    for arch in sys.argv[1:]:
        with FakeTensorMode(), use_mesh(mesh):
            model = Model(get_config(arch), "cpu")
            params = model.place(model.init(torch.Generator()), mesh)
            out[arch] = {n: [list(p.shape), list(p.to_local().shape)]
                         for n, p in params.named_parameters()
                         if n.startswith(("layers.0.", "tok_", "lm_"))}
print(json.dumps(out))
"""


def test_place_lays_the_full_configs_out():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", PLACE, *ARCHS], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    import json
    out = json.loads(r.stdout.strip().splitlines()[-1])
    dbrx, qwen = out["dbrx-132b"], out["qwen2-moe-a2.7b"]
    # dbrx: experts over "model", their widest free dim over "data"
    assert dbrx["layers.0.moe.w_gate"] == [[16, 6144, 10752],
                                           [8, 6144, 5376]]
    assert dbrx["layers.0.moe.w_down"] == [[16, 10752, 6144],
                                           [8, 5376, 6144]]
    assert dbrx["layers.0.moe.router"] == [[6144, 16], [3072, 8]]
    assert dbrx["layers.0.norm1"] == [[6144], [3072]]
    # qwen2-moe: 64 experts (60 padded), 32 a "model" rank, no data split
    assert qwen["layers.0.moe.w_gate"] == [[64, 2048, 1408],
                                           [32, 2048, 1408]]
    assert qwen["layers.0.shared.up"] == [[2048, 5632], [2048, 2816]]
    assert qwen["layers.0.norm1"] == [[2048], [2048]]
