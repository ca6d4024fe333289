"""The dense LM on sharded parameters (tensor parallel over
``torch.distributed`` ranks) against the one-process port and the JAX
package, on the CPU.

The reference's reduced qwen3-8b (float32) is built once; its parameters
reach every process through ``params_from_jax``.  Gloo ranks
(``spawn_ranks``; the bodies are ``tests/torch_ranks.py``, which imports
no JAX) place them on a ``("data", "model")`` mesh by the reference's
``param_shardings`` (``Model.place``) and run, inside ``use_mesh``:

* the forward, a prefill and three decode steps (teacher-forced), with
  ``quantize_dense`` off and on, on a (1, 2) and a (2, 2) mesh: logits
  against the one-process port within ``TP_ATOL`` (float32 in other
  summation orders: the row-parallel products are summed across ranks)
  and against the reference within ``LOGIT_ATOL`` / ``QUANT_LOGIT_ATOL``
  (``tests/test_torch_lm.py``'s); the quantized linears' int8
  activations and int32 ``int_matmul`` products bit-identical to the
  one-process run's;
* two AdamW steps (ZeRO-1 moments): losses within ``LOSS_ATOL`` and
  grad norms within ``GNORM_RTOL`` of the one-process steps';
* the elastic rescale, as the reference's
  ``test_elastic_rescale_subprocess``: a step on a 4 x 2 mesh, saved;
  ``plan_rescale(4, 2)`` picks 2 x 2; the checkpoint restored onto it
  equals the saved params bit for bit, and one more step is finite.

Then, without ranks: the shape helpers the dry-run needs
(``Model.param_shapes``, ``input_specs``, ``count_params``,
``AdamW.init_shapes``) against the reference's, and the VLM's and
whisper's parameter layouts.
"""
import concurrent.futures
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.shapes import shape_for as jshape_for
from repro.models import api as japi
from repro.models import transformer as jtransformer
from repro.optim.adam import AdamW as JAdamW
from repro.train.fault_tolerance import plan_rescale as jplan_rescale

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, shape_for
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import transformer as ttransformer
from repro_torch.models.api import Model, input_specs, params_from_jax
from repro_torch.optim.adam import AdamW
from repro_torch.train.fault_tolerance import plan_rescale

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ranks  # noqa: E402

ARCH = "qwen3-8b"
#: sharded against one process: float32 in other summation orders
#: (observed <= 7e-6 on logits of |x| <= ~5)
TP_ATOL = 5e-5
#: against the reference: tests/test_torch_lm.py's tolerances
LOGIT_ATOL, QUANT_LOGIT_ATOL = 1e-4, 0.3
#: two train steps against one process (observed <= 1e-6 and 1e-6 rel.)
LOSS_ATOL, GNORM_RTOL = 1e-5, 1e-5
B, S, PROMPT, MAX_SEQ = 2, 16, 13, 24
TRAIN_B, STEPS, LR = 4, 2, 1e-3


@pytest.fixture(scope="module")
def ref():
    """The reference's reduced model, its parameters as numpy, the inputs
    and the reference's serving logits."""
    jm = japi.Model(jget_config(ARCH).reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.RandomState(3)
    toks = rng.randint(0, 512, (B, S)).astype(np.int32)
    batch = {k: rng.randint(0, 512, (TRAIN_B, S)).astype(np.int32)
             for k in ("tokens", "targets")}
    out = {}
    for quant in (False, True):
        m = japi.Model(jget_config(ARCH).reduced(quantize_dense=quant))
        o = {"forward": np.asarray(m.forward(jp, {"tokens": toks}))}
        logits, cache = m.prefill(jp, {"tokens": jnp.asarray(
            toks[:, :PROMPT])}, max_seq=MAX_SEQ)
        o["prefill"] = np.asarray(logits)
        for i in range(PROMPT, S):
            logits, cache = m.decode_step(jp, jnp.asarray(toks[:, i:i + 1]),
                                          cache)
            o[f"decode{i - PROMPT}"] = np.asarray(logits)
        out[quant] = o
    return {"tree": tree, "toks": toks, "batch": batch, "logits": out}


@pytest.fixture(scope="module")
def single(ref):
    """The one-process port on the same weights and inputs."""
    out = {}
    for quant in (False, True):
        cfg = get_config(ARCH).reduced(quantize_dense=quant)
        model = Model(cfg, "cpu")
        out[quant] = torch_ranks.lm_serve_outputs(
            model, params_from_jax(cfg, ref["tree"], "cpu"), ref["toks"],
            PROMPT, MAX_SEQ)
    cfg = get_config(ARCH).reduced()
    model = Model(cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    out["train"] = torch_ranks.lm_train_outputs(
        model, params_from_jax(cfg, ref["tree"], "cpu"), batch, STEPS, LR)
    return out


def _args(ref, shape, steps=STEPS):
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    return dict(args=(ARCH, ref["tree"], shape, ref["toks"], PROMPT, MAX_SEQ,
                      batch, steps, LR))


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    """Rank 0's results on (1, 2); on 4 x 2 (one step, saved); on 2 x 2
    (serving, two steps, then the 4 x 2 checkpoint restored)."""
    ckpt = str(tmp_path_factory.mktemp("elastic"))
    out = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:   # beside 4 x 2
        pair = pool.submit(spawn_ranks, torch_ranks.tp_body, 2,
                           device="cpu", **_args(ref, (1, 2)))
        out[(4, 2)] = spawn_ranks(
            torch_ranks.tp_body, 8, device="cpu",
            args=_args(ref, (4, 2), steps=1)["args"] + (False, ckpt))
        out[(1, 2)] = pair.result()
    out[(2, 2)] = spawn_ranks(
        torch_ranks.tp_body, 4, device="cpu",
        args=_args(ref, (2, 2))["args"] + (True, None, ckpt))
    return out


MESHES = [(1, 2), (2, 2)]
LOGITS = ["forward", "prefill", "decode0", "decode1", "decode2"]


def test_ranks_import_no_jax_and_shard_the_weights(runs):
    for shape, ranks in runs.items():
        assert not any(r["jax"] for r in ranks), shape
    # reduced qwen3-8b's up is [128, 256]: columns over "model" = 2
    assert runs[(1, 2)][0]["up_local"] == (128, 128)
    assert runs[(2, 2)][0]["up_local"] == (128, 128)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("shape", MESHES)
def test_serving_matches_one_process_and_the_reference(runs, single, ref,
                                                       shape, quant):
    got = runs[shape][0][f"serve/{quant}"]
    atol = QUANT_LOGIT_ATOL if quant else LOGIT_ATOL
    for name in LOGITS:
        np.testing.assert_allclose(got[name], single[quant][name],
                                   atol=TP_ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(got[name], ref["logits"][quant][name],
                                   atol=atol, rtol=0, err_msg=name)
    # every rank holds the same whole logits
    for r in runs[shape][1:]:
        np.testing.assert_array_equal(r[f"serve/{quant}"]["decode2"],
                                      got["decode2"])


@pytest.mark.parametrize("shape", MESHES)
def test_quantized_linears_are_bit_identical(runs, single, shape):
    got = runs[shape][0]["serve/True"]["quant"]
    want = single[True]["quant"]
    assert len(got) == len(want) == 6
    for (xq, acc), (wxq, wacc) in zip(got, want):
        assert xq.dtype == np.int8 and acc.dtype == np.int32
        np.testing.assert_array_equal(xq, wxq)
        np.testing.assert_array_equal(acc, wacc)


@pytest.mark.parametrize("shape", MESHES)
def test_train_steps_match_one_process(runs, single, shape):
    got, want = runs[shape][0]["train"], single["train"]
    np.testing.assert_allclose(got["loss"], want["loss"], atol=LOSS_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=GNORM_RTOL)
    assert got["loss"][1] < got["loss"][0]
    # ZeRO-1: the moments split over "data" besides the weight's split
    if shape == (2, 2):
        assert got["m_placements"][0].startswith("S(")


def test_elastic_rescale_restores_bit_for_bit(runs):
    assert plan_rescale(4, 2) == jplan_rescale(4, 2) == (2, 2)
    saved = runs[(4, 2)][0]["saved"]
    for r in runs[(2, 2)]:
        assert r["restored"].keys() == saved.keys()
        for name, value in saved.items():
            np.testing.assert_array_equal(r["restored"][name], value,
                                          err_msg=name)
        assert np.isfinite(r["after_restore"]["loss"][0])


# -- the dry-run's shape helpers, without ranks --------------------------------

@pytest.mark.parametrize("arch", ["qwen3-8b", "whisper-tiny"])
def test_param_shapes_match_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    mine = Model(cfg, "cpu").param_shapes()
    theirs = jax.tree_util.tree_leaves(japi.Model(jcfg).param_shapes())
    assert sum(t.numel() for t in mine.values()) == sum(
        int(np.prod(x.shape)) for x in theirs)
    assert all(t.device.type == "meta" for t in mine.values())
    assert ttransformer.count_params(cfg) == jtransformer.count_params(jcfg)
    state = AdamW().init_shapes(mine)
    assert state.m.keys() == mine.keys()
    assert all(v.dtype == torch.float32 for v in state.v.values())
    jstate = JAdamW().init_shapes(japi.Model(jcfg).param_shapes())
    assert sum(v.numel() for v in state.m.values()) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jstate.m))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_input_specs_match_the_reference(shape):
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    mine = input_specs(cfg, shape_for(cfg, shape))
    theirs = japi.input_specs(jcfg, jshape_for(jcfg, shape))
    assert mine.keys() == theirs.keys()
    assert tuple(mine["tokens"].shape) == theirs["tokens"].shape
    if "cache" in mine:
        kv, jkv = mine["cache"][0]["kv"], theirs["cache"][0]["kv"]
        assert len(mine["cache"]) == cfg.n_layers
        assert tuple(kv.k.shape) == jkv.k.shape[1:]
        assert kv.k.device.type == "meta"


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if get_config(a).family
                                  not in ("dense", "moe", "ssm", "hybrid")])
def test_families_beyond_dense_refuse_sharded_parameters(arch):
    """The families beyond the decoder LMs' (the VLM's gated cross blocks,
    whisper's encoder-decoder) lay their parameters out over "model" as
    the decoder LM's attention and MLP; their norms, gates and LayerNorm
    weights and biases replicated (``tests/test_torch_vlm_audio_tp.py``
    runs them)."""
    from types import SimpleNamespace
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 2))
    model = Model(get_config(arch).reduced(), "cpu")
    specs = model.param_specs(mesh, model.param_shapes())
    assert specs.keys() == model.param_shapes().keys()
    assert specs["tok_emb"] == ("model", None)
    block = "layers.4.cross" if arch == "llama-3.2-vision-11b" \
        else "dec.0.cross"
    for name in ("wq", "wk", "wv"):
        assert specs[f"{block}.{name}"] == (None, "model"), name
    assert specs[f"{block}.wo"] == ("model", None)
    for name, spec in specs.items():
        if name.split(".")[-1] in ("gate_attn", "gate_mlp", "norm1",
                                   "norm2", "w", "b"):
            assert spec == (), name
