"""The LM serving path of the port against the JAX package.

Both packages run on the same numpy-seeded inputs, and the port takes the
reference's parameters through ``params_from_jax``:

* configs: ``ArchConfig.reduced()`` and ``plan_heads`` equal the
  reference's for the four dense configs;
* numerics, bit for bit: ``symmetric_quantize`` (per tensor and per
  channel, float32 and bf16), ``quantize_weight``, ``quantize_kv``, the
  plain ``int_matmul`` against the reference's kernel (interpret mode)
  and ``int_matmul_ref``, and ``quant_dense`` in float32;
* the plain ``mha`` against the reference's ``mha`` (Pallas kernel in
  interpret mode, and ``_mha_ref``) at ``ATTN_ATOL``, the tolerance
  ``tests/test_kernels.py`` uses;
* whole models (qwen3-8b, granite-3-8b, qwen2.5-32b with ``qkv_bias``,
  stablelm-12b with partial rotary), reduced to float32: forward, prefill
  logits and caches, and decode logits (from the reference's own cache),
  with ``quantize_dense`` off and on and 16- and 8-bit KV caches;
  ``ServeEngine``'s greedy tokens; the port's prefill-then-decode against
  its own forward.

Tolerances.  With ``quantize_dense`` off the two packages differ only in
float32 summation order: logits within ``LOGIT_ATOL``.  With it on (and
for 8-bit KV caches) each activation is rounded to int8, and where the
two summation orders leave an activation within float error of a
rounding tie the packages round it to neighbouring int8 values.  One such
step on one activation moved a logit by up to 0.145 in these reduced
models (flipping one step by hand in the port; the norm over the
0.02-scale embeddings amplifies it), so those paths are held to
``QUANT_LOGIT_ATOL``, two such steps; their integer pieces are held
exact above.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import quantization as jquant
from repro.kernels.flash_attention.ops import _mha_ref
from repro.kernels.flash_attention.ops import mha as jmha
from repro.kernels.quant_matmul.kernel import int_matmul as jint_matmul
from repro.kernels.quant_matmul.ops import quant_dense as jquant_dense
from repro.kernels.quant_matmul.ref import int_matmul_ref
from repro.models import attention as jattn
from repro.models import quantized as jqz
from repro.models.api import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs.base import get_config
from repro_torch.core import quantization as tquant
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import mha, mha_plain
from repro_torch.kernels.quant_matmul import (int_matmul_plain, quant_dense,
                                              quant_matmul_plain)
from repro_torch.models import attention as tattn
from repro_torch.models import quantized as tqz
from repro_torch.models.api import Model, params_from_jax
from repro_torch.models.attention import KVCache
from repro_torch.launch import serve as tserve
from repro_torch.sched import manifest as tmanifest
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import loop as tloop

DENSE = ("qwen3-8b", "granite-3-8b", "qwen2.5-32b", "stablelm-12b")
#: float32 attention: the tolerance tests/test_kernels.py holds the
#: reference's kernel to
ATTN_ATOL = 2e-6
#: float32 logits (|logit| <= ~5) in two summation orders; observed <= 7e-6
LOGIT_ATOL = 1e-4
#: logits when int8 rounding can differ by one step (module docstring)
QUANT_LOGIT_ATOL = 0.3
B, S, MAX_SEQ = 2, 24, 32


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


# -- configs --------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_configs_match_the_reference(arch):
    for jc, tc in ((jget_config(arch), get_config(arch)),
                   (jget_config(arch).reduced(), get_config(arch).reduced()),
                   (jget_config(arch).reduced(quantize_dense=True,
                                              kv_cache_bits=8),
                    get_config(arch).reduced(quantize_dense=True,
                                             kv_cache_bits=8))):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert tc.padded_vocab == jc.padded_vocab
        assert tc.layer_pattern() == jc.layer_pattern()
        assert tc.layer_windows() == jc.layer_windows()


@pytest.mark.parametrize("n_q,n_kv,tp", [(32, 8, 16), (40, 8, 16),
                                         (4, 2, 16), (25, 5, 16), (6, 6, 16),
                                         (32, 8, 1), (5, 1, 4)])
def test_plan_heads_matches_the_reference(n_q, n_kv, tp):
    assert tuple(tattn.plan_heads(n_q, n_kv, tp)) == tuple(
        jattn.plan_heads(n_q, n_kv, tp))


def test_what_is_not_ported_raises():
    """The VLM and audio ids load and build a Model; the serve launcher
    refuses them (ServeEngine prefills tokens alone); the data-parallel
    trainer builds (tests/test_torch_dp_train.py runs it); ``backend:
    shard_map`` raises outside a process group (inside one it builds the
    PIM system over ranks: tests/test_torch_pim_ranks.py)."""
    for arch in ("llama-3.2-vision-11b", "whisper-tiny"):
        cfg = get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jget_config(arch))
        assert Model(cfg.reduced(), device="cpu").cfg == cfg.reduced()
        with pytest.raises(SystemExit):
            tserve.main(["--arch", arch, "--device", "cpu"])
    mesh = SimpleNamespace(mesh_dim_names=("data",), shape=(1,))
    assert callable(tloop.make_dp_train_step(None, None, mesh))
    with pytest.raises(ValueError, match="process group"):
        tmanifest.build_system({"backend": "shard_map"}, device="cpu")


# -- quantization -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [None, 0, 1, -1])
def test_symmetric_quantize_is_bit_identical(dtype, axis):
    x = np.random.RandomState(3).normal(0, 2, (64, 48)).astype(np.float32)
    x[5, 7] = 0.0
    jx = jnp.asarray(x, dtype)
    tx = _bf16(x) if dtype == "bfloat16" else _t(x)
    jq, jp = jquant.symmetric_quantize(jx, bits=8, axis=axis)
    tq, tp = tquant.symmetric_quantize(tx, bits=8, axis=axis)
    assert tq.dtype == torch.int8 and tp.scale.dtype == tx.dtype
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tp.scale.float().numpy(),
                                  np.asarray(jp.scale, np.float32))
    assert tp.axis == jp.axis and tp.qmax == jp.qmax
    np.testing.assert_array_equal(
        tquant.quantize_with(tx, tp).numpy(),
        np.asarray(jquant.quantize_with(jx, jp)))
    np.testing.assert_array_equal(
        tquant.dequantize(tq, tp).numpy(),
        np.asarray(jquant.dequantize(jq, jp)))


def test_quantize_weight_and_kv_are_bit_identical():
    rng = np.random.RandomState(4)
    w = rng.normal(0, 0.05, (96, 80)).astype(np.float32)
    w[:, 3] = 0.0                          # an all-zero column: eps scale
    jw, tw = jqz.quantize_weight(jnp.asarray(w)), tqz.quantize_weight(_t(w))
    assert tqz.is_quantized(tw) and not tqz.is_quantized(_t(w))
    np.testing.assert_array_equal(tw["q"].numpy(), np.asarray(jw["q"]))
    np.testing.assert_array_equal(tw["scale"].numpy(),
                                  np.asarray(jw["scale"]))
    kv = rng.normal(0, 1, (2, 4, 16, 32)).astype(np.float32)
    for jx, tx in ((jnp.asarray(kv), _t(kv)),
                   (jnp.asarray(kv, jnp.bfloat16), _bf16(kv))):
        jq, js = jattn.quantize_kv(jx)
        tq, ts = tattn.quantize_kv(tx)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            tattn.dequantize_kv(tq, ts, torch.float32).numpy(),
            np.asarray(jattn.dequantize_kv(jq, js, jnp.float32)))


# -- int8 matmul -------------------------------------------------------------

def _int8(rng, shape):
    return rng.randint(-128, 128, shape).astype(np.int8)   # includes -128


@pytest.mark.parametrize("m,k,n,bm,bk,bn", [
    (128, 128, 128, 128, 128, 128), (64, 64, 64, 32, 16, 64),
    (8, 256, 8, 8, 64, 8), (1, 128, 256, 1, 128, 128)])
def test_int_matmul_plain_equals_the_reference_kernel(m, k, n, bm, bk, bn):
    rng = np.random.RandomState(m + k + n)
    a, b = _int8(rng, (m, k)), _int8(rng, (k, n))
    a[0, :] = -128
    b[:, 0] = -128                        # the extreme product, K times
    out = int_matmul_plain(_t(a), _t(b))
    assert out.dtype == torch.int32
    kern = jint_matmul(jnp.asarray(a), jnp.asarray(b), bm=bm, bk=bk, bn=bn,
                       interpret=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(kern))
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(int_matmul_ref(jnp.asarray(a),
                                               jnp.asarray(b))))
    assert torch.equal(dispatch.launch("int_matmul", _t(a), _t(b)), out)


@pytest.mark.parametrize("m,k,n", [(1, 4099, 13), (7, 33, 5), (513, 70, 3),
                                   (3, 1, 1)])
def test_int_matmul_plain_on_ragged_shapes(m, k, n):
    rng = np.random.RandomState(k)
    a, b = _int8(rng, (m, k)), _int8(rng, (k, n))
    np.testing.assert_array_equal(
        int_matmul_plain(_t(a), _t(b)).numpy(),
        np.asarray(int_matmul_ref(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("scale", ["scalar", "per_channel"])
def test_quant_matmul_plain_matches_the_reference(scale):
    rng = np.random.RandomState(0)
    a, b = _int8(rng, (64, 128)), _int8(rng, (128, 64))
    sa = np.float32(0.01)
    sb = (np.float32(0.02) if scale == "scalar"
          else rng.uniform(0.01, 0.05, (1, 64)).astype(np.float32))
    from repro.kernels.quant_matmul.ref import quant_matmul_ref
    ref = quant_matmul_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(sa),
                           jnp.asarray(sb))
    out = quant_matmul_plain(_t(a), _t(b), _t(sa), _t(sb))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape", [(32, 256), (2, 5, 256)])
def test_quant_dense_is_bit_identical_in_float32(shape):
    rng = np.random.RandomState(1)
    x = rng.normal(0, 1, shape).astype(np.float32)
    w = rng.normal(0, 0.05, (256, 128)).astype(np.float32)
    wq, wp = jquant.symmetric_quantize(jnp.asarray(w), bits=8, axis=1)
    ref = jquant_dense(jnp.asarray(x), wq, wp.scale, use_pallas=True,
                       interpret=True)
    out = quant_dense(_t(x), _t(wq), _t(wp.scale))
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        tqz.pim_dense(_t(x), _t(w)).numpy(),
        np.asarray(jqz.pim_dense(jnp.asarray(x), jnp.asarray(w))))


# -- attention ------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(hq=4, hkv=4, sq=128, skv=128, d=64, causal=True),
    dict(hq=4, hkv=4, sq=128, skv=128, d=64, causal=False),
    dict(hq=8, hkv=2, sq=128, skv=128, d=32, causal=True),      # GQA
    dict(hq=8, hkv=2, sq=128, skv=128, d=32, causal=False),
    dict(hq=4, hkv=2, sq=1, skv=256, d=32, causal=True,
         q_offset=255, bq=1),                                   # decode
    dict(hq=4, hkv=4, sq=128, skv=128, d=32, causal=True, window=64),
    dict(hq=2, hkv=2, sq=1, skv=256, d=32, causal=True, q_offset=255,
         window=64, bq=1),                                      # both
])
def test_mha_plain_matches_the_reference(case):
    case = dict(case)
    hq, hkv, sq, skv, d = (case.pop(n) for n in ("hq", "hkv", "sq", "skv",
                                                 "d"))
    bq = case.pop("bq", 64)
    rng = np.random.RandomState(hq * sq + skv + d)
    q = rng.normal(0, 1, (2, hq, sq, d)).astype(np.float32)
    k = rng.normal(0, 1, (2, hkv, skv, d)).astype(np.float32)
    v = rng.normal(0, 1, (2, hkv, skv, d)).astype(np.float32)
    out = mha_plain(_t(q), _t(k), _t(v), **case)
    assert torch.equal(mha(_t(q), _t(k), _t(v), **case), out)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    kern = jmha(*jargs, use_pallas=True, interpret=True, bq=bq, bk=64, **case)
    np.testing.assert_allclose(out.numpy(), np.asarray(kern), atol=ATTN_ATOL,
                               rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(_mha_ref(*jargs,
                                                                **case)),
                               atol=ATTN_ATOL, rtol=0)


def test_mha_plain_reads_transposed_views():
    """_project_qkv hands the op [B, S, H, D] projections transposed."""
    rng = np.random.RandomState(2)
    q = _t(rng.normal(0, 1, (2, 40, 8, 32)).astype(np.float32))
    k = _t(rng.normal(0, 1, (2, 40, 2, 32)).astype(np.float32))
    out = mha_plain(q.transpose(1, 2), k.transpose(1, 2), k.transpose(1, 2))
    ref = mha_plain(q.transpose(1, 2).contiguous(),
                    k.transpose(1, 2).contiguous(),
                    k.transpose(1, 2).contiguous())
    assert torch.equal(out, ref)


# -- whole models ---------------------------------------------------------------

def _models(arch, **overrides):
    jc = jget_config(arch).reduced(**overrides)
    tc = get_config(arch).reduced(**overrides)
    jm = JModel(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tm = Model(tc, device="cpu")
    return jm, jp, tm, params_from_jax(tc, tree, device="cpu")


def _cache_from_jax(jcache) -> list:
    """The reference's stacked cache ([reps, ...] per unit slot) as the
    port's per-layer list (dense: one slot)."""
    kv = jcache[0]["kv"]
    out = []
    for r in range(kv.k.shape[0]):
        scales = ((_t(kv.k_scale[r]), _t(kv.v_scale[r]))
                  if kv.k_scale is not None else (None, None))
        out.append({"kv": KVCache(_t(kv.k[r]), _t(kv.v[r]),
                                  int(kv.length[r]), *scales)})
    return out


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_model_matches_the_reference(arch, quantize, bits):
    jm, jp, tm, tp = _models(arch, quantize_dense=quantize,
                             kv_cache_bits=bits)
    toks = np.random.RandomState(1).randint(
        0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    atol = QUANT_LOGIT_ATOL if quantize else LOGIT_ATOL
    kv_atol = QUANT_LOGIT_ATOL if (quantize or bits == 8) else LOGIT_ATOL

    full = tm.forward(tp, {"tokens": toks})
    assert full.shape == (B, S, tm.cfg.padded_vocab)
    if bits == 16:              # the forward does not read the cache
        np.testing.assert_allclose(
            full.numpy(), np.asarray(jm.forward(jp, {"tokens": toks})),
            atol=atol, rtol=0)

    pre = {"tokens": toks[:, :-1]}
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(pre["tokens"])},
                            max_seq=MAX_SEQ)
    tl, tcache = tm.prefill(tp, pre, max_seq=MAX_SEQ)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=atol, rtol=0)
    ref = _cache_from_jax(jcache)
    assert len(tcache) == len(ref) == tm.cfg.n_layers
    for c, r in zip(tcache, ref):
        c, r = c["kv"], r["kv"]
        assert c.length == r.length == S - 1
        assert c.k.shape == r.k.shape and c.k.dtype == r.k.dtype
        if bits == 8:          # int8 values: at most one step apart
            for x, y in ((c.k, r.k), (c.v, r.v)):
                assert int((x.int() - y.int()).abs().max()) <= 1
            for x, y in ((c.k_scale, r.k_scale), (c.v_scale, r.v_scale)):
                np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5)
        else:
            for x, y in ((c.k, r.k), (c.v, r.v)):
                np.testing.assert_allclose(x.numpy(), y.numpy(),
                                           atol=LOGIT_ATOL, rtol=0)

    # one decode step from the reference's own cache in both packages
    jd, jnew = jm.decode_step(jp, jnp.asarray(toks[:, -1:]), jcache)
    td, tnew = tm.decode_step(tp, toks[:, -1:], _cache_from_jax(jcache))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=kv_atol,
                               rtol=0)
    assert [c["kv"].length for c in tnew] == [S] * tm.cfg.n_layers
    np.testing.assert_allclose(td[:, 0].numpy(), full[:, -1].numpy(),
                               atol=kv_atol, rtol=0)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_serve_engine_matches_the_reference(arch, quantize):
    """3 requests over 2 slots, greedy: the same tokens (a second wave
    refills a slot)."""
    jm, jp, tm, tp = _models(arch, quantize_dense=quantize)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, tm.cfg.vocab_size, n).astype(np.int32)
               for n in (9, 14, 6)]
    news = (6, 4, 5)
    jreqs = [JRequest(prompt=p, max_new_tokens=n)
             for p, n in zip(prompts, news)]
    treqs = [Request(prompt=p, max_new_tokens=n)
             for p, n in zip(prompts, news)]
    JServeEngine(jm, jp, n_slots=2, max_seq=MAX_SEQ).run(jreqs)
    ServeEngine(tm, tp, n_slots=2, max_seq=MAX_SEQ).run(treqs)
    for j, t, n in zip(jreqs, treqs, news):
        assert len(t.output) == n and t.done
        if not quantize:
            assert t.output == j.output
    if quantize:   # an int8 rounding tie may flip a late pick: most agree
        agree = sum(a == b for j, t in zip(jreqs, treqs)
                    for a, b in zip(j.output, t.output))
        assert agree >= 0.8 * sum(news)


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_matches_forward(arch, quantize, bits):
    """The reference's property (tests/test_arch_smoke.py), on the port:
    one decode step after prefill gives the forward's last logits."""
    cfg = get_config(arch).reduced(quantize_dense=quantize,
                                   kv_cache_bits=bits)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    assert Model.param_count(params) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
            jax.eval_shape(lambda k: JModel(jget_config(arch).reduced(
                quantize_dense=quantize, kv_cache_bits=bits)).init(k),
                jax.random.PRNGKey(0))))
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size,
                                            (B, S)).astype(np.int32)
    _, cache = model.prefill(params, {"tokens": toks[:, :-1]},
                             max_seq=MAX_SEQ)
    dec, _ = model.decode_step(params, toks[:, -1:], cache)
    full = model.forward(params, {"tokens": toks})
    tol = (QUANT_LOGIT_ATOL if quantize or bits == 8 else 1e-3)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               atol=tol, rtol=tol)


def test_decode_writes_the_cache_in_place():
    cfg = get_config("qwen3-8b").reduced()
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(2))
    cache = model.init_cache(1, 8)
    assert [c["kv"].length for c in cache] == [0] * cfg.n_layers
    _, new = model.decode_step(params, np.array([[3]], np.int32), cache)
    assert new[0]["kv"].k is cache[0]["kv"].k and new[0]["kv"].length == 1
    assert cache[0]["kv"].k[:, :, 0].abs().sum() > 0
    full = tattn.init_kv_cache(1, tattn.plan_heads(4, 2), 32, 1,
                               torch.float32, device="cpu")
    with pytest.raises(ValueError, match="full"):
        tattn.attention_decode(params["layers"][0]["attn"],
                               tattn.AttnSpec(128, tattn.plan_heads(4, 2),
                                              32, qk_norm=True),
                               torch.zeros(1, 1, 128),
                               full._replace(length=1))


def test_serve_cli_runs_on_cpu():
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "3", "--slots", "2", "--max-new", "4"],
        env={"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin"},
        cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 3 requests, 12 tokens" in out.stdout
    assert "on cpu" in out.stdout
