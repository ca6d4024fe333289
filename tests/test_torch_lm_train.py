"""LM training in the port against the JAX package, on the CPU.

Both packages run on the same numpy-seeded inputs; the port takes the
reference's parameters (and gradients) through ``params_from_jax``:

* the activation LUTs (tables and lookups, bit for bit) and
  ``fake_quant_dense`` (forward and straight-through gradient);
* autograd of the plain ``mha`` against ``jax.grad`` of the reference's
  ``_mha_ref``, and the port's explicit backward against autograd;
* ``Model.loss`` and every gradient leaf against ``jax.value_and_grad``
  of the reference's, for reduced granite-3-8b and qwen3-8b: plain,
  ``quantize_dense`` and ``lut_activations`` (every ``gate`` gradient
  exactly 0 under the LUT); remat "full" against "none";
* ``AdamW``/``SGD`` updates and 3 steps of ``make_train_step``
  (microbatches 1 and 2) against the reference's jitted step;
  ``make_eval_step``;
* the token corpora (bit for bit), ``PrefetchLoader``, the recovery loop
  and ``plan_rescale``; the CLI on ``--device cpu`` and its resume, which
  retraces the uninterrupted run where the reference's restarts its corpus.

Tolerances.  Float32 in two summation orders: losses within
``LOSS_ATOL``, each gradient leaf within ``GRAD_RTOL`` of its norm
(observed <= 3e-6).  With ``quantize_dense`` or ``lut_activations`` an
activation can sit within float error of a rounding boundary (an int8
step, or the LUT's index step of 24/4095), where the two orders round it
to neighbouring values; one such step moved a logit by up to 0.145 in
these models (tests/test_torch_lm.py), so those paths are held to
``ROUNDED_LOSS_ATOL`` (two such steps over the 64 tokens of a batch) and
``ROUNDED_GRAD_RTOL`` (observed 3.6e-4 for granite's LUT ``down``).
"""
import ast
import dataclasses
import subprocess
import sys
import time
from types import SimpleNamespace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import lut as jlut
from repro.data.tokens import MarkovCorpus as JMarkovCorpus
from repro.data.tokens import UniformTokens as JUniformTokens
from repro.kernels.flash_attention.ops import _mha_ref
from repro.models import quantized as jqz
from repro.models.api import Model as JModel
from repro.optim import adam as jadam
from repro.train import fault_tolerance as jft
from repro.train import loop as jloop

from repro_torch.configs.base import get_config
from repro_torch.core import lut as tlut
from repro_torch.data.loader import PrefetchLoader
from repro_torch.data.tokens import MarkovCorpus, UniformTokens
from repro_torch.kernels.flash_attention import (mha, mha_bwd_plain,
                                                 mha_plain)
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import quantized as tqz
from repro_torch.models.api import Model, params_from_jax
from repro_torch.optim import adam as tadam
from repro_torch.train import fault_tolerance as tft
from repro_torch.sched import manifest as tmanifest
from repro_torch.train import loop as tloop

ROOT = Path(__file__).resolve().parents[1]
#: float32 losses and gradients in two summation orders (docstring)
LOSS_ATOL, GRAD_RTOL = 1e-5, 1e-4
#: paths that round activations (int8 or the LUT index; docstring)
ROUNDED_LOSS_ATOL, ROUNDED_GRAD_RTOL = 5e-3, 2e-2
#: float32 attention gradients, plain autograd against jax.grad
ATTN_GRAD_ATOL = 1e-5
#: the explicit backward against autograd of the same plain forward
BWD_ATOL = 1e-5
#: an optimizer step from equal gradients: the global norm sums in
#: another order (~1e-7 relative), the rest is the same float32 ops
OPT_RTOL, OPT_ATOL = 1e-6, 1e-6
#: 3 AdamW train steps: losses as LOSS_ATOL.  AdamW moves an element by
#: lr * m / (sqrt(v) + eps), about lr whatever the gradient's size, so an
#: element whose gradient is within float error of 0 moves differently in
#: the two packages (2 of 65,536 elements of a leaf by 1.6e-5 at lr 1e-3,
#: observed); each leaf's update is held to STEP_UPDATE_RTOL of its norm
STEP_UPDATE_RTOL = 1e-3
B, S = 2, 32


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _named(tc, tree) -> dict:
    """A reference tree (params or gradients) under the port's names."""
    return dict(params_from_jax(tc, jax.tree_util.tree_map(np.asarray, tree),
                                device="cpu").named_parameters())


def _models(arch, **overrides):
    jc = jget_config(arch).reduced(**overrides)
    tc = get_config(arch).reduced(**overrides)
    jm = JModel(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(tc, jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu").trainable_()
    return jm, jp, Model(tc, device="cpu"), tp, tc


def _jbatch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _grad_errors(got: dict, want: dict) -> dict:
    return {n: float((got[n] - want[n]).norm()
                     / max(float(want[n].norm()), 1e-30)) for n in want}


# -- the activation LUTs and fake quantization -------------------------------

@pytest.mark.parametrize("name", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activation_luts_are_bit_identical(name, dtype):
    jl = {"silu": jlut.silu_lut, "gelu": jlut.gelu_lut}[name]()
    tl = {"silu": tlut.silu_lut, "gelu": tlut.gelu_lut}[name]()
    np.testing.assert_array_equal(tl.table, np.asarray(jl.table))
    assert (tl.x_min, tl.x_max) == (jl.x_min, jl.x_max)
    x = np.concatenate([
        np.random.RandomState(0).normal(0, 4, 4000),
        np.linspace(-13, 13, 2001),               # the clip at both ends
        -12 + (np.arange(50) + 0.5) * 24 / 4095,  # index rounding ties
    ]).astype(np.float32)
    tx = _t(x) if dtype == "float32" else _t(x).to(torch.bfloat16)
    out = tl(tx)
    assert out.dtype == tx.dtype
    want = np.asarray(jl(jnp.asarray(x, dtype)), np.float32)
    np.testing.assert_array_equal(out.float().numpy(), want)


def test_lut_passes_no_gradient_to_its_input():
    x = torch.linspace(-3, 3, 11, requires_grad=True)
    y = tlut.silu_lut()(x) * x           # only the second factor has one
    (g,) = torch.autograd.grad(y.sum(), x)
    np.testing.assert_array_equal(g.numpy(), tlut.silu_lut()(x).numpy())


def test_fake_quant_dense_forward_and_straight_through_gradient():
    rng = np.random.RandomState(1)
    x = rng.normal(0, 1, (6, 40)).astype(np.float32)
    w = rng.normal(0, 0.2, (40, 24)).astype(np.float32)
    c = rng.normal(0, 1, (6, 24)).astype(np.float32)
    tw = _t(w).requires_grad_()
    out = tqz.fake_quant_dense(_t(x), tw)
    (tg,) = torch.autograd.grad((out * _t(c)).sum(), tw)
    jout = jqz.fake_quant_dense(jnp.asarray(x), jnp.asarray(w))
    jg = jax.grad(lambda ww: jnp.sum(jqz.fake_quant_dense(
        jnp.asarray(x), ww) * c))(jnp.asarray(w))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tg.numpy(), x.T @ c, atol=1e-5, rtol=0)  # STE


# -- attention's gradient --------------------------------------------------------

ATTN_CASES = [
    dict(hq=4, hkv=2, sq=40, skv=40, d=32, causal=True),
    dict(hq=4, hkv=2, sq=40, skv=40, d=80, causal=False),
    dict(hq=4, hkv=4, sq=40, skv=40, d=32, causal=True, window=9),
    dict(hq=4, hkv=4, sq=12, skv=50, d=80, causal=True, q_offset=38),
    dict(hq=4, hkv=2, sq=12, skv=50, d=32, causal=True, q_offset=38,
         window=20),
]


def _attn_inputs(case):
    case = dict(case)
    hq, hkv, sq, skv, d = (case.pop(n) for n in ("hq", "hkv", "sq", "skv",
                                                 "d"))
    rng = np.random.RandomState(hq * sq + skv + d)
    q, k, v = (rng.normal(0, 1, (2, h, s, d)).astype(np.float32)
               for h, s in ((hq, sq), (hkv, skv), (hkv, skv)))
    g = rng.normal(0, 1, (2, hq, sq, d)).astype(np.float32)
    return q, k, v, g, case


@pytest.mark.parametrize("case", ATTN_CASES)
def test_mha_plain_gradient_matches_jax_grad(case):
    q, k, v, g, kw = _attn_inputs(case)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = mha(tq, tk, tv, **kw)          # the CPU route: autograd
    got = torch.autograd.grad(out, (tq, tk, tv), _t(g))
    want = jax.grad(lambda a, b, c: jnp.sum(_mha_ref(a, b, c, **kw) * g),
                    argnums=(0, 1, 2))(q, k, v)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                   atol=ATTN_GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_mha_bwd_plain_matches_autograd(case):
    q, k, v, g, kw = _attn_inputs(case)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out, lse = mha_plain(tq, tk, tv, with_lse=True, **kw)
    want = torch.autograd.grad(out, (tq, tk, tv), _t(g))
    got = mha_bwd_plain(_t(q), _t(k), _t(v), out.detach(), _t(g),
                        lse.detach(), **kw)
    for x, y in zip(got, want):
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=BWD_ATOL,
                                   rtol=0)


# -- Model.loss and its gradients ------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen3-8b"])
@pytest.mark.parametrize("variant", ["plain", "quantize_dense",
                                     "lut_activations"])
def test_loss_and_every_gradient_match_the_reference(arch, variant):
    overrides = {} if variant == "plain" else {variant: True}
    jm, jp, tm, tp, tc = _models(arch, **overrides)
    batch = MarkovCorpus(tc.vocab_size, seed=0).batch(B, S)
    jl, jg = jax.value_and_grad(jm.loss)(jp, _jbatch(batch))
    tl, tg = tloop.value_and_grad(tm, tp, batch)
    loss_tol, grad_tol = ((LOSS_ATOL, GRAD_RTOL) if variant == "plain"
                          else (ROUNDED_LOSS_ATOL, ROUNDED_GRAD_RTOL))
    assert abs(float(tl) - float(jl)) <= loss_tol
    want = _named(tc, jg)
    assert set(tg) == set(want)
    errs = _grad_errors(tg, want)
    assert max(errs.values()) <= grad_tol, max(errs.items(),
                                               key=lambda kv: kv[1])
    for name, g in tg.items():
        if name.endswith(".gate") and variant == "lut_activations":
            assert not torch.any(g) and not np.any(want[name].numpy())
        else:
            assert torch.any(g), name


def test_remat_full_equals_none():
    losses, grads = [], []
    for remat in ("none", "full"):
        tc = get_config("qwen3-8b").reduced(remat=remat)
        tm = Model(tc, device="cpu")
        tp = tm.init(torch.Generator().manual_seed(0)).trainable_()
        loss, g = tloop.value_and_grad(
            tm, tp, MarkovCorpus(tc.vocab_size, seed=0).batch(B, S))
        losses.append(loss)
        grads.append(g)
    assert torch.equal(losses[0], losses[1])
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name


# -- the optimizers and the train step ------------------------------------------

@pytest.mark.parametrize("which", ["adamw", "sgd"])
def test_optimizer_updates_match_the_reference(which):
    """3 updates from the same gradients (drawn with numpy in the
    reference's tree): AdamW with the clip active and weight decay on,
    and SGD; params, moments and the global norm."""
    jm, jp, tm, tp, tc = _models("granite-3-8b")
    if which == "adamw":
        jopt = jadam.AdamW(lr=1e-2, weight_decay=0.1, grad_clip=0.5)
        topt = tadam.AdamW(lr=1e-2, weight_decay=0.1, grad_clip=0.5)
    else:
        jopt, topt = jadam.SGD(lr=0.1), tadam.SGD(lr=0.1)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    rng = np.random.RandomState(5)
    for _ in range(3):
        jg = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(0, 0.05, p.shape), p.dtype), jp)
        jp, jstate, jn = jopt.update(jg, jstate, jp)
        tp, tstate, tn = topt.update(_named(tc, jg), tstate, tp)
        np.testing.assert_allclose(float(tn), float(jn), rtol=OPT_RTOL)
    assert int(tstate.step) == int(jstate.step) == 3
    want = _named(tc, jp)
    for name, p in tp.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=OPT_RTOL, atol=OPT_ATOL, err_msg=name)
    if which == "adamw":
        assert float(jn) > 0.5                       # the clip was active
        for moments, jmom in ((tstate.m, jstate.m), (tstate.v, jstate.v)):
            want = _named(tc, jmom)
            for name, t in moments.items():
                assert t.dtype == torch.float32
                np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                           rtol=OPT_RTOL, atol=OPT_ATOL)


def test_clip_sums_squares_in_the_reference_leaf_order():
    names = ["tok_emb", "layers.10.attn.wq", "layers.2.attn.wq",
             "layers.2.mlp.down", "final_norm", "layers.2.attn.bk",
             "lm_head", "layers.2.norm1"]
    assert tadam.leaf_order(names) == [
        "final_norm", "lm_head", "tok_emb", "layers.2.attn.bk",
        "layers.2.attn.wq", "layers.10.attn.wq", "layers.2.mlp.down",
        "layers.2.norm1"]


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_the_reference(microbatches):
    jm, jp, tm, tp, tc = _models("granite-3-8b")
    jstep = jax.jit(jloop.make_train_step(jm, jadam.AdamW(lr=1e-3),
                                          microbatches=microbatches))
    topt = tadam.AdamW(lr=1e-3)
    tstep = tloop.make_train_step(tm, topt, microbatches=microbatches)
    jstate, tstate = jadam.AdamW(lr=1e-3).init(jp), topt.init(tp)
    before = {n: p.detach().clone() for n, p in tp.named_parameters()}
    corpus = MarkovCorpus(tc.vocab_size, seed=0)
    for _ in range(3):
        batch = corpus.batch(4, S)
        jp, jstate, jm_ = jstep(jp, jstate, _jbatch(batch))
        tp, tstate, tm_ = tstep(tp, tstate, batch)
        assert abs(float(tm_["loss"]) - float(jm_["loss"])) <= LOSS_ATOL
        np.testing.assert_allclose(float(tm_["grad_norm"]),
                                   float(jm_["grad_norm"]), rtol=GRAD_RTOL)
    want = _named(tc, jp)
    for name, p in tp.named_parameters():
        moved, want_moved = p.detach() - before[name], want[name] - before[name]
        err = float((moved - want_moved).norm() / want_moved.norm())
        assert err <= STEP_UPDATE_RTOL, (name, err)


def test_eval_step_matches_the_reference():
    jm, jp, tm, tp, tc = _models("qwen3-8b")
    batch = UniformTokens(tc.vocab_size, seed=2).batch(B, S)
    got = tloop.make_eval_step(tm)(tp, batch)
    assert got.dtype == torch.float32 and got.grad_fn is None
    want = jloop.make_eval_step(jm)(jp, _jbatch(batch))
    assert abs(float(got) - float(want)) <= LOSS_ATOL


def test_what_training_does_not_port_raises():
    """The trainer builds the VLM and audio ids (their Model included);
    the serve launcher refuses them; the data-parallel trainer builds
    (tests/test_torch_dp_train.py runs it); ``backend: shard_map``
    raises outside a process group (inside one it builds the PIM system
    over ranks: tests/test_torch_pim_ranks.py)."""
    mesh = SimpleNamespace(mesh_dim_names=("data",), shape=(1,))
    assert callable(tloop.make_dp_train_step(None, tadam.AdamW(), mesh))
    with pytest.raises(ValueError, match="process group"):
        tmanifest.build_system({"backend": "shard_map"}, device="cpu")
    for arch in ("llama-3.2-vision-11b", "whisper-tiny"):
        cfg, model, _, _ = tlaunch.build(arch, reduced=True, device="cpu")
        assert cfg == get_config(arch).reduced() and model.cfg == cfg
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jget_config(arch).reduced())
        with pytest.raises(SystemExit):
            tserve.main(["--arch", arch, "--device", "cpu"])


def test_value_and_grad_needs_trainable_params():
    tc = get_config("qwen3-8b").reduced()
    tm = Model(tc, device="cpu")
    tp = tm.init(torch.Generator().manual_seed(0))
    batch = MarkovCorpus(tc.vocab_size).batch(B, 8)
    with pytest.raises(ValueError, match="trainable_"):
        tloop.value_and_grad(tm, tp, batch)
    assert not any(p.requires_grad for p in tp.parameters())
    assert all(p.requires_grad for p in tp.trainable_().parameters())
    fresh = tm.init(torch.Generator().manual_seed(0))
    assert tm.forward(fresh, batch).grad_fn is None


# -- data ------------------------------------------------------------------------------

def test_token_corpora_are_bit_identical():
    tc, jc = MarkovCorpus(300, seed=3), JMarkovCorpus(300, seed=3)
    assert tc.entropy_bound() == jc.entropy_bound()
    tu, ju = UniformTokens(300, seed=4), JUniformTokens(300, seed=4)
    for _ in range(3):
        for t, j in ((tc.batch(4, 17), jc.batch(4, 17)),
                     (tu.batch(4, 17), ju.batch(4, 17))):
            for key in ("tokens", "targets"):
                assert t[key].dtype == np.int32
                np.testing.assert_array_equal(t[key], j[key])


def test_prefetch_loader_delivers_batches():
    corpus = UniformTokens(128, seed=0)
    loader = PrefetchLoader(lambda: corpus.batch(4, 16), device="cpu",
                            prefetch=2)
    try:
        seen = [next(loader) for _ in range(5)]
        for b in seen:
            assert isinstance(b["tokens"], torch.Tensor)
            assert b["tokens"].shape == (4, 16)
            assert b["tokens"].device.type == "cpu"
            assert int(b["tokens"].max()) < 128
        want = UniformTokens(128, seed=0)
        for b in seen:                   # in order, none dropped
            np.testing.assert_array_equal(b["tokens"].numpy(),
                                          want.batch(4, 16)["tokens"])
    finally:
        loader.close()


def test_prefetch_loader_overlaps_host_work():
    """The loader must hide a slow host source behind consumption."""
    def slow_source():
        time.sleep(0.05)
        return {"x": np.zeros(4, np.float32)}

    loader = PrefetchLoader(slow_source, prefetch=2)
    try:
        next(loader)          # warm
        time.sleep(0.12)      # let the worker stage ahead
        t0 = time.perf_counter()
        next(loader)
        dt = time.perf_counter() - t0
        assert dt < 0.04, dt  # served from the prefetch queue
    finally:
        loader.close()


# -- fault tolerance ------------------------------------------------------------------

@pytest.mark.parametrize("args", [(256, 16), (240, 16), (8, 16),
                                  (512, 16, True), (48, 16, True), (1, 1)])
def test_plan_rescale_matches_the_reference(args):
    assert tft.plan_rescale(*args) == jft.plan_rescale(*args)


@pytest.mark.parametrize("fail_at", [(5,), (1,), (5, 7, 7), ()])
def test_run_with_recovery_matches_the_reference(fail_at):
    """Faults injected at the first attempt of each listed step (a step
    twice in the list fails twice): the same final state and stats as
    the reference's loop, and a straggler monitor fed every good step."""
    def run(impl):
        attempts = {}

        def step_fn(state, step):
            attempts[step] = attempts.get(step, 0) + 1
            if attempts[step] <= fail_at.count(step):
                raise RuntimeError("injected failure")
            return state + 1
        saved = {}
        monitor = impl.StragglerMonitor()
        state, stats = impl.run_with_recovery(
            step_fn, lambda s, n: saved.__setitem__(n, s), saved.__getitem__,
            n_steps=10, ckpt_every=3, state=0, monitor=monitor)
        return state, dataclasses.astuple(stats), monitor.n
    got = run(tft)
    assert got == run(jft)
    # a fault before the first checkpoint restarts the count, not the state
    assert got[0] == (11 if fail_at == (1,) else 10)


def test_run_with_recovery_gives_up_after_max_failures():
    def step_fn(state, step):
        raise RuntimeError("always")
    with pytest.raises(RuntimeError, match="always"):
        tft.run_with_recovery(step_fn, None, None, n_steps=3, ckpt_every=1,
                              state=0, max_failures=2)


# -- the launcher ---------------------------------------------------------------------

def test_train_reduces_the_loss_on_cpu():
    _, losses, corpus = tlaunch.train("granite-3-8b", steps=12, batch=4,
                                      seq=32, lr=3e-3, log_every=100,
                                      device="cpu")
    assert len(losses) == 12 and np.all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_train_overrides_apply_to_the_full_config():
    cfg, model, _, _ = tlaunch.build("granite-3-8b", reduced=False,
                                     overrides={"n_layers": 2},
                                     quantize_dense=True, device="cpu")
    full = get_config("granite-3-8b")
    assert cfg == dataclasses.replace(full, n_layers=2, quantize_dense=True)
    assert cfg.d_model == 4096 and cfg.remat == "full"


def test_cli_runs_on_cpu_and_resume_reproduces_the_run(tmp_path):
    """The CLI trains 4 steps on --device cpu; a run stopped at step 2
    (its checkpoint) and resumed gives steps 3-4 the uninterrupted run's
    losses and final params, exactly."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--batch", "2", "--seq", "16", "--ckpt-every", "2",
           "--lr", "1e-3"]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}

    def run(steps, ckpt):
        out = subprocess.run(cmd + ["--steps", str(steps), "--ckpt-dir",
                                    str(tmp_path / ckpt)],
                             capture_output=True, text=True, env=env,
                             timeout=120, cwd=ROOT)
        assert out.returncode == 0, out.stderr
        return out.stdout

    def losses(text):
        last = text.strip().splitlines()[-1]
        return ast.literal_eval(last[last.index("losses ") + 7:])
    full = run(4, "a")
    assert "trained 4 steps" in full and "on cpu" in full
    run(2, "b")
    resumed = run(4, "b")
    assert "resumed from step 2" in resumed
    assert len(losses(full)) == 4
    assert losses(resumed) == losses(full)[2:]
    from repro_torch.train import checkpoint as ckpt
    a, _ = ckpt.restore_raw(str(tmp_path / "a"), 4)
    b, _ = ckpt.restore_raw(str(tmp_path / "b"), 4)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _fed_batches(module, monkeypatch, ckpt_dir, steps):
    """The token batches ``module.train`` hands its step function, with the
    step replaced by one that records its batch and changes nothing."""
    fed, build = [], module.build

    def recording_build(*args, **kwargs):
        cfg, model, opt, _ = build(*args, **kwargs)

        def step(params, opt_state, batch):
            fed.append(np.asarray(batch["tokens"]))
            return params, opt_state, {"loss": 0.0, "grad_norm": 0.0}
        return cfg, model, opt, step
    monkeypatch.setattr(module, "build", recording_build)
    kw = {"device": "cpu"} if module is tlaunch else {}
    module.train("granite-3-8b", steps=steps, batch=2, seq=16,
                 ckpt_dir=ckpt_dir, ckpt_every=2, **kw)
    return fed


def test_resume_feeds_the_uninterrupted_batches_where_the_reference_restarts(
        tmp_path, monkeypatch):
    """Both packages draw the same batches in an uninterrupted run.  Resumed
    from step 2, the port's steps 3-4 see batches 3-4, as the uninterrupted
    run does; the reference's see batches 1-2 again, because it restarts
    its corpus (a reference-side fault, ROADMAP queue 3)."""
    from repro.launch import train as jlaunch
    runs = {}
    for module in (tlaunch, jlaunch):
        ckpt = str(tmp_path / module.__name__)
        full = _fed_batches(module, monkeypatch, "", 4)
        _fed_batches(module, monkeypatch, ckpt, 2)
        runs[module] = full, _fed_batches(module, monkeypatch, ckpt, 4)
    (port_full, port_resumed), (ref_full, ref_resumed) = runs.values()
    np.testing.assert_array_equal(np.stack(port_full), np.stack(ref_full))
    np.testing.assert_array_equal(np.stack(port_resumed),
                                  np.stack(port_full[2:]))
    np.testing.assert_array_equal(np.stack(ref_resumed),
                                  np.stack(ref_full[:2]))
    assert not np.array_equal(ref_resumed[0], ref_full[2])


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_costs_count_the_kept_pairs(case):
    """mha and mha_bwd declare 2 and 5 products of 2 D operations a kept
    (query, key) pair, the pairs counted in closed form as the mask keeps
    them; bytes: each input read once, each output written once."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import keep_mask, kept_pairs
    q, k, v, g, kw = _attn_inputs(case)
    tq, tk, tv, tg = (_t(a) for a in (q, k, v, g))
    sq, skv, d = q.shape[2], k.shape[2], q.shape[3]
    mask = keep_mask(sq, skv, kw.get("causal", True), kw.get("q_offset", 0),
                     kw.get("window", 0), "cpu")
    pairs = sq * skv if mask is None else int(mask.sum())
    assert kept_pairs(sq, skv, kw.get("causal", True), kw.get("q_offset", 0),
                      kw.get("window", 0)) == pairs
    out, lse = mha_plain(tq, tk, tv, with_lse=True, **kw)
    fwd = dispatch.declared_cost("mha", tq, tk, tv, **kw)
    bwd = dispatch.declared_cost("mha_bwd", tq, tk, tv, out, tg, lse, **kw)
    heads = q.shape[0] * q.shape[1]
    assert fwd.ops == 4 * d * pairs * heads and fwd.rate == "fp32"
    assert bwd.ops == 10 * d * pairs * heads and bwd.rate == "fp32"
    assert fwd.bytes == 4 * (2 * q.size + k.size + v.size)
    assert bwd.bytes == 4 * (3 * q.size + 2 * k.size + 2 * v.size
                             + out.numel() + lse.numel())
