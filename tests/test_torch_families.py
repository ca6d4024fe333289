"""The decoder-only LM families (MoE, xLSTM, Hymba) of the port against
the JAX package, on the CPU.

Both packages run on the same numpy-seeded inputs, and the port takes the
reference's parameters (and gradients) through ``params_from_jax``.  Per
arch, reduced to float32 (qwen2-moe-a2.7b, dbrx-132b with its 16 routing
groups, xlstm-350m's 7+1 unit, hymba-1.5b with 4 layers so that layer 1
slides its 32-token window over 8 meta tokens and a 40-token prompt):

* the configs, and the forward's logits and aux loss;
* ``Model.loss`` and every gradient leaf against ``jax.value_and_grad``;
* prefill's last logits and every filled cache: KV (meta tokens
  included), the SSM's and the xLSTM blocks' states (the port takes the
  mLSTM's state from the chunkwise scan's carry, the reference replays
  the recurrence: ``STATE_RTOL``);
* three decode steps from each package's own cache;
* ``ServeEngine``'s greedy tokens against the reference's engine; the
  train launcher on each family.

Then the pieces: ``moe_apply`` in both dispatch modes against the
reference's (capacity drops and group-local routing included) and gather
== dense; ``causal_conv1d`` and its step; the mLSTM chunkwise against the
reference and the recurrent form, and its ``s % 64`` refusal; the sLSTM;
the log-depth scan against a sequential recurrence; the selective SSM;
and windowed attention reaching the ``mha`` op.

Tolerances.  Float32 in two summation orders: logits within
``LOGIT_ATOL``, losses within ``LOSS_ATOL``, gradient
leaves within ``GRAD_RTOL`` of their norm, states within ``STATE_RTOL``
of theirs; the scan reorders products of numbers in (0, 1]
(``SCAN_RTOL``).
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.models.api import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine

from repro_torch.configs.base import get_config
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.api import Model, params_from_jax
from repro_torch.models.attention import KVCache
from repro_torch.models.transformer import (FULL_WINDOW, lm_forward,
                                            unit_pattern)
from repro_torch.sched import manifest as tmanifest
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import loop as tloop

#: each arch's reduced config: hymba with 4 layers (0, 2, 3 global, 1
#: windowed; two layers would be both global)
ARCHS = {"qwen2-moe-a2.7b": {}, "dbrx-132b": {}, "xlstm-350m": {},
         "hymba-1.5b": {"n_layers": 4}}
#: float32 in two summation orders (module docstring)
LOGIT_ATOL, LOSS_ATOL, GRAD_RTOL, STATE_RTOL = 1e-4, 1e-5, 1e-4, 1e-4
SCAN_RTOL = 1e-5
B, MAX_SEQ = 2, 64
#: prompt lengths: hymba's 40 + 8 meta tokens pass its 32-token window
SEQ = {"hymba-1.5b": 40}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _seq(arch: str) -> int:
    return SEQ.get(arch, 24)


@pytest.fixture(scope="module")
def ref():
    """Per arch, built once: the reference's model, params and results."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jc = jget_config(arch).reduced(**ARCHS[arch])
            tc = get_config(arch).reduced(**ARCHS[arch])
            jm = JModel(jc)
            jp = jm.init(jax.random.PRNGKey(0))
            tree = jax.tree_util.tree_map(np.asarray, jp)
            toks = np.random.RandomState(1).randint(
                0, tc.vocab_size, (B, _seq(arch) + 3)).astype(np.int32)
            cache[arch] = dict(jc=jc, tc=tc, jm=jm, jp=jp, tree=tree,
                               toks=toks)
        return cache[arch]
    return get


def _port(r) -> tuple:
    return (Model(r["tc"], device="cpu"),
            params_from_jax(r["tc"], r["tree"], device="cpu"))


# -- configs --------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
def test_configs_match_the_reference(arch):
    for jc, tc in ((jget_config(arch), get_config(arch)),
                   (jget_config(arch).reduced(**ARCHS[arch]),
                    get_config(arch).reduced(**ARCHS[arch]))):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert tc.layer_pattern() == jc.layer_pattern()
        assert tc.layer_windows() == jc.layer_windows()
        assert unit_pattern(tc) == jtransformer.unit_pattern(jc)


def test_hymbas_windows_and_heads():
    cfg = get_config("hymba-1.5b")
    wins = cfg.layer_windows()
    assert [i for i, w in enumerate(wins) if w == 0] == [0, 16, 31]
    assert wins.count(1024) == 29
    assert tuple(tattn.plan_heads(25, 5)) == (32, 16, 2, 25, 5)
    assert get_config("hymba-1.5b").reduced(n_layers=4).layer_windows() \
        == (0, 32, 0, 0)


# -- whole models ---------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_and_aux_match_the_reference(arch, ref):
    r = ref(arch)
    tm, tp = _port(r)
    toks = r["toks"][:, :_seq(arch)]
    jl, jaux = jax.jit(jtransformer.lm_forward, static_argnums=0)(
        r["jc"], r["jp"], jnp.asarray(toks))
    tl, taux = lm_forward(r["tc"], tp, torch.from_numpy(toks))
    assert tl.shape == (B, _seq(arch), r["tc"].padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    if r["tc"].family == "moe":
        assert isinstance(taux, torch.Tensor) and taux.dtype == torch.float32
        assert float(taux) > 0
    assert abs(float(taux) - float(jaux)) <= LOSS_ATOL
    assert Model.param_count(tp) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(r["tree"]))
    init = tm.init(torch.Generator().manual_seed(0))
    assert {n: tuple(p.shape) for n, p in init.named_parameters()} == {
        n: tuple(p.shape) for n, p in tp.named_parameters()}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_and_every_gradient_match_the_reference(arch, ref):
    r = ref(arch)
    tm, tp = _port(r)
    tp.trainable_()
    toks = r["toks"][:, :_seq(arch)]
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    jl, jg = jax.jit(jax.value_and_grad(r["jm"].loss))(
        r["jp"], {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tg = tloop.value_and_grad(tm, tp, batch)
    assert abs(float(tl) - float(jl)) <= LOSS_ATOL
    want = dict(params_from_jax(r["tc"], jax.tree_util.tree_map(
        np.asarray, jg), device="cpu").named_parameters())
    assert set(tg) == set(want)
    for name, w in want.items():
        err = float((tg[name] - w).norm() / max(float(w.norm()), 1e-30))
        assert err <= GRAD_RTOL, (name, err)


def _state_from_jax(value, r: int):
    """Rep ``r`` of one stacked reference cache entry, as the port's."""
    if isinstance(value, jattn.KVCache):
        scales = ((_t(value.k_scale[r]), _t(value.v_scale[r]))
                  if value.k_scale is not None else (None, None))
        return KVCache(_t(value.k[r]), _t(value.v[r]), int(value.length[r]),
                       *scales)
    cls = getattr(tssm, type(value).__name__)      # MlstmState, ...
    return cls(*(_t(f[r]) for f in value))


def _cache_from_jax(cfg, jcache) -> list:
    unit, reps = unit_pattern(cfg)
    return [{k: _state_from_jax(v, r) for k, v in jcache[u].items()}
            for r in range(reps) for u in range(len(unit))]


def _assert_caches_close(got: list, want: list):
    assert len(got) == len(want)
    for layer, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), layer
        for key in w:
            assert type(g[key]) is type(w[key]), (layer, key)
            if key == "kv":
                assert g[key].length == w[key].length
            for field, x, y in zip(w[key]._fields, g[key], w[key]):
                if not isinstance(y, torch.Tensor):
                    continue
                assert x.shape == y.shape and x.dtype == y.dtype, field
                scale = max(float(y.abs().max()), 1.0)
                err = float((x - y).abs().max())
                assert err <= STATE_RTOL * scale, (layer, key, field, err)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_caches_and_three_decode_steps_match(arch, ref):
    r = ref(arch)
    tm, tp = _port(r)
    s = _seq(arch)
    toks = r["toks"]
    jl, jcache = r["jm"].prefill(r["jp"], {"tokens": jnp.asarray(
        toks[:, :s])}, max_seq=MAX_SEQ)
    tl, tcache = tm.prefill(tp, {"tokens": toks[:, :s]}, max_seq=MAX_SEQ)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    _assert_caches_close(tcache, _cache_from_jax(r["tc"], jcache))
    jdecode = jax.jit(r["jm"].decode_step)
    for i in range(3):
        tok = toks[:, s + i:s + i + 1]
        jl, jcache = jdecode(r["jp"], jnp.asarray(tok), jcache)
        tl, tcache = tm.decode_step(tp, tok, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL, rtol=0)
    _assert_caches_close(tcache, _cache_from_jax(r["tc"], jcache))
    # the port's own property: decode after prefill == the forward
    full = tm.forward(tp, {"tokens": toks})
    np.testing.assert_allclose(tl[:, 0].numpy(), full[:, -1].numpy(),
                               atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_serve_engine_matches_the_reference(arch, ref):
    """3 requests over 2 slots, greedy: the same tokens (a second wave
    refills a slot)."""
    r = ref(arch)
    tm, tp = _port(r)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, r["tc"].vocab_size, n).astype(np.int32)
               for n in (9, 14, 6)]
    news = (5, 3, 4)
    jreqs = [JRequest(prompt=p, max_new_tokens=n)
             for p, n in zip(prompts, news)]
    treqs = [Request(prompt=p, max_new_tokens=n)
             for p, n in zip(prompts, news)]
    JServeEngine(r["jm"], r["jp"], n_slots=2, max_seq=MAX_SEQ).run(jreqs)
    ServeEngine(tm, tp, n_slots=2, max_seq=MAX_SEQ).run(treqs)
    for j, t, n in zip(jreqs, treqs, news):
        assert t.done and len(t.output) == n
        assert t.output == j.output


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_launcher_runs_each_family(arch):
    params, losses, _ = tlaunch.train(arch, steps=2, batch=2, seq=64,
                                      log_every=100, device="cpu")
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    cfg = get_config(arch).reduced()
    assert len(params["layers"]) == cfg.n_layers


def test_vlm_and_audio_still_raise():
    """What still raises around the VLM and audio families: they load and
    build a Model (tests/test_torch_vlm_audio.py holds them to the
    reference), but the serve launcher refuses them, since ServeEngine
    prefills tokens alone; the data-parallel trainer builds
    (tests/test_torch_dp_train.py runs it); ``backend: shard_map``
    builds the PIM system over ranks inside a process group only
    (tests/test_torch_pim_ranks.py runs it) and raises outside one."""
    for arch in ("llama-3.2-vision-11b", "whisper-tiny"):
        cfg = get_config(arch).reduced()
        params = Model(cfg, device="cpu").init(torch.Generator())
        assert Model.param_count(params) > 0
        with pytest.raises(SystemExit):
            tserve.main(["--arch", arch, "--device", "cpu"])
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data"), shape=(1, 1))
    assert callable(tloop.make_dp_train_step(None, None, mesh,
                                             compress=True))
    with pytest.raises(ValueError, match="process group"):
        tmanifest.build_system({"backend": "shard_map"}, device="cpu")


# -- MoE --------------------------------------------------------------------------

def _moe(spec, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), spec, jnp.float32)
    tp = {k: _t(np.asarray(v)) for k, v in jp.items()}
    return jp, tp


@pytest.mark.parametrize("dispatch,groups,tokens,capacity", [
    ("gather", 1, 32, 1.25), ("gather", 16, 32, 1.25),
    ("gather", 16, 30, 1.25), ("gather", 16, 32, 8.0),
    ("dense", 1, 32, 1.25), ("dense", 1, 32, 8.0)])
def test_moe_apply_matches_the_reference(dispatch, groups, tokens,
                                         capacity):
    """16 experts (15 real), top-4; capacity 1.25 drops tokens, and which
    ones depends on the slot order; 30 tokens do not split into 16 groups
    (one group); 8.0 is dropless.  Dense dispatch has no groups."""
    spec = jmoe.MoeSpec(d_model=32, n_experts=16, n_experts_real=15,
                        top_k=4, d_ff=24, capacity_factor=capacity,
                        dispatch=dispatch, groups=groups)
    tspec = tmoe.MoeSpec(**dataclasses.asdict(spec))
    jp, tp = _moe(spec)
    x = np.random.RandomState(tokens).normal(
        0, 1, (2, tokens // 2, 32)).astype(np.float32)
    jo, jaux = jax.jit(jmoe.moe_apply, static_argnums=1)(jp, spec,
                                                         jnp.asarray(x))
    to, taux = tmoe.moe_apply(tp, tspec, _t(x))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    assert abs(float(taux) - float(jaux)) <= 1e-6
    tj = jax.jit(jmoe._route, static_argnums=1)(
        jp, spec, jnp.asarray(x.reshape(-1, 32)))
    tt = tmoe._route(tp, tspec, _t(x.reshape(-1, 32)))
    for name, a, b in zip(("gates", "gidx", "pos"), tt[:3], tj[:3]):
        if name == "gates":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed", range(6))
def test_moe_gather_equals_dense(seed):
    """The reference's property (tests/test_property.py) on the port:
    gather and dense dispatch agree for dropless specs."""
    rng = np.random.RandomState(60 + seed)
    e, k, g = (int(rng.choice(c)) for c in ([4, 8], [1, 2], [1, 2, 4]))
    spec = tmoe.MoeSpec(d_model=32, n_experts=e, n_experts_real=e - 1,
                        top_k=k, d_ff=16, capacity_factor=float(4 * e),
                        dispatch="dense")
    gen = torch.Generator().manual_seed(seed)
    p = tmoe.init_moe(gen, spec, torch.float32)
    x = torch.randn((2, 8, 32), generator=gen)
    od, ad = tmoe.moe_apply(p, spec, x)
    og, ag = tmoe.moe_apply(p, dataclasses.replace(spec, dispatch="gather",
                                                   groups=g), x)
    np.testing.assert_allclose(od.numpy(), og.numpy(), atol=2e-5)
    if g == 1:
        assert abs(float(ad) - float(ag)) <= 1e-6


# -- the recurrent mixers -----------------------------------------------------

def test_causal_conv1d_and_its_step_match_the_reference():
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, (2, 11, 24)).astype(np.float32)
    w = rng.normal(0, 0.1, (4, 24)).astype(np.float32)
    out = tssm.causal_conv1d(_t(x), _t(w))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jssm.causal_conv1d(jnp.asarray(x),
                                                   jnp.asarray(w))),
        atol=1e-6, rtol=0)
    state = tssm.conv_state_init(2, 4, 24, torch.float32, "cpu")
    for i in range(11):
        step, state = tssm.causal_conv1d_step(_t(x[:, i:i + 1]), state,
                                              _t(w))
        np.testing.assert_allclose(step[:, 0].numpy(), out[:, i].numpy(),
                                   atol=1e-6, rtol=0)
    assert torch.equal(state, tssm.conv_state_of(_t(x), 4))
    assert torch.equal(tssm.conv_state_of(_t(x[:, :2]), 4)[:, 0],
                       torch.zeros(2, 24))


def _mixer_params(init, spec, seed=0):
    jp = init(jax.random.PRNGKey(seed), spec, jnp.float32)
    return jp, {k: _t(np.asarray(v)) for k, v in jp.items()}


@pytest.mark.parametrize("s", [24, 64, 128])
def test_mlstm_chunkwise_matches_the_reference_and_the_recurrence(s):
    jspec = jtransformer.mlstm_spec(jget_config("xlstm-350m").reduced())
    tspec = tssm.MlstmSpec(**dataclasses.asdict(jspec))
    jp, tp = _mixer_params(jssm.init_mlstm, jspec)
    x = np.random.RandomState(s).normal(0, 1, (2, s, 128)).astype(np.float32)
    out, st = tssm._mlstm_forward(tp, tspec, _t(x))
    jout, jst = jax.jit(jtransformer._mlstm_prefill, static_argnums=1)(
        jp, jget_config("xlstm-350m").reduced(), jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                               atol=LOGIT_ATOL, rtol=0)
    # the state: from the chunkwise carry here, the reference replays the
    # recurrence
    for field, a, b in zip(jst._fields, st, jst):
        b = _t(b)
        assert float((a - b).abs().max()) <= STATE_RTOL * max(
            float(b.abs().max()), 1.0), field
    # ... and against the port's own recurrent form, step by step
    rec = tssm.mlstm_state_init(2, tspec, torch.float32, "cpu")
    for i in range(s):
        h, rec = tssm.mlstm_decode_step(tp, tspec, _t(x[:, i:i + 1]), rec)
        np.testing.assert_allclose(h[:, 0].numpy(), out[:, i].numpy(),
                                   atol=LOGIT_ATOL, rtol=0)


def test_mlstm_refuses_what_the_reference_refuses():
    jspec = jtransformer.mlstm_spec(jget_config("xlstm-350m").reduced())
    tspec = tssm.MlstmSpec(**dataclasses.asdict(jspec))
    jp, tp = _mixer_params(jssm.init_mlstm, jspec)
    x = np.zeros((1, 96, 128), np.float32)
    with pytest.raises(AssertionError):
        jssm.mlstm_chunkwise(jp, jspec, jnp.asarray(x))
    with pytest.raises(ValueError, match="multiple of the chunk 64"):
        tssm.mlstm_chunkwise(tp, tspec, _t(x))


def test_slstm_matches_the_reference_and_its_decode():
    jspec = jtransformer.slstm_spec(jget_config("xlstm-350m").reduced())
    tspec = tssm.SlstmSpec(**dataclasses.asdict(jspec))
    jp, tp = _mixer_params(jssm.init_slstm, jspec)
    x = np.random.RandomState(3).normal(0, 1, (2, 19, 128)).astype(
        np.float32)
    out, st = tssm._slstm_forward(tp, tspec, _t(x))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax.jit(jssm.slstm_apply, static_argnums=1)(
            jp, jspec, jnp.asarray(x))), atol=LOGIT_ATOL, rtol=0)
    rec = tssm.slstm_state_init(2, tspec, "cpu")
    for i in range(19):
        h, rec = tssm.slstm_decode_step(tp, tspec, _t(x[:, i:i + 1]), rec)
        np.testing.assert_allclose(h[:, 0].numpy(), out[:, i].numpy(),
                                   atol=1e-6, rtol=0)
    for a, b in zip(rec, st):
        assert torch.equal(a, b)


@pytest.mark.parametrize("s", [1, 2, 7, 64, 100])
def test_linear_scan_equals_the_sequential_recurrence(s):
    rng = np.random.RandomState(s)
    a = _t(rng.uniform(0.5, 1.0, (2, s, 6, 3)).astype(np.float32))
    b = _t(rng.normal(0, 1, (2, s, 6, 3)).astype(np.float32))
    got = tssm.linear_scan(a, b, dim=1)
    h = torch.zeros(2, 6, 3, dtype=torch.float64)
    for t in range(s):
        h = a[:, t].double() * h + b[:, t].double()
        np.testing.assert_allclose(got[:, t].numpy(), h.numpy(),
                                   rtol=SCAN_RTOL, atol=SCAN_RTOL)


def test_ssm_matches_the_reference_and_its_decode():
    jc = jget_config("hymba-1.5b").reduced()
    jspec = jtransformer.ssm_spec(jc)
    tspec = tssm.SsmSpec(**dataclasses.asdict(jspec))
    jp, tp = _mixer_params(jssm.init_ssm, jspec)
    x = np.random.RandomState(4).normal(0, 1, (2, 33, 128)).astype(
        np.float32)
    out, st = tssm._ssm_forward(tp, tspec, _t(x))
    jout, jst = jax.jit(jtransformer._ssm_prefill, static_argnums=1)(
        jp, jc, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                               atol=LOGIT_ATOL, rtol=0)
    for a, b in zip(st, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=SCAN_RTOL)
    rec = tssm.ssm_state_init(2, tspec, torch.float32, "cpu")
    for i in range(33):
        h, rec = tssm.ssm_decode_step(tp, tspec, _t(x[:, i:i + 1]), rec)
        np.testing.assert_allclose(h[:, 0].numpy(), out[:, i].numpy(),
                                   atol=LOGIT_ATOL, rtol=0)


# -- windowed attention reaches the mha op ---------------------------------------

@pytest.mark.parametrize("window,want", [(9, 9), (48, 0), (FULL_WINDOW, 0),
                                         (None, 0)])
def test_windowed_attention_reaches_the_mha_op(window, want, monkeypatch):
    """A call with a window and no kv length goes to ``mha`` with that
    window (one no query reaches past, FULL_WINDOW among them, as 0); it
    equals the reference's masked path and the port's own."""
    rng = np.random.RandomState(7)
    q = rng.normal(0, 1, (2, 8, 48, 32)).astype(np.float32)
    k = rng.normal(0, 1, (2, 4, 48, 32)).astype(np.float32)
    v = rng.normal(0, 1, (2, 4, 48, 32)).astype(np.float32)
    calls = []
    real = tattn.mha

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)
    monkeypatch.setattr(tattn, "mha", spy)
    out = tattn._sdpa(_t(q), _t(k), _t(v), causal=True, window=window)
    assert calls == [{"causal": True, "q_offset": 0, "window": want}]
    masked = tattn._sdpa(_t(q), _t(k), _t(v), causal=True, window=window,
                         kv_len=48)
    assert len(calls) == 1                  # kv_len: the plain masked path
    ref = jattn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=True, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6,
                               rtol=0)
    np.testing.assert_allclose(out.numpy(), masked.numpy(), atol=2e-6,
                               rtol=0)
