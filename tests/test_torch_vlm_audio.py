"""The VLM and audio families (llama-3.2-vision-11b, whisper-tiny) of the
port against the JAX package, on the CPU.

Both packages run on the same numpy-seeded inputs, and the port takes the
reference's parameters (and gradients) through ``params_from_jax``.  The
reference initialises every ``cross`` block's ``gate_attn`` and
``gate_mlp`` to 0, and ``tanh(0)`` shuts the vision path off, so the
shared tree sets them non-zero first (``GATES``), and
``test_forward_and_loss_match_the_reference`` checks that the logits move
with them.  Per arch, reduced to float32 (the VLM one unit of 4 attention
blocks and a cross block over 16 vision states 64 wide; whisper 2 encoder
and 2 decoder layers over 32 frames):

* the configs; GELU (the tanh form, ``jax.nn.gelu``'s default),
  ``layer_norm``, ``sinusoidal_positions`` and ``cross_attention`` with and
  without ``qkv_bias`` and ``qk_norm``;
* the forward's logits and ``Model.loss``, every gradient leaf against
  ``jax.value_and_grad``;
* whisper's ``encode`` and ``decoder_forward`` apart;
* prefill's last logits and every filled cache (the cross blocks' ``ck``
  and ``cv`` included), three decode steps from each package's own cache,
  and the reference's arch-smoke property (prefill, then one decode step,
  equals the forward's last position);
* ``launch/train.py``'s batches, vision states and frames against the
  reference launcher's, bit for bit, and two training steps.

Tolerances.  Float32 in two summation orders: logits and attention
outputs within ``LOGIT_ATOL``, losses within ``LOSS_ATOL``, gradient leaves
within ``GRAD_RTOL`` of their norm, cache entries within ``STATE_RTOL`` of
their largest value (or 1), the pieces within ``PIECE_ATOL``; the
arch-smoke property at the reference's own float32 tolerance
(``tests/test_arch_smoke.py``).  GELU: ``GELU_F32_ATOL`` in float32, one
bf16 ulp in bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.base import get_config as jget_config
from repro.launch import train as jlaunch
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models.api import Model as JModel

from repro_torch.configs.base import get_config
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers
from repro_torch.models.api import Model, params_from_jax
from repro_torch.models.attention import KVCache
from repro_torch.models.transformer import unit_pattern
from repro_torch.train import loop as tloop

VLM, AUDIO = "llama-3.2-vision-11b", "whisper-tiny"
ARCHS = (VLM, AUDIO)
#: float32 in two summation orders (module docstring)
LOGIT_ATOL, LOSS_ATOL, GRAD_RTOL, STATE_RTOL = 1e-4, 1e-5, 1e-4, 1e-4
PIECE_ATOL, PROPERTY_TOL, GELU_F32_ATOL = 1e-5, 1e-3, 1e-6
#: the cross blocks' gates in the shared tree: tanh(0.7) ~ 0.60 on the
#: attention, tanh(-0.4) ~ -0.38 on the MLP
GATES = {"gate_attn": 0.7, "gate_mlp": -0.4}
B, S, MAX_SEQ = 2, 24, 64


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _extras(cfg, rng) -> dict:
    """The batch's inputs beside the tokens, float32 N(0, 1)."""
    if cfg.family == "vlm":
        return {"vision": rng.normal(0, 1, (B, cfg.vision_tokens,
                                            cfg.vision_dim))
                .astype(np.float32)}
    return {"frames": rng.normal(0, 1, (B, cfg.encoder_seq, cfg.d_model))
            .astype(np.float32)}


def _with_gates(tree: dict) -> dict:
    """The reference's VLM tree with every cross block's gates at GATES."""
    unit = list(tree["unit"])
    for u, bt in enumerate(jget_config(VLM).reduced().layer_pattern()):
        if bt == "cross":
            unit[u] = {**unit[u], **{k: np.full_like(unit[u][k], v)
                                     for k, v in GATES.items()}}
    return {**tree, "unit": tuple(unit)}


@pytest.fixture(scope="module")
def ref():
    """Per arch, built once: the reference's model and params (the VLM's
    gates at GATES), the numpy tree and the inputs."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jc, tc = jget_config(arch).reduced(), get_config(arch).reduced()
            jm = JModel(jc)
            tree = jax.tree_util.tree_map(
                np.asarray, jm.init(jax.random.PRNGKey(0)))
            if jc.family == "vlm":
                tree = _with_gates(tree)
            rng = np.random.RandomState(1)
            toks = rng.randint(0, tc.vocab_size, (B, S + 3)).astype(np.int32)
            cache[arch] = dict(
                jc=jc, tc=tc, jm=jm, tree=tree, toks=toks,
                jp=jax.tree_util.tree_map(jnp.asarray, tree),
                extras=_extras(tc, rng))
        return cache[arch]
    return get


def _port(r) -> tuple:
    return (Model(r["tc"], device="cpu"),
            params_from_jax(r["tc"], r["tree"], device="cpu"))


def _batch(r, n: int = S, jax_arrays: bool = False) -> dict:
    toks = r["toks"][:, :n]
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1),
             **r["extras"]}
    if jax_arrays:
        return {k: jnp.asarray(v) for k, v in batch.items()}
    return batch


def _close(got: torch.Tensor, want, atol: float) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


# -- configs and pieces ---------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    for jc, tc in ((jget_config(arch), get_config(arch)),
                   (jget_config(arch).reduced(), get_config(arch).reduced())):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert tc.layer_pattern() == jc.layer_pattern()
    full = get_config(arch)
    if arch == AUDIO:     # 6 heads of 64 padded to 16 over 16
        assert tuple(tattn.plan_heads(full.n_heads, full.n_kv_heads)) == (
            16, 16, 1, 6, 6)
        assert full.resolved_head_dim == 64 and full.rope_fraction == 0
    else:                 # 8 cross blocks over 1601 vision states
        assert full.layer_pattern().count("cross") == 8
        assert (full.vision_tokens, full.vision_dim) == (1601, 4096)


def test_gelu_is_jaxs_tanh_form():
    """jax.nn.gelu's default is the tanh approximation: the port's GELU
    within GELU_F32_ATOL of it in float32.  In bf16 the port computes in
    float32 and rounds once (jax.nn.gelu on bf16 rounds every step, and
    its 1 + tanh cancels to 0 in the tails): within one bf16 ulp of
    jax.nn.gelu's float32 value on the same bf16 inputs, plus
    GELU_F32_ATOL.  The exact (erf) form misses both, by ~4.7e-4 in
    float32."""
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = tlayers.activation(_t(x), "gelu").numpy()
    np.testing.assert_allclose(got, want, atol=GELU_F32_ATOL, rtol=0)
    assert np.abs(F.gelu(_t(x)).numpy() - want).max() > 100 * GELU_F32_ATOL
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want_b = np.asarray(jax.nn.gelu(jnp.asarray(xb.float().numpy())))
    ulp = np.spacing(np.abs(want_b)) * 2 ** 16       # bf16 keeps 8 bits
    for fn, ok in ((lambda t: tlayers.activation(t, "gelu"), True),
                   (F.gelu, False)):
        err = np.abs(fn(xb).float().numpy() - want_b)
        assert bool(np.all(err <= ulp + GELU_F32_ATOL)) is ok


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_positions_match(dtype):
    rng = np.random.RandomState(2)
    x = rng.normal(1.5, 3, (3, 7, 48)).astype(np.float32)
    w, b = (rng.normal(0, 1, 48).astype(np.float32) for _ in range(2))
    jt, tt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jlayers.layer_norm(*(jnp.asarray(a, jt) for a in (x, w, b)),
                              eps=1e-5)
    got = tlayers.layer_norm(*(_t(a).to(tt) for a in (x, w, b)), eps=1e-5)
    assert got.dtype == tt
    atol = PIECE_ATOL if dtype == "float32" else 2 ** -5   # one ulp below 8
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)
    for n, d in ((1500, 384), (448, 384), (37, 10)):
        np.testing.assert_array_equal(tlayers.sinusoidal_positions(n, d),
                                      jlayers.sinusoidal_positions(n, d))


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_matches(qkv_bias, qk_norm):
    """Queries from 64-wide x, keys and values from 48-wide states of
    another length; biases and norms drawn non-trivial."""
    spec = jattn.AttnSpec(d_model=64, plan=jattn.plan_heads(4, 2),
                          head_dim=16, qkv_bias=qkv_bias, qk_norm=qk_norm,
                          kv_dim=48)
    tspec = tattn.AttnSpec(**{**dataclasses.asdict(spec),
                              "plan": tattn.HeadPlan(*spec.plan)})
    tree = jax.tree_util.tree_map(np.asarray, jattn.init_attention(
        jax.random.PRNGKey(3), spec, jnp.float32, cross=True))
    rng = np.random.RandomState(4)
    tree = {k: (v if k[0] == "w" else rng.normal(1, 0.3, v.shape)
                .astype(np.float32)) for k, v in tree.items()}
    x = rng.normal(0, 1, (2, 5, 64)).astype(np.float32)
    kv = rng.normal(0, 1, (2, 19, 48)).astype(np.float32)
    want = jattn.cross_attention({k: jnp.asarray(v) for k, v in tree.items()},
                                 spec, jnp.asarray(x), jnp.asarray(kv))
    tp = tlayers.Params(**{k: _t(v) for k, v in tree.items()})
    assert tuple(tattn.init_attention(torch.Generator(), tspec,
                                      torch.float32, cross=True)["wk"].shape
                 ) == tree["wk"].shape == (48, 16 * 16)
    _close(tattn.cross_attention(tp, tspec, _t(x), _t(kv)), want, PIECE_ATOL)


# -- whole models ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_the_reference(arch, ref):
    r = ref(arch)
    tm, tp = _port(r)
    jl = jax.jit(r["jm"].forward)(r["jp"], _batch(r, jax_arrays=True))
    tl = tm.forward(tp, _batch(r))
    assert tl.shape == (B, S, r["tc"].padded_vocab)
    _close(tl, jl, LOGIT_ATOL)
    jloss = jax.jit(r["jm"].loss)(r["jp"], _batch(r, jax_arrays=True))
    assert abs(float(tm.loss(tp, _batch(r))) - float(jloss)) <= LOSS_ATOL
    assert Model.param_count(tp) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(r["tree"]))
    init = tm.init(torch.Generator().manual_seed(0))
    assert {n: tuple(p.shape) for n, p in init.named_parameters()} == {
        n: tuple(p.shape) for n, p in tp.named_parameters()}
    if arch == VLM:       # the gates open the vision path; shut, it is gone
        gates = [p for n, p in tp.named_parameters() if "gate_" in n]
        assert len(gates) == 2 and not any(torch.any(p) for n, p in
                                           init.named_parameters()
                                           if "gate_" in n)
        for p in gates:
            p.data.zero_()
        shut = tm.forward(tp, _batch(r))
        assert float((shut - tl).abs().max()) > 100 * LOGIT_ATOL
        other = {**_batch(r), "vision": r["extras"]["vision"] + 1}
        assert torch.equal(tm.forward(tp, other), shut)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_the_reference(arch, ref):
    r = ref(arch)
    tm, tp = _port(r)
    tp.trainable_()
    jl, jg = jax.jit(jax.value_and_grad(r["jm"].loss))(
        r["jp"], _batch(r, jax_arrays=True))
    tl, tg = tloop.value_and_grad(tm, tp, _batch(r))
    assert abs(float(tl) - float(jl)) <= LOSS_ATOL
    want = dict(params_from_jax(r["tc"], jax.tree_util.tree_map(
        np.asarray, jg), device="cpu").named_parameters())
    assert set(tg) == set(want)
    for name, w in want.items():
        err = float((tg[name] - w).norm() / max(float(w.norm()), 1e-30))
        assert err <= GRAD_RTOL, (name, err)
    live = [n for n in tg if "gate_" in n or ".cross." in n]
    assert live and all(torch.any(tg[n]) for n in live)


def test_encode_and_decoder_forward_match(ref):
    r = ref(AUDIO)
    _, tp = _port(r)
    frames = r["extras"]["frames"]
    jenc = jencdec.encode(r["jc"], r["jp"], jnp.asarray(frames))
    tenc = tencdec.encode(r["tc"], tp, _t(frames))
    assert tenc.shape == (B, r["tc"].encoder_seq, r["tc"].d_model)
    _close(tenc, jenc, PIECE_ATOL)
    toks = r["toks"][:, :S]
    jl = jencdec.decoder_forward(r["jc"], r["jp"], jnp.asarray(toks), jenc)
    _close(tencdec.decoder_forward(r["tc"], tp, _t(toks), _t(jenc)), jl,
           LOGIT_ATOL)


def _assert_close(got: torch.Tensor, want, what) -> None:
    want = _t(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    assert err <= STATE_RTOL * scale, (what, err)


def _assert_cache(cfg, got, want) -> None:
    """The port's cache against the reference's, layer by layer."""
    if cfg.family == "audio":
        assert got["length"] == int(want["length"])
        for key in ("k", "v", "ck", "cv"):
            assert len(got[key]) == cfg.n_layers
            for i, g in enumerate(got[key]):
                _assert_close(g, want[key][i], (key, i))
            assert got[key][0].is_contiguous()
        return
    unit, reps = unit_pattern(cfg)
    for layer, g in enumerate(got):
        r, u = divmod(layer, len(unit))
        w = want[u]
        assert set(g) == set(w), layer
        if "kv" in w:
            assert isinstance(g["kv"], KVCache)
            assert g["kv"].length == int(w["kv"].length[r])
            _assert_close(g["kv"].k, w["kv"].k[r], (layer, "k"))
            _assert_close(g["kv"].v, w["kv"].v[r], (layer, "v"))
        else:
            for key in ("ck", "cv"):
                _assert_close(g[key], w[key][r], (layer, key))
                assert g[key].is_contiguous()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_and_three_decode_steps_match(arch, ref):
    r = ref(arch)
    tm, tp = _port(r)
    toks = r["toks"]
    pre = {**r["extras"], "tokens": toks[:, :S]}
    jl, jcache = r["jm"].prefill(r["jp"], {k: jnp.asarray(v) for k, v in
                                           pre.items()}, max_seq=MAX_SEQ)
    tl, tcache = tm.prefill(tp, pre, max_seq=MAX_SEQ)
    _close(tl, jl, LOGIT_ATOL)
    _assert_cache(r["tc"], tcache, jcache)
    jdecode = jax.jit(r["jm"].decode_step)
    for i in range(3):
        tok = toks[:, S + i:S + i + 1]
        jl, jcache = jdecode(r["jp"], jnp.asarray(tok), jcache)
        tl, tcache = tm.decode_step(tp, tok, tcache)
        _close(tl, jl, LOGIT_ATOL)
    _assert_cache(r["tc"], tcache, jcache)


def _shapes(cache) -> list:
    """The shapes of a cache's tensors, layer by layer."""
    if isinstance(cache, dict):           # the encoder-decoder's
        return [tuple(t.shape) for key in ("k", "v", "ck", "cv")
                for t in cache[key]]
    return [tuple(t.shape) for layer in cache for v in layer.values()
            for t in (v[:2] if isinstance(v, KVCache) else (v,))]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_is_the_forward(arch, ref):
    """tests/test_arch_smoke.py's property, in the port: prefill all but
    the last token, decode it, and its logits are the forward's last
    position; init_cache's tensors have prefill's shapes."""
    r = ref(arch)
    tm, tp = _port(r)
    batch = _batch(r)
    _, cache = tm.prefill(tp, {**batch, "tokens": batch["tokens"][:, :-1]},
                          max_seq=S)
    extras = {"cross_states": batch["vision"]} if arch == VLM else None
    dec, _ = tm.decode_step(tp, batch["tokens"][:, -1:], cache, extras)
    full = tm.forward(tp, batch)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               atol=PROPERTY_TOL, rtol=PROPERTY_TOL)
    assert _shapes(tm.init_cache(B, S)) == _shapes(cache)


# -- the train launcher --------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_batches_are_the_references(arch, monkeypatch):
    """Each step's batch (tokens, targets and the vision states or frames)
    as the reference's launcher draws it, bit for bit: both launchers run
    3 steps with the step function replaced by one that records its
    batch."""
    seen = {"ref": [], "port": []}

    def recorder(key, build):
        def fake_build(*args, **kwargs):
            cfg, model, opt, _ = build(*args, **kwargs)

            def step(params, opt_state, batch):
                seen[key].append({k: np.asarray(v) for k, v in batch.items()})
                return params, opt_state, {"loss": 0.0, "grad_norm": 0.0}
            return cfg, model, opt, step
        return fake_build
    monkeypatch.setattr(jlaunch, "build", recorder("ref", jlaunch.build))
    monkeypatch.setattr(tlaunch, "build", recorder("port", tlaunch.build))
    jlaunch.train(arch, steps=3, batch=2, seq=16, log_every=100)
    tlaunch.train(arch, steps=3, batch=2, seq=16, log_every=100,
                  device="cpu")
    extra = "vision" if arch == VLM else "frames"
    assert len(seen["ref"]) == len(seen["port"]) == 3
    for j, t in zip(seen["ref"], seen["port"]):
        assert set(j) == set(t) == {"tokens", "targets", extra}
        for key in j:
            assert t[key].dtype == j[key].dtype
            np.testing.assert_array_equal(t[key], j[key])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_runs_each_family(arch):
    params, losses, _ = tlaunch.train(arch, steps=2, batch=2, seq=16,
                                      log_every=100, device="cpu")
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    cfg = get_config(arch).reduced()
    if arch == AUDIO:
        assert (len(params["enc"]), len(params["dec"])) == (
            cfg.encoder_layers, cfg.n_layers)
    else:
        assert len(params["layers"]) == cfg.n_layers
