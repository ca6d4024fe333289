"""The port's fixed-point helpers and kernel ops against the JAX package.

Same inputs, made with numpy from a seed, go through the reference
(``repro``) and the port (``repro_torch``); every integer result must be
bit-identical.  The reference's Pallas kernels run in interpret mode and
through their ``jnp_ref`` oracles, as tests/test_kernels.py runs them.
On the CPU the port's ops run their plain PyTorch versions
(tests/test_torch_cuda.py holds the CUDA kernels against them on a card).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import fixed_point as jfx
from repro.core import lut as jlut
from repro.kernels import dispatch as jdispatch

from repro_torch.core import fixed_point as tfx
from repro_torch.core import lut as tlut
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.gini_split import gini_split_cuda, gini_split_plain
from repro_torch.kernels.kmeans_assign import (kmeans_assign_cuda,
                                               kmeans_assign_plain)
from repro_torch.kernels.lut_activation import (lut_sigmoid_cuda,
                                                lut_sigmoid_plain)
from repro_torch.kernels.quant_matmul import fx_matvec_cuda, fx_matvec_plain
from repro_torch.kernels.sparse_gather import (emb_gather_cuda,
                                               emb_scatter_add_cuda)

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def _j(a):
    return np.asarray(a)


def _t(a):
    return a.cpu().numpy()


def _q(rng, shape, lo=-2048, hi=2048):
    """int32 Q10-range values, as the quantized datasets hold."""
    return rng.randint(lo, hi, size=shape).astype(np.int32)


# ---------------------------------------------------------------------------
# fixed_point / lut helpers, bit for bit
# ---------------------------------------------------------------------------

def _float_inputs(rng, n=257):
    x = rng.uniform(-4, 4, n).astype(np.float32)
    # ties at every rounding step, zero, and values that saturate
    edges = np.array([0.5 / 1024, 1.5 / 1024, -0.5 / 1024, -2.5 / 1024, 0,
                      3e6, -3e6, 1e10, -1e10, 2097151.9, 200.0, -200.0],
                     np.float32)
    return np.concatenate([x, edges])


HELPERS = {
    "to_fixed_q10": lambda m, x, **_: m.to_fixed(x, 10),
    "to_fixed_q0": lambda m, x, **_: m.to_fixed(x, 0),
    "to_fixed_int8": lambda m, x, dt, **_: m.to_fixed(x, 7, dtype=dt["int8"]),
    "to_fixed_int16": lambda m, x, dt, **_: m.to_fixed(x, 8,
                                                       dtype=dt["int16"]),
    "from_fixed": lambda m, q, **_: m.from_fixed(q, 10),
    "shift_round_5": lambda m, q, **_: m._shift_round(q, 5),
    "shift_round_0": lambda m, q, **_: m._shift_round(q, 0),
    "fx_dot": lambda m, q2, w, **_: m.fx_dot(q2, w, 10),
    "fx_dot_hybrid": lambda m, q8, w16, **_: m.fx_dot_hybrid(q8, w16, 7, 8,
                                                             10),
    "fx_dot_hybrid_upshift": lambda m, q8, w16, **_: m.fx_dot_hybrid(
        q8, w16, 2, 3, 10),
    "mul_round_f32": lambda m, s, g, **_: m.mul_round_f32(s, g),
}


@pytest.fixture(scope="module")
def x64_alias():
    """``mul_round_f32`` of the reference calls
    ``jax.experimental.enable_x64``, which this JAX no longer has; alias
    it, scoped to the tests that need it."""
    import jax
    import jax.experimental
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        yield


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_fixed_point_helper_bit_exact(name, x64_alias):
    rng = np.random.RandomState(7)
    x = _float_inputs(rng)
    q = np.concatenate([_q(rng, 200, -2 ** 20, 2 ** 20),
                        np.array([0, 1, -1, 15, 16, -16, -17, 31, 32],
                                 np.int32)])
    q2, w = _q(rng, (37, 13)), _q(rng, 13)
    q8 = rng.randint(-128, 128, (37, 16)).astype(np.int8)
    w16 = rng.randint(-2 ** 15, 2 ** 15, 16).astype(np.int16)
    s = np.float32(0.1 * 2.0 / 1000)
    g = rng.uniform(-1e4, 1e4, 64).astype(np.float32)
    inputs = dict(x=x, q=q, q2=q2, w=w, q8=q8, w16=w16, s=s, g=g)
    fn = HELPERS[name]
    ref = fn(jfx, dt={"int8": jnp.int8, "int16": jnp.int16},
             **{k: jnp.asarray(v) for k, v in inputs.items()})
    out = fn(tfx, dt={"int8": torch.int8, "int16": torch.int16},
             **{k: torch.as_tensor(v) for k, v in inputs.items()})
    assert str(out.dtype).split(".")[-1] == str(_j(ref).dtype)
    np.testing.assert_array_equal(_t(out), _j(ref))


def test_sigmoid_lut_table_identical():
    for args in ((20, 10, 15), (8, 6, 15)):
        np.testing.assert_array_equal(
            _t(tlut.build_sigmoid_lut(*args).table),
            _j(jlut.build_sigmoid_lut(*args).table))
    assert tlut.build_sigmoid_lut().nbytes == 40 * 1024


def _edge_q(rng, n_table):
    return np.concatenate([
        _q(rng, 500, -30000, 30000),
        np.array([0, 1, -1, n_table - 1, -(n_table - 1), n_table, -n_table,
                  INT32_MAX, INT32_MIN + 1, 100000, -100000], np.int32)])


@pytest.mark.parametrize("fn", ["lut_sigmoid_fixed", "taylor_exp_fixed",
                                "taylor_sigmoid_fixed"])
def test_lut_and_taylor_helpers_bit_exact(fn):
    rng = np.random.RandomState(3)
    jl, tl = jlut.build_sigmoid_lut(), tlut.build_sigmoid_lut()
    q = _edge_q(rng, 20480)
    if fn == "lut_sigmoid_fixed":
        q = np.append(q, np.int32(INT32_MIN))  # abs wraps; index clamps to 0
        ref, out = jlut.lut_sigmoid_fixed(jnp.asarray(q), jl), \
            tlut.lut_sigmoid_fixed(torch.from_numpy(q), tl)
    else:
        ref = getattr(jlut, fn)(jnp.asarray(q), 10)
        out = getattr(tlut, fn)(torch.from_numpy(q), 10)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(_t(out), _j(ref))


# ---------------------------------------------------------------------------
# fx_matvec and lut_sigmoid: the plain versions against both JAX paths
# ---------------------------------------------------------------------------

JAX_BACKENDS = ("jnp_ref", "pallas_interpret")


@pytest.mark.parametrize("n,f", [(1000, 13), (4096, 16), (1027, 16),
                                 (1, 1), (7, 4)])
@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_fx_matvec_plain_matches_jax(n, f, backend):
    rng = np.random.RandomState(n + f)
    x, w = _q(rng, (n, f)), _q(rng, f)
    x[0, 0], w[0] = INT32_MAX, 3   # a product that wraps in int32
    ref = jdispatch.launch("fx_matvec", jnp.asarray(x), jnp.asarray(w), 10,
                           backend=backend)
    out = fx_matvec_plain(torch.from_numpy(x), torch.from_numpy(w), 10)
    np.testing.assert_array_equal(_t(out), _j(ref))


def test_fx_matvec_batched_cores_match_flat():
    """[C, n_pc, F] shards give the flat [C*n_pc, F] result, reshaped."""
    rng = np.random.RandomState(0)
    x, w = _q(rng, (7, 143, 13)), _q(rng, 13)
    ref = jdispatch.launch("fx_matvec", jnp.asarray(x.reshape(-1, 13)),
                           jnp.asarray(w), 10, backend="jnp_ref")
    out = dispatch.launch("fx_matvec", torch.from_numpy(x),
                          torch.from_numpy(w), 10)
    assert out.shape == (7, 143)
    np.testing.assert_array_equal(_t(out).reshape(-1), _j(ref))


@pytest.mark.parametrize("shape", [(1000,), (16, 250), (7, 143)])
@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("placement", ["wram", "mram"])
def test_lut_sigmoid_plain_matches_jax(shape, backend, placement):
    rng = np.random.RandomState(sum(shape))
    jl, tl = jlut.build_sigmoid_lut(), tlut.build_sigmoid_lut()
    size = int(np.prod(shape))
    q = np.resize(_edge_q(rng, 20480), size).reshape(shape)
    ref = jdispatch.launch("lut_sigmoid", jnp.asarray(q), jl,
                           backend=backend)
    out = lut_sigmoid_plain(torch.from_numpy(q), tl, placement)
    assert out.dtype == torch.int32 and out.shape == shape
    np.testing.assert_array_equal(_t(out), _j(ref))


def test_lut_sigmoid_int32_min_follows_the_reference_oracle():
    """At INT32_MIN |x| wraps negative.  The reference oracle's
    ``table[idx]`` clamps that index to 0; the port clamps it too.  (The
    reference's Pallas kernel reads its fill value there instead.)"""
    q = np.array([INT32_MIN, INT32_MIN + 1, -5], np.int32)
    ref = jdispatch.launch("lut_sigmoid", jnp.asarray(q),
                           jlut.build_sigmoid_lut(), backend="jnp_ref")
    out = dispatch.launch("lut_sigmoid", torch.from_numpy(q),
                          tlut.build_sigmoid_lut())
    np.testing.assert_array_equal(_t(out), _j(ref))
    assert int(out[0]) == 16384   # 2^15 - table[0]


# ---------------------------------------------------------------------------
# kmeans_assign and gini_split: the plain versions against both JAX paths
# ---------------------------------------------------------------------------

def _kmeans_inputs(case, rng):
    """int16 points [N, F] and centroids [K, F] for one named case."""
    if case == "quantized":         # the KME view's +-2047 range
        x = rng.randint(-2047, 2048, (1000, 16)).astype(np.int16)
        c = rng.randint(-2047, 2048, (16, 16)).astype(np.int16)
    elif case == "full_range":      # products and norms wrap int32
        x = rng.randint(-32768, 32768, (1027, 13)).astype(np.int16)
        c = rng.randint(-32768, 32768, (5, 13)).astype(np.int16)
        x[0], c[0] = 32767, -32768
    elif case == "ties":            # duplicated centroids: first one wins
        x = rng.randint(-4, 5, (700, 4)).astype(np.int16)
        c = rng.randint(-2, 3, (6, 4)).astype(np.int16)
        c[3], c[5] = c[1], c[0]
    else:                           # one row, one centroid
        x = rng.randint(-2047, 2048, (1, 3)).astype(np.int16)
        c = rng.randint(-2047, 2048, (1, 3)).astype(np.int16)
    return x, c


@pytest.mark.parametrize("case", ["quantized", "full_range", "ties",
                                  "single"])
@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_kmeans_assign_plain_matches_jax(case, backend):
    rng = np.random.RandomState(len(case))
    x, c = _kmeans_inputs(case, rng)
    ref = jdispatch.launch("kmeans_assign", jnp.asarray(x), jnp.asarray(c),
                           backend=backend)
    out = kmeans_assign_plain(torch.from_numpy(x)[None], torch.from_numpy(c))
    for o, r in zip(out, ref):
        assert o.dtype == torch.int32
        np.testing.assert_array_equal(_t(o)[0], _j(r))
    if case == "ties":    # the duplicates never win
        assert not np.isin(_t(out[0]), [3, 5]).any()


def test_kmeans_assign_batched_cores_match_per_core():
    """[C, n_pc, F] shards give each core's own labels, sums, counts."""
    rng = np.random.RandomState(0)
    x = rng.randint(-2047, 2048, (7, 143, 16)).astype(np.int16)
    c = rng.randint(-2047, 2048, (9, 16)).astype(np.int16)
    out = dispatch.launch("kmeans_assign", torch.from_numpy(x),
                          torch.from_numpy(c))
    assert [tuple(o.shape) for o in out] == [(7, 143), (7, 9, 16), (7, 9)]
    for core in range(7):
        ref = jdispatch.launch("kmeans_assign", jnp.asarray(x[core]),
                               jnp.asarray(c), backend="jnp_ref")
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(_t(o)[core], _j(r))


def _gini_inputs(case, rng):
    """x [N, F], y, leaf [N], thresholds [L, F] for one named case."""
    n, f, n_leaves = {"root": (1000, 16, 64), "spread": (3000, 16, 1024),
                      "ragged": (1027, 13, 37)}[case]
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = rng.randint(0, 2, n).astype(np.int32)
    leaf = (np.zeros(n, np.int32) if case == "root"
            else rng.randint(0, n_leaves, n).astype(np.int32))
    th = rng.normal(size=(n_leaves, f)).astype(np.float32)
    th[leaf[:5], 0] = x[:5, 0]          # x == threshold counts as below
    return x, y, leaf, th


@pytest.mark.parametrize("case", ["root", "spread", "ragged"])
@pytest.mark.parametrize("backend", JAX_BACKENDS)
def test_gini_split_plain_matches_jax(case, backend):
    rng = np.random.RandomState(len(case))
    x, y, leaf, th = _gini_inputs(case, rng)
    ref = jdispatch.launch("gini_split", jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(leaf), jnp.asarray(th), 2,
                           backend=backend)
    out = gini_split_plain(*(torch.from_numpy(a)[None] for a in (x, y, leaf)),
                           torch.from_numpy(th), 2)
    for o, r in zip(out, ref):
        assert o.dtype == torch.int32
        np.testing.assert_array_equal(_t(o)[0], _j(r))


def test_gini_split_batched_cores_and_out_of_range_rows():
    """Each core counts its own rows; a leaf or class out of range counts
    nowhere."""
    rng = np.random.RandomState(3)
    x = rng.normal(size=(5, 200, 16)).astype(np.float32)
    y = rng.randint(0, 3, (5, 200)).astype(np.int32)
    leaf = rng.randint(0, 40, (5, 200)).astype(np.int32)
    th = rng.normal(size=(40, 16)).astype(np.float32)
    below, total = dispatch.launch(
        "gini_split", *(torch.from_numpy(a) for a in (x, y, leaf, th)), 3)
    for core in range(5):
        ref = jdispatch.launch("gini_split", jnp.asarray(x[core]),
                               jnp.asarray(y[core]), jnp.asarray(leaf[core]),
                               jnp.asarray(th), 3, backend="jnp_ref")
        np.testing.assert_array_equal(_t(below)[core], _j(ref[0]))
        np.testing.assert_array_equal(_t(total)[core], _j(ref[1]))
    bad_leaf, bad_y = leaf.copy(), y.copy()
    bad_leaf[0, :10], bad_y[1, :10] = 40, 3
    below2, total2 = gini_split_plain(
        *(torch.from_numpy(a) for a in (x, bad_y, bad_leaf, th)), 3)
    assert int(total2.sum()) == 5 * 200 - 20
    assert int(total2[2:].sum()) == int(total[2:].sum())


# ---------------------------------------------------------------------------
# dispatch: the device picks the implementation; counts are the kernel's
# ---------------------------------------------------------------------------

def test_dispatch_runs_plain_on_cpu_without_counting():
    dispatch.reset_launch_counts()
    x = torch.from_numpy(_q(np.random.RandomState(1), (64, 16)))
    w = torch.from_numpy(_q(np.random.RandomState(2), 16))
    z = dispatch.launch("fx_matvec", x, w, 10)
    assert torch.equal(z, fx_matvec_plain(x, w, 10))
    assert torch.equal(dispatch.launch("lut_sigmoid", z,
                                       tlut.build_sigmoid_lut(),
                                       placement="mram"),
                       lut_sigmoid_plain(z, tlut.build_sigmoid_lut()))
    assert dispatch.launch_counts == {}


def test_dispatch_rejects_unknown_ops_and_placements():
    with pytest.raises(KeyError):
        dispatch.get_op("no_such_op")
    with pytest.raises(ValueError):
        dispatch.launch("lut_sigmoid", torch.zeros(4, dtype=torch.int32),
                        tlut.build_sigmoid_lut(), placement="vmem")
    assert set(dispatch._OPS) == {"fx_matvec", "lut_sigmoid",
                                  "kmeans_assign", "gini_split",
                                  "emb_gather", "emb_scatter_add",
                                  "int_matmul", "quant_matmul", "mha",
                                  "mha_bwd"}


@pytest.mark.parametrize("op", ["fx_matvec", "lut_sigmoid", "kmeans_assign",
                                "gini_split", "emb_gather",
                                "emb_scatter_add", "int_matmul",
                                "quant_matmul", "mha", "mha_bwd"])
def test_cuda_wrappers_refuse_cpu_tensors(op):
    """A CUDA wrapper launches or raises; it never computes on the CPU."""
    x = torch.zeros((4, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        if op == "fx_matvec":
            fx_matvec_cuda(x, torch.zeros(16, dtype=torch.int32), 10)
        elif op == "lut_sigmoid":
            lut_sigmoid_cuda(x, tlut.build_sigmoid_lut())
        elif op == "kmeans_assign":
            kmeans_assign_cuda(torch.zeros((2, 4, 16), dtype=torch.int16),
                               torch.zeros((3, 16), dtype=torch.int16))
        elif op == "emb_gather":
            emb_gather_cuda(x[None], x[:1], x[0])
        elif op == "emb_scatter_add":
            emb_scatter_add_cuda(x[None], x[:1], x[0, :2], x[:2])
        elif op in ("int_matmul", "quant_matmul"):
            a = torch.zeros((4, 16), dtype=torch.int8)
            scales = () if op == "int_matmul" else (torch.ones(()),) * 2
            dispatch.get_op(op).cuda(a, a.T.contiguous(), *scales)
        elif op == "mha":
            q = torch.zeros((1, 2, 4, 8))
            dispatch.get_op(op).cuda(q, q, q)
        elif op == "mha_bwd":
            q = torch.zeros((1, 2, 4, 8))
            dispatch.get_op(op).cuda(q, q, q, q, q, torch.zeros((1, 2, 4)))
        else:
            gini_split_cuda(torch.zeros((2, 4, 16)), x[:2], x[:2],
                            torch.zeros((8, 16)), 2)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No fallback: a missing compiler is an error, not a plain path."""
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os, "access", lambda path, mode: False)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load("fx_matvec")


def test_library_names_follow_the_source():
    names = {build.library_path(n).name for n in build.SOURCES}
    assert len(names) == len(build.SOURCES)
    assert all(name.startswith("lib") and name.endswith(".so")
               for name in names)
    assert all((build.CSRC / f"{n}.cu").exists() for n in build.SOURCES)
