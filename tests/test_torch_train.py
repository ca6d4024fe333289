"""LIN and LOG training through the port against the JAX package.

Every version fits through ``make_estimator(...).fit(system.put(X, y))``
on both packages, from the same numpy-seeded data, on ``pim`` at several
core counts (7 and 16 pad the last shard) and on ``host``.  Integer
versions must be bit-identical and leave equal ``TransferStats``.

fp32 is held to ``FP32_RTOL``/``FP32_ATOL``: the port's batched
``torch.matmul`` and XLA's per-core dot sum their products in another
order on the CPU, so the float32 weights may differ in the last few
ULPs per step; over these few steps that stays below 1e-5 relative.

The reference's ``mul_round_f32`` calls ``jax.experimental.enable_x64``,
which this JAX no longer has; :func:`x64_alias` aliases it for this
file's tests only.
"""
import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest

import repro.api as japi
from repro.core import linreg as jlin
from repro.core import logreg as jlog
from repro.data import synthetic as jsyn

import repro_torch.api as tapi
from repro_torch.core import linreg as tlin
from repro_torch.core import logreg as tlog
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import dispatch

FP32_RTOL, FP32_ATOL = 1e-5, 1e-6
ITERS = 6
SYSTEMS = [("pim", 1), ("pim", 7), ("pim", 16), ("host", 8)]
LIN_VERSIONS = ("fp32", "int32", "hyb", "bui")
LOG_VERSIONS = ("fp32", "int32", "int32_lut_mram", "int32_lut_wram",
                "hyb_lut", "bui_lut")


@pytest.fixture(scope="module", autouse=True)
def x64_alias():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        yield


@pytest.fixture(scope="module")
def data():
    X, y, _ = tsyn.make_linear_dataset(1000, 13, seed=3)
    return X, y


def _fit_both(workload, version, kind, n_cores, X, y, reduce="fabric",
              **params):
    js = japi.make_system(kind, n_cores=n_cores, reduce=reduce)
    ts = tapi.make_system(kind, n_cores=n_cores, reduce=reduce, device="cpu")
    je = japi.make_estimator(workload, version=version, system=js,
                             **params).fit(js.put(X, y))
    te = tapi.make_estimator(workload, version=version, system=ts,
                             **params).fit(ts.put(X, y))
    return je, te, js, ts


def _assert_same_fit(je, te, js, ts, version):
    assert te.coef_.dtype == np.float32 and te.coef_.shape == je.coef_.shape
    if version == "fp32":
        np.testing.assert_allclose(te.coef_, je.coef_, rtol=FP32_RTOL,
                                   atol=FP32_ATOL)
        np.testing.assert_allclose(te.intercept_, je.intercept_,
                                   rtol=FP32_RTOL, atol=FP32_ATOL)
    else:
        np.testing.assert_array_equal(te.coef_, je.coef_)
        assert te.intercept_ == je.intercept_
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)


def test_synthetic_data_identical():
    for a, b in zip(tsyn.make_linear_dataset(1000, 13, seed=3),
                    jsyn.make_linear_dataset(1000, 13, seed=3)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tsyn.make_classification(500, 16, seed=1),
                    jsyn.make_classification(500, 16, seed=1)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind,n_cores", SYSTEMS)
@pytest.mark.parametrize("version", LIN_VERSIONS)
def test_lin_version_matches_reference(version, kind, n_cores, data):
    _assert_same_fit(*_fit_both("linreg", version, kind, n_cores, *data,
                                n_iters=ITERS), version)


@pytest.mark.parametrize("kind,n_cores", SYSTEMS)
@pytest.mark.parametrize("version", LOG_VERSIONS)
def test_log_version_matches_reference(version, kind, n_cores, data):
    _assert_same_fit(*_fit_both("logreg", version, kind, n_cores, *data,
                                n_iters=ITERS), version)


@pytest.mark.parametrize("reduce", ["host", "hierarchical",
                                    "hierarchical-auto"])
@pytest.mark.parametrize("workload,version", [("linreg", "int32"),
                                              ("linreg", "fp32"),
                                              ("logreg", "int32_lut_wram"),
                                              ("logreg", "hyb_lut")])
def test_reduce_strategies_match_reference(workload, version, reduce, data):
    _assert_same_fit(*_fit_both(workload, version, "pim", 16, *data,
                                reduce=reduce, n_iters=ITERS), version)


def test_log_on_classification_data_with_pallas_interpret_reference():
    """The reference's Pallas kernels (interpret mode) give the same LOG
    trajectory as the port's plain versions."""
    X, y = tsyn.make_classification(1024, 16, seed=2)
    for version in ("int32_lut_wram", "int32"):
        je, te, js, ts = _fit_both("logreg", version, "pim", 8, X, y,
                                   n_iters=3)
        jk = japi.make_estimator(
            "logreg", version=version, system=js, n_iters=3,
            kernel_backend="pallas_interpret").fit(js.put(X, y))
        np.testing.assert_array_equal(te.coef_, jk.coef_)
        np.testing.assert_array_equal(te.coef_, je.coef_)


@pytest.mark.parametrize("version", LIN_VERSIONS)
@pytest.mark.parametrize("kind,n_cores", [("pim", 7), ("host", 8)])
def test_minibatch_sgd_matches_reference(version, kind, n_cores, data):
    """The port draws its batch offsets from the same MT19937 stream."""
    _assert_same_fit(*_fit_both("linreg", version, kind, n_cores, *data,
                                n_iters=8, minibatch=32, seed=5), version)


def _run(gen, k=None):
    """Advance a fit_steps generator k steps (None: to the end)."""
    tick = None
    for i in range(k if k is not None else 1 << 30):
        try:
            tick = next(gen)
        except StopIteration as stop:
            return stop.value
    return tick


@pytest.mark.parametrize("workload,version,params", [
    ("linreg", "int32", {"minibatch": 16, "seed": 9}),
    ("linreg", "hyb", {}),
    ("logreg", "int32_lut_mram", {}),
    ("logreg", "bui_lut", {"record_every": 2}),
])
def test_reference_snapshot_resumes_in_the_port(workload, version, params,
                                                data):
    """A snapshot taken from a JAX fit resumes in the port and ends where
    the uninterrupted JAX fit ends, bit for bit."""
    X, y = data
    jmod, tmod = ((jlin, tlin) if workload == "linreg" else (jlog, tlog))
    jcfg_cls = jlin.GdConfig if workload == "linreg" else jlog.LogRegConfig
    tcfg_cls = tlin.GdConfig if workload == "linreg" else tlog.LogRegConfig
    js = japi.make_system("pim", n_cores=7)
    ts = tapi.make_system("pim", n_cores=7, device="cpu")
    jds, tds = js.put(X, y), ts.put(X, y)
    eval_fn = (lambda w, b: float(np.abs(w).sum() + b))
    full = jmod.fit(jds, jcfg_cls(version=version, n_iters=8, **params),
                    eval_fn)
    gen = jmod.fit_steps(jds, jcfg_cls(version=version, n_iters=8, **params),
                         eval_fn)
    snap = _run(gen, 3).snapshot()
    gen.close()
    resumed = _run(tmod.fit_steps(tds, tcfg_cls(version=version, n_iters=8,
                                                **params), eval_fn,
                                  state=snap))
    np.testing.assert_array_equal(resumed.w, full.w)
    assert resumed.b == full.b
    assert [h[0] for h in resumed.history] == [h[0] for h in full.history]
    np.testing.assert_allclose([h[1] for h in resumed.history],
                               [h[1] for h in full.history], rtol=1e-6)


def test_port_snapshot_resumes_in_the_port(data):
    X, y = data
    ts = tapi.make_system("pim", n_cores=16, device="cpu")
    ds = ts.put(X, y)
    cfg = tlin.GdConfig(version="bui", n_iters=7, minibatch=20, seed=1)
    full = tlin.fit(ds, cfg)
    gen = tlin.fit_steps(ds, cfg)
    tick = _run(gen, 4)
    assert tick == 1 and tick.resumable
    snap = tick.snapshot()
    assert snap["meta"]["iters"] == 4 and "rng_mt_keys" in snap["arrays"]
    resumed = _run(tlin.fit_steps(ds, cfg, state=snap))
    np.testing.assert_array_equal(resumed.w, full.w)
    assert resumed.b == full.b


def test_sweep_reuses_the_resident_views(data):
    ts = tapi.make_system("pim", n_cores=16, device="cpu")
    ds = ts.put(*data)
    for lr in (0.05, 0.1):
        for version in ("int32", "hyb", "bui"):
            tapi.make_estimator("linreg", version=version, lr=lr,
                                n_iters=2, system=ts).fit(ds)
    assert ts.stats.shard_transfers == 4    # int32 X, y; hyb X, y
    assert ts.registered_kernels() == ("lin.grad/hyb/x7.w8.f10",
                                       "lin.grad/int32/f10")


def test_estimator_surface(data):
    X, y = data
    ts = tapi.make_system("host", device="cpu")
    est = tapi.make_estimator("logreg", version="int32_lut_wram",
                              n_iters=20, system=ts).fit(X, y)
    assert 0.5 < est.score(X, y) <= 1.0
    assert est.predict_proba(X).shape == (1000, 2)
    assert est.get_params()["lr"] == 5.0
    est.set_params(n_cores=4, lr=2.0)
    assert est.system.config.n_cores == 4 and est.system.kind == "host"
    with pytest.raises(ValueError):
        est.set_params(kernel_backend="cuda")
    with pytest.raises(ValueError):
        tapi.make_estimator("linreg", version="int64", system=ts)
    assert sorted(tapi.list_workloads()) == ["dtree", "emb", "kmeans",
                                             "linreg", "logreg"]


@pytest.mark.parametrize("workload", ["linreg", "logreg"])
def test_step_fusion_is_refused_until_ported(workload, data):
    """Step fusion runs: a fused int32 fit through the estimator equals
    the serial one bit for bit, in one launch and one sync a chunk."""
    fits = {}
    for fuse in (1, 8):
        ts = tapi.make_system("pim", n_cores=4, device="cpu")
        est = tapi.make_estimator(workload, version="int32", n_iters=20,
                                  fuse_steps=fuse, system=ts).fit(*data)
        fits[fuse] = (est.coef_, est.intercept_, ts.stats)
    (w1, b1, s1), (w8, b8, s8) = fits[1], fits[8]
    np.testing.assert_array_equal(w8, w1)
    assert b8 == b1
    assert (s1.kernel_launches, s8.kernel_launches) == (20, 3)
    assert s8.host_syncs == 3


def test_cpu_fit_counts_no_kernel_launches(data):
    dispatch.reset_launch_counts()
    ts = tapi.make_system("pim", n_cores=4, device="cpu")
    tapi.make_estimator("logreg", version="int32_lut_wram", n_iters=2,
                        system=ts).fit(*data)
    assert dispatch.launch_counts == {}
