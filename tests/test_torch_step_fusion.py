"""Step fusion and the chunk pipeline of the port, on the CPU.

Fused fits (``fuse_steps > 1``: ``StepProgram`` chunks, ``ChunkPipeline``
boundaries) are held two ways, from the same numpy-seeded data:

* against the port's own serial fits: bit-identical for every integer
  LIN and LOG version, with minibatch SGD, a partial tail chunk, record
  points on chunk boundaries, pipeline depths 1-3, the HostReduce
  degradation and the hierarchical reduce;
* against the JAX package's fused fits: LIN and LOG integer weights, KME
  int16 centroids and labels (tol 0, and an early-converging case with
  equal iteration counts) and EMB int32 tables and history bit-identical,
  equal ``TransferStats``; fp32 within the tolerances of the serial
  comparisons (``FP32_RTOL``/``FP32_ATOL``: ATen's and XLA's float32
  products sum in other orders).

Snapshots taken mid-pipeline by either package resume the port's fused
fit bit-identically, and the launcher takes ``--fuse-steps`` for every
iterative workload and refuses it for DTR.

On the CPU a chunk is a loop of its k steps; the CUDA graph that replays
it on a card is tested in ``tests/test_torch_cuda.py``.  The reference's
``mul_round_f32`` calls ``jax.experimental.enable_x64``, which this JAX
no longer has; :func:`x64_alias` aliases it for this file's tests only.
"""
import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import kmeans as jkme
from repro.core import linreg as jlin
from repro.emb import trainer as jemb

import repro_torch.api as tapi
from repro_torch.core import kmeans as tkme
from repro_torch.core import linreg as tlin
from repro_torch.core import logreg as tlog
from repro_torch.data import synthetic as tsyn
from repro_torch.emb import trainer as temb
from repro_torch.launch import pim_ml
from repro_torch.systems import (ChunkPipeline, CompressedReduce,
                                 FabricReduce, HierarchicalReduce,
                                 HostReduce, make_system)

FP32_RTOL, FP32_ATOL = 1e-5, 1e-6
CORES = 8
INT_VERSIONS = [("linreg", v) for v in ("int32", "hyb", "bui")] + [
    ("logreg", v) for v in ("int32", "int32_lut_mram", "int32_lut_wram",
                            "hyb_lut", "bui_lut")]
EMB_PARAMS = {"n_iters": 20, "dim": 4, "lr": 1.0, "frac_bits": 12,
              "seed": 1, "record_every": 8, "flush_every": 8,
              "fuse_steps": 8}


@pytest.fixture(scope="module", autouse=True)
def x64_alias():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        yield


@pytest.fixture(scope="module")
def data():
    X, y, _ = tsyn.make_linear_dataset(300, 6, seed=0)
    return {"linreg": (X, y),
            "logreg": (X, (y > np.median(y)).astype(np.float32))}


@pytest.fixture(scope="module")
def blobs():
    X, _, _ = tsyn.make_blobs(300, 4, centers=5, seed=1)
    return X


@pytest.fixture(scope="module")
def recsys():
    return tsyn.make_recsys(768, 45, 35, dim=4, seed=3)


def _port_gd(workload, version, X, y, *, reduce="fabric", eval_fn=None,
             **params):
    mod, cfg_cls = ((tlin, tlin.GdConfig) if workload == "linreg"
                    else (tlog, tlog.LogRegConfig))
    ts = make_system("pim", n_cores=CORES, reduce=reduce, device="cpu")
    res = mod.fit(ts.put(X, y), cfg_cls(version=version, **params), eval_fn)
    return res, ts.stats


def _record(w, b):
    return (w.copy(), b)


def _assert_same_gd(a, b):
    np.testing.assert_array_equal(a.w, b.w)
    assert a.b == b.b
    assert [i for i, _ in a.history] == [i for i, _ in b.history]
    for (_, (wa, ba)), (_, (wb, bb)) in zip(a.history, b.history):
        np.testing.assert_array_equal(wa, wb)
        assert ba == bb


# ---------------------------------------------------------------------------
# Fused == serial in the port.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workload,version", INT_VERSIONS)
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_fused_equals_serial(workload, version, depth, data):
    """21 iterations in chunks of 8 with record points every 10: chunks
    8, 2, 8, 2, 1, every record on a boundary, the tail partial."""
    X, y = data[workload]
    kw = dict(n_iters=21, record_every=10, eval_fn=_record)
    serial, s1 = _port_gd(workload, version, X, y, **kw)
    fused, sk = _port_gd(workload, version, X, y, fuse_steps=8,
                         pipeline_depth=depth, **kw)
    _assert_same_gd(fused, serial)
    assert [i for i, _ in fused.history] == [10, 20, 21]
    assert (s1.kernel_launches, sk.kernel_launches) == (21, 5)
    assert (s1.host_syncs, sk.host_syncs) == (21, 5)


@pytest.mark.parametrize("version", ["int32", "hyb", "bui"])
def test_fused_minibatch_sgd_equals_serial(version, data):
    X, y = data["linreg"]
    kw = dict(n_iters=19, minibatch=9, seed=2)
    serial, _ = _port_gd("linreg", version, X, y, **kw)
    fused, _ = _port_gd("linreg", version, X, y, fuse_steps=6, **kw)
    _assert_same_gd(fused, serial)


@pytest.mark.parametrize("workload,params", [
    ("linreg", dict(version="int32", n_iters=12, minibatch=9,
                    fuse_steps=5)),
    ("logreg", dict(version="int32_lut_wram", n_iters=12, fuse_steps=5)),
    ("kmeans", dict(n_clusters=5, max_iter=12, tol=0.0, fuse_steps=5)),
    ("emb", dict(version="int32", batch=32, **EMB_PARAMS)),
])
def test_a_fused_fit_leaves_nothing_cached(workload, params, data, blobs,
                                           recsys):
    """A fused fit drops its program's cached chunk state when it ends
    (on a card: its graphs and their memory pools), so two equal fits on
    one system agree and the system holds nothing after either."""
    X, y = {**data, "kmeans": (blobs, None), "emb": recsys}[workload]
    ts = make_system("pim", n_cores=CORES, device="cpu")
    ds = ts.put(X, y)
    fits = []
    for _ in range(2):
        est = tapi.make_estimator(workload, system=ts, **params).fit(ds)
        assert ts._step_cache == {}
        fits.append(est.result_.model.user_raw if workload == "emb"
                    else est.cluster_centers_ if workload == "kmeans"
                    else np.append(est.coef_, est.intercept_))
    np.testing.assert_array_equal(fits[1], fits[0])


@pytest.mark.parametrize("reduce", ["hierarchical", "host"])
def test_fused_reduce_strategies_equal_serial(reduce, data):
    """Hierarchical sums the rank partials on the device inside a chunk;
    host is not fusable and degrades to per-step map_reduce calls with
    the serial accounting."""
    X, y = data["linreg"]
    serial, s1 = _port_gd("linreg", "int32", X, y, reduce=reduce,
                          n_iters=12)
    fused, sk = _port_gd("linreg", "int32", X, y, reduce=reduce,
                         n_iters=12, fuse_steps=5)
    _assert_same_gd(fused, serial)
    if reduce == "host":
        assert sk == s1
    else:
        assert (sk.kernel_launches, sk.host_syncs) == (3, 3)
        assert sk.inter_core_via_host == s1.inter_core_via_host


def test_strategies_say_whether_they_fuse():
    assert FabricReduce.fusable and HierarchicalReduce().fusable
    assert not HostReduce.fusable
    assert not CompressedReduce("hierarchical").fusable
    partials = {"g": torch.arange(16, dtype=torch.int32).reshape(8, 2)}
    full = HierarchicalReduce(4).device_reduce_full(partials)["g"]
    assert full.dtype == torch.int32
    assert full.tolist() == partials["g"].sum(0).tolist()


def test_pipeline_and_program_refuse_bad_arguments(data):
    ts = make_system("pim", n_cores=CORES, device="cpu")
    program = ts.step_program(lambda x: {"s": x.sum(-1)},
                              lambda carry: (),
                              lambda carry, red: (carry + red["s"], None),
                              name="sum")
    x = torch.ones((CORES, 3))
    carry, outs = program.run(torch.zeros(()), (x,), 4)
    assert float(carry) == 4 * CORES * 3 and outs is None
    with pytest.raises(ValueError, match="select"):
        program.run(carry, (x,), 2, xs=torch.zeros(2))
    with pytest.raises(ValueError, match="depth"):
        ChunkPipeline(program, 0)


# ---------------------------------------------------------------------------
# The port's fused fits against the JAX package's fused fits.
# ---------------------------------------------------------------------------

def _fit_both(workload, X, y=None, *, kind="pim", reduce="fabric",
              cores=CORES, **params):
    js = japi.make_system(kind, n_cores=cores, reduce=reduce)
    ts = tapi.make_system(kind, n_cores=cores, reduce=reduce, device="cpu")
    je = japi.make_estimator(workload, system=js, **params).fit(js.put(X, y))
    te = tapi.make_estimator(workload, system=ts, **params).fit(ts.put(X, y))
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)
    return je, te


@pytest.mark.parametrize("workload,version,kind,reduce", [
    ("linreg", "int32", "pim", "fabric"),
    ("linreg", "hyb", "pim", "hierarchical"),
    ("linreg", "bui", "pim", "host"),
    ("linreg", "int32", "host", "fabric"),
    ("linreg", "fp32", "pim", "fabric"),
    ("logreg", "int32", "pim", "fabric"),
    ("logreg", "int32_lut_mram", "pim", "hierarchical"),
    ("logreg", "int32_lut_wram", "pim", "fabric"),
    ("logreg", "hyb_lut", "host", "fabric"),
    ("logreg", "bui_lut", "pim", "fabric"),
    ("logreg", "fp32", "host", "fabric"),
])
def test_gd_fused_matches_reference(workload, version, kind, reduce, data):
    X, y = data[workload]
    je, te = _fit_both(workload, X, y, kind=kind, reduce=reduce,
                       version=version, n_iters=21, fuse_steps=8,
                       record_every=10)
    if version == "fp32":
        np.testing.assert_allclose(te.coef_, je.coef_, rtol=FP32_RTOL,
                                   atol=FP32_ATOL)
        np.testing.assert_allclose(te.intercept_, je.intercept_,
                                   rtol=FP32_RTOL, atol=FP32_ATOL)
    else:
        np.testing.assert_array_equal(te.coef_, je.coef_)
        assert te.intercept_ == je.intercept_


@pytest.mark.parametrize("version", ["int32", "hyb"])
def test_minibatch_fused_matches_reference(version, data):
    """Fused minibatch SGD leaves the reference's fused TransferStats and
    lands on the reference's serial weights bit for bit.  The reference's
    own fused scan is one float32 ULP off its serial fit here (seed 5):
    under this file's ``enable_x64`` alias its scan body does not keep
    ``mul_round_f32``'s two roundings, so the serial trajectory, which
    both packages' fused and serial fits claim, is the one compared."""
    X, y = data["linreg"]
    params = dict(version=version, n_iters=17, minibatch=9, seed=5)
    _, te = _fit_both("linreg", X, y, fuse_steps=4, pipeline_depth=3,
                      **params)
    js = japi.make_system("pim", n_cores=CORES)
    je = japi.make_estimator("linreg", system=js, **params).fit(
        js.put(X, y))
    np.testing.assert_array_equal(te.coef_, je.coef_)
    assert te.intercept_ == je.intercept_


@pytest.mark.parametrize("tol,params", [
    (0.0, {}),
    (0.0, {"n_init": 2, "reduce": "hierarchical"}),
    (1e-4, {"pipeline_depth": 1}),
    (1e-4, {"pipeline_depth": 3, "kind": "host"}),
])
def test_kmeans_int16_fused_matches_reference(tol, params, blobs):
    """tol 0 runs all 40 iterations; tol 1e-4 converges after a few, and
    both packages latch at the same iteration."""
    je, te = _fit_both("kmeans", blobs, version="int16", n_clusters=5,
                       max_iter=40, seed=3, tol=tol, fuse_steps=8, **params)
    np.testing.assert_array_equal(te.cluster_centers_, je.cluster_centers_)
    np.testing.assert_array_equal(te.labels_, je.labels_)
    assert te.n_iter_ == je.n_iter_ == (40 if tol == 0 else te.n_iter_)
    if tol:
        assert te.n_iter_ < 8


def test_kmeans_fp32_fused_matches_reference(blobs):
    je, te = _fit_both("kmeans", blobs, version="fp32", n_clusters=5,
                       max_iter=40, seed=3, tol=1e-4, fuse_steps=8)
    assert te.n_iter_ == je.n_iter_
    np.testing.assert_allclose(te.cluster_centers_, je.cluster_centers_,
                               rtol=1e-4, atol=1e-3)


def test_kmeans_fused_close_to_serial(blobs):
    """The fused update is float32 where the serial loop's is float64:
    held to the reference's own fused-against-serial tolerances."""
    fits = []
    for fuse in (1, 8):
        ts = make_system("pim", n_cores=CORES, device="cpu")
        fits.append(tkme.fit(ts.put(blobs), tkme.KMeansConfig(
            k=5, max_iters=40, seed=3, fuse_steps=fuse)))
    r1, rk = fits
    assert rk.inertia == pytest.approx(r1.inertia, rel=1e-4)
    assert rk.n_iters == r1.n_iters
    np.testing.assert_allclose(r1.centroids, rk.centroids, rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("batch", [32, 64])
@pytest.mark.parametrize("kind,reduce,extra", [
    ("pim", "fabric", {}),
    ("pim", "hierarchical", {"compress_flush": True}),
    ("pim", "host", {}),
    ("host", "fabric", {}),
])
def test_emb_int32_fused_matches_reference(batch, kind, reduce, extra,
                                           recsys):
    """Batches of 32 and 64 sit on both sides of the loss's 32-element
    reduce window."""
    je, te = _fit_both("emb", *recsys, kind=kind, reduce=reduce, cores=7,
                       version="int32", batch=batch, **EMB_PARAMS, **extra)
    jm, tm = je.result_.model, te.result_.model
    np.testing.assert_array_equal(tm.user_raw, jm.user_raw)
    np.testing.assert_array_equal(tm.item_raw, jm.item_raw)
    assert tm.history == jm.history and len(tm.history) == 3
    assert tm.n_flushes == jm.n_flushes == 3


def test_emb_fp32_fused_matches_reference(recsys):
    je, te = _fit_both("emb", *recsys, cores=7, version="fp32", batch=32,
                       **EMB_PARAMS)
    jm, tm = je.result_.model, te.result_.model
    for a, b in ((tm.user_raw, jm.user_raw), (tm.item_raw, jm.item_raw)):
        np.testing.assert_allclose(a, b, rtol=FP32_RTOL, atol=FP32_ATOL)
    np.testing.assert_allclose([h for _, h in tm.history],
                               [h for _, h in jm.history], rtol=FP32_RTOL)


def test_emb_fused_equals_serial_deferred(recsys):
    fits = []
    for fuse in (1, 3):
        ts = make_system("pim", n_cores=7, device="cpu")
        fits.append(temb.fit(ts.put(*recsys), temb.EmbConfig(
            version="int32", batch=32, **{**EMB_PARAMS,
                                          "fuse_steps": fuse})))
    serial, fused = fits
    np.testing.assert_array_equal(fused.user_raw, serial.user_raw)
    np.testing.assert_array_equal(fused.item_raw, serial.item_raw)
    assert fused.history == serial.history


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 100, 1100])
def test_batch_loss_sums_as_the_reference_compiles_it(n):
    """The loss of a fused chunk (one tensor op at a time, so a chunk
    graph can hold it) against XLA's CPU compile of ``jnp.sum(e * e)``,
    on both sides of its 32-element window and past 32 windows."""
    e = (np.random.RandomState(n).randn(n) * 3).astype(np.float32)
    ref = jax.jit(lambda v: jax.numpy.sum(v * v))(e)
    got = temb.batch_sq_error(torch.from_numpy(e))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == float(ref)


# ---------------------------------------------------------------------------
# Snapshots taken mid-pipeline resume the port's fused fit.
# ---------------------------------------------------------------------------

def _run(gen, n):
    for _ in range(n):
        tick = next(gen)
    return tick


def _drain(gen):
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            return stop.value


@pytest.mark.parametrize("source", ["port", "reference"])
def test_lin_minibatch_snapshot_resumes_fused(source, data):
    X, y = data["linreg"]
    params = dict(version="int32", n_iters=23, minibatch=9, seed=4,
                  fuse_steps=4, pipeline_depth=2, record_every=6)
    mod, cfg_cls, api = ((tlin, tlin.GdConfig, tapi) if source == "port"
                         else (jlin, jlin.GdConfig, japi))
    kw = {"device": "cpu"} if source == "port" else {}
    gen = mod.fit_steps(api.make_system("pim", n_cores=CORES, **kw).put(
        X, y), cfg_cls(**params))
    tick = _run(gen, 3)
    snap = tick.snapshot()
    gen.close()
    assert snap["meta"]["iters"] == 10 and "rng_mt_keys" in snap["arrays"]
    ds = make_system("pim", n_cores=CORES, device="cpu").put(X, y)
    full = tlin.fit(ds, tlin.GdConfig(**params))
    resumed = _drain(tlin.fit_steps(ds, tlin.GdConfig(**params),
                                    state=snap))
    np.testing.assert_array_equal(resumed.w, full.w)
    assert resumed.b == full.b


@pytest.mark.parametrize("source", ["port", "reference"])
def test_kmeans_snapshot_resumes_fused(source, blobs):
    params = dict(k=5, max_iters=40, seed=3, tol=0.0, n_init=2,
                  fuse_steps=8, pipeline_depth=2)
    mod, api = (tkme, tapi) if source == "port" else (jkme, japi)
    kw = {"device": "cpu"} if source == "port" else {}
    gen = mod.fit_steps(api.make_system("pim", n_cores=CORES, **kw).put(
        blobs), mod.KMeansConfig(**params))
    snap = _run(gen, 7).snapshot()      # 2 chunks into the second restart
    gen.close()
    assert snap["meta"]["init"] == 1 and snap["meta"]["it_sched"] == 16
    ds = make_system("pim", n_cores=CORES, device="cpu").put(blobs)
    full = tkme.fit(ds, tkme.KMeansConfig(**params))
    resumed = _drain(tkme.fit_steps(ds, tkme.KMeansConfig(**params),
                                    state=snap))
    np.testing.assert_array_equal(resumed.centroids, full.centroids)
    np.testing.assert_array_equal(resumed.labels, full.labels)
    assert resumed.n_iters == full.n_iters


@pytest.mark.parametrize("source", ["port", "reference"])
def test_emb_snapshot_resumes_fused(source, recsys):
    params = dict(EMB_PARAMS, version="int32", batch=32, fuse_steps=3,
                  n_iters=22)
    mod, api = (temb, tapi) if source == "port" else (jemb, japi)
    kw = {"device": "cpu"} if source == "port" else {}
    gen = mod.fit_steps(api.make_system("pim", n_cores=7, **kw).put(
        *recsys), mod.EmbConfig(**params))
    snap = _run(gen, 4).snapshot()      # chunks 3, 3, 2, 3: mid-window
    gen.close()
    assert snap["meta"]["iters"] == 11
    assert snap["meta"]["pend_u_batches"] == 3
    ds = make_system("pim", n_cores=7, device="cpu").put(*recsys)
    full = temb.fit(ds, temb.EmbConfig(**params))
    resumed = _drain(temb.fit_steps(ds, temb.EmbConfig(**params),
                                    state=snap))
    np.testing.assert_array_equal(resumed.user_raw, full.user_raw)
    np.testing.assert_array_equal(resumed.item_raw, full.item_raw)
    assert resumed.history == full.history


# ---------------------------------------------------------------------------
# The launcher.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workload", ["linreg", "logreg", "kmeans", "emb"])
def test_launcher_takes_fuse_steps(workload, capsys):
    pim_ml.main(["--workload", workload, "--device", "cpu", "--samples",
                 "600", "--features", "4", "--iters", "9", "--cores", "4",
                 "--fuse-steps", "4", "--versions",
                 {"linreg": "int32", "logreg": "int32_lut_wram",
                  "kmeans": "int16", "emb": "int32"}[workload]]
                + (["--param", "flush_every=4"] if workload == "emb"
                   else []))
    out = capsys.readouterr().out
    assert f"session: {workload} on pim (4 cores" in out


def test_launcher_refuses_fuse_steps_for_dtree(capsys):
    with pytest.raises(SystemExit):
        pim_ml.main(["--workload", "dtree", "--device", "cpu",
                     "--samples", "100", "--fuse-steps", "4"])
    assert "step fusion" in capsys.readouterr().err
