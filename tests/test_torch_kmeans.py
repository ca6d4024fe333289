"""K-Means training through the port against the JAX package.

Both packages fit ``make_estimator("kmeans", ...)`` on the same
numpy-seeded blobs, on ``pim`` at several core counts (7 and 16 pad the
last shard) and on ``host``, under every reduce strategy.  The int16
version must give identical centroids, labels and iteration counts and
equal ``TransferStats``: the assignment and the sums are integers, the
host update is the same float64 numpy.

The int16 inertia is a float32 sum of exact int32 minima over each
shard, taken in another order by XLA and by ATen, so it is held to
``INERTIA_RTOL``.  The fp32 version's distances and one-hot sums are
float32 matmuls whose summation order differs too: its centroids are
held to ``FP32_RTOL``/``FP32_ATOL``, its labels must agree on all but
``FP32_LABEL_FLIPS`` points (none flipped in these runs), and its
inertia, whose ``||x||^2 - 2 x.c + ||c||^2`` cancels to a few float32
ULPs of ``||x||^2`` per point, to ``FP32_INERTIA_RTOL``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import kmeans as jkme
from repro.data import synthetic as jsyn

import repro_torch.api as tapi
from repro_torch.core import kmeans as tkme
from repro_torch.core import metrics as tmetrics
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import dispatch

INERTIA_RTOL = 1e-6
FP32_INERTIA_RTOL = 1e-5
FP32_RTOL, FP32_ATOL = 1e-5, 1e-4
FP32_LABEL_FLIPS = 0
SYSTEMS = [("pim", 1), ("pim", 7), ("pim", 16), ("host", 8)]
PARAMS = {"n_clusters": 6, "max_iter": 8, "tol": 1e-4}


@pytest.fixture(scope="module")
def blobs():
    X, _, _ = tsyn.make_blobs(1500, 5, centers=6, seed=4)
    return X


def _fit_both(version, kind, n_cores, X, reduce="fabric", **params):
    js = japi.make_system(kind, n_cores=n_cores, reduce=reduce)
    ts = tapi.make_system(kind, n_cores=n_cores, reduce=reduce, device="cpu")
    p = {**PARAMS, **params}
    je = japi.make_estimator("kmeans", version=version, system=js,
                             **p).fit(X)
    te = tapi.make_estimator("kmeans", version=version, system=ts,
                             **p).fit(X)
    return je, te, js, ts


def _assert_same_fit(je, te, js, ts, version):
    assert te.cluster_centers_.dtype == np.float32
    assert te.labels_.shape == je.labels_.shape
    if version == "int16":
        np.testing.assert_array_equal(te.cluster_centers_,
                                      je.cluster_centers_)
        np.testing.assert_array_equal(te.labels_, je.labels_)
    else:
        np.testing.assert_allclose(te.cluster_centers_, je.cluster_centers_,
                                   rtol=FP32_RTOL, atol=FP32_ATOL)
        assert int(np.sum(te.labels_ != je.labels_)) <= FP32_LABEL_FLIPS
    assert te.n_iter_ == je.n_iter_
    np.testing.assert_allclose(
        te.inertia_, je.inertia_,
        rtol=INERTIA_RTOL if version == "int16" else FP32_INERTIA_RTOL)
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)


def test_blobs_and_metrics_identical():
    for a, b in zip(tsyn.make_blobs(700, 5, centers=6, seed=4),
                    jsyn.make_blobs(700, 5, centers=6, seed=4)):
        np.testing.assert_array_equal(a, b)
    from repro.core import metrics as jmetrics
    rng = np.random.RandomState(0)
    a, b = rng.randint(0, 5, 300), rng.randint(0, 4, 300)
    assert tmetrics.adjusted_rand_index(a, b) == \
        jmetrics.adjusted_rand_index(a, b)
    c0, c1 = rng.normal(size=(6, 5)), rng.normal(size=(6, 5))
    assert tmetrics.frobenius_shift(c0, c1) == \
        jmetrics.frobenius_shift(c0, c1)


@pytest.mark.parametrize("kind,n_cores", SYSTEMS)
@pytest.mark.parametrize("version", ["int16", "fp32"])
def test_kmeans_matches_reference(version, kind, n_cores, blobs):
    _assert_same_fit(*_fit_both(version, kind, n_cores, blobs), version)


@pytest.mark.parametrize("reduce", ["host", "hierarchical",
                                    "hierarchical-auto"])
@pytest.mark.parametrize("version", ["int16", "fp32"])
def test_reduce_strategies_match_reference(version, reduce, blobs):
    _assert_same_fit(*_fit_both(version, "pim", 16, blobs, reduce=reduce),
                     version)


@pytest.mark.parametrize("kind,n_cores", [("pim", 7), ("host", 8)])
def test_restarts_draw_the_reference_init(kind, n_cores, blobs):
    """n_init=2 draws both restarts from the same MT19937 stream and
    keeps the same best clustering."""
    _assert_same_fit(*_fit_both("int16", kind, n_cores, blobs, n_init=2,
                                seed=3, tol=0.0), "int16")


def test_reference_kernel_backend_gives_the_same_fit(blobs):
    """The reference's Pallas kernel (interpret mode) and its jnp oracle
    fit what the port's plain version fits."""
    je, te, js, ts = _fit_both("int16", "pim", 7, blobs)
    jk = japi.make_estimator("kmeans", version="int16", system=js,
                             kernel_backend="pallas_interpret",
                             **PARAMS).fit(blobs)
    np.testing.assert_array_equal(te.cluster_centers_, jk.cluster_centers_)
    np.testing.assert_array_equal(te.labels_, jk.labels_)


def _run(gen, k=None):
    """Advance a fit_steps generator k steps (None: to the end)."""
    tick = None
    for _ in range(k if k is not None else 1 << 30):
        try:
            tick = next(gen)
        except StopIteration as stop:
            return stop.value
    return tick


@pytest.mark.parametrize("source", ["reference", "port"])
@pytest.mark.parametrize("steps", [3, 10])
def test_snapshot_resumes_to_the_uninterrupted_fit(source, steps, blobs):
    """A snapshot taken mid-fit (step 3: inside the first restart; step
    10: inside the second, with a best-so-far) resumes in the port and
    ends where the uninterrupted fit ends, bit for bit."""
    cfg = dict(k=6, max_iters=8, tol=1e-4, n_init=2, seed=1)
    js = japi.make_system("pim", n_cores=7)
    ts = tapi.make_system("pim", n_cores=7, device="cpu")
    jds, tds = js.put(blobs), ts.put(blobs)
    full = jkme.fit(jds, jkme.KMeansConfig(**cfg))
    if source == "reference":
        gen = jkme.fit_steps(jds, jkme.KMeansConfig(**cfg))
    else:
        gen = tkme.fit_steps(tds, tkme.KMeansConfig(**cfg))
    tick = _run(gen, steps)
    assert tick == 1 and tick.resumable
    snap = tick.snapshot()
    gen.close()
    # a restart takes at most max_iters=8 steps: step 10 is past the first
    assert snap["meta"]["has_best"] == (steps == 10)
    resumed = _run(tkme.fit_steps(tds, tkme.KMeansConfig(**cfg),
                                  state=snap))
    np.testing.assert_array_equal(resumed.centroids, full.centroids)
    np.testing.assert_array_equal(resumed.labels, full.labels)
    assert resumed.n_iters == full.n_iters
    np.testing.assert_allclose(resumed.inertia, full.inertia,
                               rtol=INERTIA_RTOL)


def test_views_kernels_and_quantization_match_the_reference(blobs):
    js = japi.make_system("pim", n_cores=7)
    ts = tapi.make_system("pim", n_cores=7, device="cpu")
    jds, tds = js.put(blobs), ts.put(blobs)
    for version in ("int16", "fp32"):
        jv, tv = jds.kmeans_view(version), tds.kmeans_view(version)
        np.testing.assert_array_equal(tv.shards.numpy(),
                                      np.asarray(jv.shards))
        np.testing.assert_array_equal(tv.mask.numpy(), np.asarray(jv.mask))
        np.testing.assert_array_equal(tv.host_q, jv.host_q)
        assert tv.scale == jv.scale and tv.scale.dtype == np.float32
        assert tds.kmeans_view(version) is tv        # cached
    assert sorted(tds._views) == sorted(jds._views)
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)
    for version in ("int16", "fp32"):
        tapi.make_estimator("kmeans", version=version, system=ts,
                            **PARAMS).fit(tds)
    assert ts.registered_kernels() == (
        "kme.assign/fp32/k6", "kme.assign/k6", "kme.inertia/fp32/k6",
        "kme.inertia/k6", "kme.labels/fp32/k6", "kme.labels/k6")


def test_estimator_surface(blobs):
    ts = tapi.make_system("host", device="cpu")
    est = tapi.make_estimator("kme", system=ts, **PARAMS).fit(blobs, None)
    assert est.version == "int16" and est.workload.name == "kmeans"
    assert est.cluster_centers_.shape == (6, 5)
    np.testing.assert_array_equal(est.predict(blobs[:50]),
                                  est.predict(blobs[:50]))
    assert est.score(blobs) < 0
    ds = ts.put(blobs)
    assert ds.y is None
    assert tapi.get_workload("kmeans").unsupervised
    assert tapi.get_workload("kmeans").resumable
    assert not tapi.get_workload("dtree").resumable
    assert sorted(tapi.list_workloads()) == ["dtree", "emb", "kmeans",
                                             "linreg", "logreg"]


def test_step_fusion_is_refused_until_ported(blobs):
    """Step fusion runs: a fused int16 fit stops at the serial fit's
    iteration and lands on its centroids (the fused update is float32,
    the serial one float64)."""
    fits = {}
    for fuse in (1, 8):
        ts = tapi.make_system("pim", n_cores=4, device="cpu")
        fits[fuse] = tapi.make_estimator("kmeans", fuse_steps=fuse,
                                         system=ts, **PARAMS).fit(blobs)
    assert fits[8].n_iter_ == fits[1].n_iter_
    np.testing.assert_allclose(fits[8].cluster_centers_,
                               fits[1].cluster_centers_, rtol=1e-4,
                               atol=1e-3)


def test_cpu_fit_counts_no_kernel_launches(blobs):
    dispatch.reset_launch_counts()
    ts = tapi.make_system("pim", n_cores=4, device="cpu")
    tapi.make_estimator("kmeans", system=ts, **PARAMS).fit(blobs)
    assert dispatch.launch_counts == {}
    assert isinstance(ts.put(blobs).kmeans_view().shards, torch.Tensor)


@pytest.mark.parametrize("version", ["int16", "fp32"])
def test_pad_rows_are_taken_out_of_the_counts(version, blobs):
    """7 cores pad the last shard (1500 = 7 * 215 - 5): the all-zero pad
    rows count at the zero vector's label, the first argmin of the
    centroids' squared norms (two centroids tie on the least norm here),
    and the assignment kernel takes them out, leaving the counts of the
    valid rows."""
    ts = tapi.make_system("pim", n_cores=7, device="cpu")
    view = ts.put(blobs).kmeans_view(version)
    valid = view.mask
    assert int((~valid).sum()) == valid.numel() - blobs.shape[0] == 5
    rng = np.random.RandomState(1)
    c = rng.randint(-40, 41, (6, 5))
    c[3], c[5] = [1, 2, 0, 0, 0], [0, 0, 2, 1, 0]          # least norm: 5
    cq = torch.from_numpy(c.astype(np.int16 if version == "int16"
                                   else np.float32))
    out = tkme._assign_kernel_factory(6, version == "int16")(view.shards,
                                                            valid, cq)
    x = view.shards.to(torch.float64)
    d = (torch.sum(cq.double() ** 2, dim=1)
         - 2 * torch.einsum("cnf,kf->cnk", x, cq.double()))
    labels = torch.argmin(d, dim=-1)[valid]
    assert int(torch.argmin(d, dim=-1)[~valid].unique()) == 3
    np.testing.assert_array_equal(out["counts"].sum(0).numpy(),
                                  np.bincount(labels.numpy(), minlength=6))
    _assert_same_fit(*_fit_both(version, "pim", 7, blobs), version)
