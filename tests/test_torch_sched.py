"""The port's job scheduler, manifests and ``pim_jobs`` against the JAX
package's.

Every case drives the same scenario through both packages on the CPU,
on the same numpy-seeded data, and holds the port to the reference:
the state of every job after every scheduling turn (so admission order,
eviction, backfill and placement), leases, steps and iterations,
``TransferStats`` deltas, modeled seconds as floats, the metrics
counters, ``stats()`` and ``job_report`` without their wall-clock
fields, ``capacity_estimate``, fingerprints and ``queue.json``.  Results
are bit-identical for the integer versions (weights, int16 centroids and
labels, trees); fp32 weights are held to ``FP32_RTOL``/``FP32_ATOL`` and
the int16 inertia (a float32 sum in another order) to ``INERTIA_RTOL``,
the tolerances of ``tests/test_torch_train.py`` and
``tests/test_torch_kmeans.py``.  The reference's own assertions run on
both sides.

Covered case for case: the scheduler and manifest cases of the
reference's ``tests/test_sched.py``, the scheduler cases of
``tests/test_elastic.py`` and ``tests/test_obs.py`` (per-slice
attribution, traces, drift), and the CLI: ``pim_jobs.main`` on
``examples/jobs.yaml``, and a checkpoint directory written by either
package's ``pim_jobs`` resumed by the other's.

The reference's ``mul_round_f32`` calls ``jax.experimental.enable_x64``,
which this JAX no longer has; :func:`x64_alias` aliases it for this
file's tests only.
"""
import dataclasses
import json
import os
import shutil

import jax
import jax.experimental
import numpy as np
import pytest

import repro.api as japi
import repro.elastic as jelastic
import repro.sched as jsched
from repro.data import synthetic as jsyn
from repro.launch import pim_jobs as jjobs
from repro.obs import DRIFT_BUCKETS as JDRIFT_BUCKETS
from repro.obs import TRACER as JTRACER

import repro_torch.api as tapi
import repro_torch.elastic as telastic
import repro_torch.sched as tsched
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import pim_jobs as tjobs
from repro_torch.obs import DRIFT_BUCKETS as TDRIFT_BUCKETS
from repro_torch.obs import TRACER as TTRACER
from repro_torch.obs import to_chrome_trace, validate_chrome_trace

FP32_RTOL, FP32_ATOL = 1e-5, 1e-6
INERTIA_RTOL, FP32_INERTIA_RTOL = 1e-6, 1e-5
TREE_FIELDS = ("feature", "threshold", "left", "right", "leaf_class",
               "depth")
EXAMPLE = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                       "jobs.yaml")


@pytest.fixture(scope="module", autouse=True)
def x64_alias():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        yield


class Pkg:
    """One package's surface, so a scenario is written once."""

    def __init__(self, port: bool):
        self.port = port
        self.name = "port" if port else "reference"
        self.api = tapi if port else japi
        self.sched = tsched if port else jsched
        self.elastic = telastic if port else jelastic
        self.jobs = tjobs if port else jjobs
        self.tracer = TTRACER if port else JTRACER
        self.drift_buckets = TDRIFT_BUCKETS if port else JDRIFT_BUCKETS
        self.dev = {"device": "cpu"} if port else {}

    def system(self, kind="pim", n_cores=8, **kw):
        return self.api.make_system(kind, n_cores=n_cores, **kw, **self.dev)

    def scheduler(self, cores=8, rank=4, kind="pim", **kw):
        return self.sched.PimScheduler(self.system(kind, cores),
                                       rank_size=rank, **kw)

    def run_manifest(self, doc, **kw):
        return self.sched.run_manifest(doc, **kw, **self.dev)

    def cli(self, argv):
        return self.jobs.main(list(argv)
                              + (["--device", "cpu"] if self.port else []))

    def __repr__(self):
        return self.name


REF, PORT = Pkg(False), Pkg(True)


def both(scenario, *args, **kwargs):
    """The scenario's record through the reference, then the port."""
    return scenario(REF, *args, **kwargs), scenario(PORT, *args, **kwargs)


# ---------------------------------------------------------------------------
# Comparable views of handles, results and reports.
# ---------------------------------------------------------------------------

def handle_sig(h) -> dict:
    """Everything on a handle that does not depend on the wall clock."""
    return {
        "id": h.id, "name": h.name, "workload": h.workload.name,
        "version": h.spec.version,
        "params": {k: v for k, v in h.spec.params.items()
                   if k != "kernel_backend"},
        "state": h.state.value, "steps": h.steps, "iters": h.iters,
        "cores": h.n_cores, "priority": h.priority, "target": h.target,
        "fused": h.fused,
        "lease": None if h.lease is None else (h.lease.start,
                                               h.lease.n_cores),
        "preemptions": h.preemptions, "recoveries": h.recoveries,
        "restored": h.restored, "retry_budget": h.retry_budget,
        "modeled_seconds": h.modeled_seconds, "chunks": h.drift.count,
        "transfer": (None if h.transfer is None
                     else dataclasses.asdict(h.transfer)),
        "gpu": None if h.gpu is None else (h.gpu.launches,),
        "error": None if h.error is None else type(h.error).__name__,
        "snapshot_kind": h.snapshot_kind, "fingerprint": h.fingerprint,
        "has_deadline": h.deadline is not None,
        "started": h.started_at is not None,
        "finished": h.finished_at is not None,
    }


def turn_sig(sched) -> list:
    return [(h.name, h.state.value, h.steps, h.iters,
             None if h.lease is None else (h.lease.start, h.lease.n_cores))
            for h in sched.handles]


def drain_log(sched) -> list:
    """``drain()`` one turn at a time, every job's state after each."""
    log = []
    while True:
        more = sched.step()
        log.append(turn_sig(sched))
        if not more:
            return log


def admission_order(handles) -> list:
    started = [h for h in handles if h.started_at is not None]
    return [h.name for h in sorted(started, key=lambda h: h.started_at)]


def assert_same_result(got, want, version):
    """``FitResult`` attributes: integer versions bit for bit, fp32 to
    the stated tolerances."""
    if want is None:
        assert got is None
        return
    ga, wa = dict(got.attributes), dict(want.attributes)
    assert sorted(ga) == sorted(wa)
    for key, w in wa.items():
        g = ga[key]
        if key == "tree_":
            for f in TREE_FIELDS:
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                              err_msg=f)
        elif key == "inertia_":
            np.testing.assert_allclose(
                g, w, rtol=INERTIA_RTOL if version == "int16"
                else FP32_INERTIA_RTOL)
        elif version == "fp32" and key in ("coef_", "intercept_",
                                           "cluster_centers_"):
            np.testing.assert_allclose(g, w, rtol=FP32_RTOL, atol=FP32_ATOL)
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=key)


def assert_same_handles(ref_handles, port_handles):
    assert len(port_handles) == len(ref_handles)
    for r, p in zip(ref_handles, port_handles):
        rs, ps = handle_sig(r), handle_sig(p)
        diff = {k: (ps[k], rs[k]) for k in rs if ps[k] != rs[k]}
        assert not diff, f"{r.name}: (port, reference) {diff}"
    for r, p in zip(ref_handles, port_handles):
        assert_same_result(p.result, r.result, r.spec.version)


def stats_sig(stats: dict) -> dict:
    """``stats()`` without the wall-clock fields."""
    out = {k: v for k, v in stats.items()
           if k not in ("drift", "latency", "metrics", "straggler_flags")}
    out["drift"] = {name: {"modeled_seconds": d["modeled_seconds"],
                           "chunks": d["chunks"]}
                    for name, d in stats["drift"].items()}
    out["metrics"] = {
        name: (m if not isinstance(m, dict) else
               {k: v for k, v in m.items()
                if k in ("count", "bounds")})
        for name, m in stats["metrics"].items()}
    lat = stats["latency"]
    out["latency"] = (lat["queue"]["count"], lat["completion"]["count"],
                      lat["deadline_misses"])
    return out


def assert_same(port, ref, what=""):
    """Equal nested records, naming the first paths that differ."""
    diffs = []

    def walk(a, b, path):
        if isinstance(a, dict) and isinstance(b, dict):
            for k in sorted(set(a) | set(b), key=str):
                walk(a.get(k, "<missing>"), b.get(k, "<missing>"),
                     f"{path}.{k}")
        elif (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))
              and len(a) == len(b)):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
        elif a != b:
            diffs.append(f"{path}: port {a!r}, reference {b!r}")

    walk(port, ref, what)
    assert not diffs, "\n".join(diffs[:12])


def report_sig(rows: list) -> list:
    return [{k: v for k, v in row.items()
             if k not in ("measured_seconds", "drift_ratio",
                          "straggler_flags")}
            for row in rows]


@pytest.fixture(scope="module")
def lin():
    X, y, _ = jsyn.make_linear_dataset(256, 8, seed=0)
    return X, y


@pytest.fixture(scope="module")
def blobs():
    X, _, _ = jsyn.make_blobs(256, 4, centers=4, seed=1)
    return X


def _regression(n=96, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X @ rng.randn(f) + 0.1 * rng.randn(n)).astype(np.float32)
    return X, y


def _blobs96(n=96, f=4, seed=3):
    rng = np.random.RandomState(seed)
    centers = rng.randn(4, f).astype(np.float32) * 4
    X = (centers[rng.randint(0, 4, n)]
         + rng.randn(n, f).astype(np.float32))
    return X.astype(np.float32), None


def test_synthetic_data_identical():
    for a, b in zip(tsyn.make_linear_dataset(192, 6, seed=0),
                    jsyn.make_linear_dataset(192, 6, seed=0)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tsyn.make_blobs(256, 4, centers=4, seed=1),
                    jsyn.make_blobs(256, 4, centers=4, seed=1)):
        np.testing.assert_array_equal(a, b)


def test_exports_match_reference():
    assert tsched.__all__ == jsched.__all__
    assert [s.value for s in tsched.JobState] == [
        s.value for s in jsched.JobState]
    assert [s.terminal for s in tsched.JobState] == [
        s.terminal for s in jsched.JobState]
    assert [c.key for c in tjobs.JOB_COLUMNS] == [
        c.key for c in jjobs.JOB_COLUMNS]
    assert tjobs.DEMO_MANIFEST == jjobs.DEMO_MANIFEST


# ---------------------------------------------------------------------------
# reference tests/test_sched.py: the queue.
# ---------------------------------------------------------------------------

def test_disjoint_slices_bit_identical_to_whole_mesh():
    X, y, _ = jsyn.make_linear_dataset(512, 8, seed=0)
    Xb, _, _ = jsyn.make_blobs(512, 4, centers=4, seed=1)

    def scenario(P):
        system = P.system("pim", 16)
        sched = P.sched.PimScheduler(system, rank_size=4)
        h_lin = sched.submit("linreg", (X, y), version="int32", n_iters=15,
                             n_cores=4)
        h_kme = sched.submit("kmeans", Xb, n_clusters=4, max_iter=8,
                             n_cores=8)
        log = drain_log(sched)
        assert h_lin.state is P.sched.JobState.DONE
        assert h_kme.state is P.sched.JobState.DONE
        assert h_lin.lease.stop <= h_kme.lease.start \
            or h_kme.lease.stop <= h_lin.lease.start
        ref = P.system("pim", 16)
        ref_lin = P.api.make_estimator("linreg", version="int32", n_iters=15,
                                       system=ref).fit(ref.put(X, y))
        ref_kme = P.api.make_estimator("kmeans", n_clusters=4, max_iter=8,
                                       system=ref).fit(Xb)
        assert np.array_equal(h_lin.result.attributes["coef_"],
                              ref_lin.coef_)
        assert h_lin.result.attributes["intercept_"] == ref_lin.intercept_
        assert np.array_equal(h_kme.result.attributes["cluster_centers_"],
                              ref_kme.cluster_centers_)
        assert np.array_equal(h_kme.result.attributes["labels_"],
                              ref_kme.labels_)
        assert h_kme.result.attributes["inertia_"] \
            == pytest.approx(ref_kme.inertia_, rel=1e-6)
        return sched, log

    (rs, rlog), (ps, plog) = both(scenario)
    assert plog == rlog
    assert_same_handles(rs.handles, ps.handles)
    assert_same(stats_sig(ps.stats()), stats_sig(rs.stats()), "stats")


def test_mixed_queue_drains_with_per_job_deltas_and_isolation(lin, blobs):
    X, y = lin
    Xb = blobs
    n_iters = 12

    def scenario(P):
        system = P.system("pim", 16)
        sched = P.sched.PimScheduler(system, rank_size=4)
        handles = [
            sched.submit("linreg", (X, y), version="int32", n_iters=n_iters),
            sched.submit("linreg", (X, y), version="hyb", n_iters=n_iters),
            sched.submit("logreg", (X, y), version="int32", n_iters=n_iters),
            sched.submit("kmeans", Xb, n_clusters=4, max_iter=10),
            sched.submit("kmeans", Xb[:3], n_clusters=8, name="poison"),
            sched.submit("logreg", (X, y), version="int32_lut_wram",
                         n_iters=n_iters),
            sched.submit("linreg", (X, y), version="fp32", n_iters=n_iters),
            sched.submit("kmeans", Xb, n_clusters=4, max_iter=10, seed=7),
        ]
        log = drain_log(sched)
        poison = handles[4]
        assert poison.state is P.sched.JobState.FAILED
        assert isinstance(poison.error, ValueError)
        others = [h for h in handles if h is not poison]
        assert all(h.state is P.sched.JobState.DONE for h in others)
        for h in handles[:3] + [handles[5], handles[6]]:
            assert h.transfer.kernel_launches == n_iters
            assert h.transfer.shard_transfers == 2
        for h in (handles[3], handles[7]):
            assert h.transfer.kernel_launches == h.steps + 2
            assert h.transfer.shard_transfers == 1
        assert sum(h.transfer.cpu_to_pim for h in handles) \
            == system.stats.cpu_to_pim
        assert sum(h.transfer.kernel_launches for h in handles) \
            == system.stats.kernel_launches
        assert all(h.modeled_seconds > 0 for h in others)
        frag = sched.fragmentation()
        assert frag.free_cores == 16 and frag.n_free_extents == 1
        return sched, log, dataclasses.asdict(system.stats)

    (rs, rlog, rstats), (ps, plog, pstats) = both(scenario)
    assert plog == rlog
    assert pstats == rstats
    assert_same_handles(rs.handles, ps.handles)
    assert_same(stats_sig(ps.stats()), stats_sig(rs.stats()), "stats")
    assert report_sig(tsched.job_report(ps.handles)) == report_sig(
        jsched.job_report(rs.handles))


def test_gang_round_robin_interleaves_concurrent_jobs():
    X, y, _ = jsyn.make_linear_dataset(256, 4, seed=0)

    def scenario(P):
        sched = P.scheduler(8, 4)
        a = sched.submit("linreg", (X, y), version="int32", n_iters=6)
        b = sched.submit("linreg", (X, y), version="int32", n_iters=6)
        sched.step()
        assert a.state is P.sched.JobState.RUNNING
        assert b.state is P.sched.JobState.RUNNING
        assert a.steps == 1 and b.steps == 1
        log = [turn_sig(sched)] + drain_log(sched)
        assert np.array_equal(a.result.attributes["coef_"],
                              b.result.attributes["coef_"])
        return sched, log

    (rs, rlog), (ps, plog) = both(scenario)
    assert plog == rlog
    assert_same_handles(rs.handles, ps.handles)


def test_priority_admission_order():
    X, y, _ = jsyn.make_linear_dataset(128, 4, seed=0)

    def scenario(P):
        sched = P.scheduler(4, 4)
        low = sched.submit("linreg", (X, y), version="int32", n_iters=4,
                           priority=0)
        high = sched.submit("linreg", (X, y), version="int32", n_iters=4,
                            priority=5)
        sched.step()
        assert high.state is P.sched.JobState.RUNNING
        assert low.state is P.sched.JobState.QUEUED
        log = [turn_sig(sched)] + drain_log(sched)
        assert admission_order(sched.handles) == [high.name, low.name]
        return sched, log

    (rs, rlog), (ps, plog) = both(scenario)
    assert plog == rlog
    assert_same_handles(rs.handles, ps.handles)


def test_cancel_queued_and_running():
    X, y, _ = jsyn.make_linear_dataset(128, 4, seed=0)

    def scenario(P):
        sched = P.scheduler(4, 4)
        running = sched.submit("linreg", (X, y), version="int32",
                               n_iters=50)
        queued = sched.submit("linreg", (X, y), version="int32", n_iters=50)
        sched.step()
        queued.cancel()
        assert queued.state is P.sched.JobState.CANCELLED
        running.cancel()
        log = drain_log(sched)
        assert running.state is P.sched.JobState.CANCELLED
        assert running.steps < 50
        assert sched.fragmentation().free_cores == 4
        return sched, log

    (rs, rlog), (ps, plog) = both(scenario)
    assert plog == rlog
    assert_same_handles(rs.handles, ps.handles)


def test_unschedulable_job_rejected_at_submit():
    X, y, _ = jsyn.make_linear_dataset(64, 4, seed=0)
    for P in (REF, PORT):
        sched = P.scheduler(8, 4)
        with pytest.raises(ValueError, match="rank-aligned"):
            sched.submit("linreg", (X, y), version="int32", n_cores=12)
        with pytest.raises(ValueError, match="unknown target"):
            sched.submit("linreg", (X, y), version="int32", target="gpu")
        with pytest.raises(TypeError, match="either spec"):
            sched.submit("linreg", (X, y),
                         spec=P.api.get_workload("linreg").spec(),
                         version="int32")
        with pytest.raises(ValueError, match="data tuple"):
            sched.submit("linreg", (X, y, y), version="int32")
        assert sched.handles == []


def test_custom_workload_default_macro_step():
    def scenario(P):
        class OneShot(P.api.Workload):
            name = "oneshot"
            versions = ("v0",)
            defaults = {}

            def fit(self, dataset, spec):
                return P.api.FitResult(spec, {"n": dataset.n}, {})

        sched = P.scheduler(8, 4)
        h = sched.submit(OneShot(), np.zeros((16, 2), np.float32))
        log = drain_log(sched)
        assert h.state is P.sched.JobState.DONE
        assert h.steps == 1
        assert h.result.model == {"n": 16}
        with pytest.raises(ValueError, match="not resumable"):
            next(OneShot().fit_steps(None, OneShot().spec(), state={}))
        return log, handle_sig(h)

    ref, port = both(scenario)
    assert port == ref


def test_fuse_key_eligibility():
    for P in (REF, PORT):
        lin = P.api.get_workload("linreg")
        kme = P.api.get_workload("kmeans")
        s1 = lin.spec("int32", lr=0.1, n_iters=50)
        s2 = lin.spec("int32", lr=0.5, n_iters=50)
        s3 = lin.spec("hyb", lr=0.1, n_iters=50)
        s4 = lin.spec("int32", lr=0.1, n_iters=50, minibatch=8)
        assert P.sched.fuse_key(lin, s1) == P.sched.fuse_key(lin, s2)
        assert P.sched.fuse_key(lin, s1) != P.sched.fuse_key(lin, s3)
        assert P.sched.fuse_key(lin, s4) is None
        assert P.sched.fuse_key(kme, kme.spec()) is None
        assert P.sched.plan_fusion(lin, [s1, s2, s3, s4]) == [[0, 1], [2],
                                                              [3]]


@pytest.mark.parametrize("fuse_steps", [1, 5])
def test_fused_sweep_one_launch_per_step_matches_unfused(fuse_steps):
    X, y, _ = jsyn.make_linear_dataset(512, 8, seed=0)
    lrs = [0.02, 0.04, 0.06, 0.08, 0.1, 0.15, 0.2, 0.3]
    n_iters = 25

    def scenario(P):
        system = P.system("pim", 8)
        sched = P.sched.PimScheduler(system, rank_size=8)
        snap = system.stats.snapshot()
        fused = sched.sweep("linreg", (X, y), {"lr": lrs}, version="int32",
                            n_iters=n_iters, fused=True,
                            fuse_steps=fuse_steps)
        log = drain_log(sched)
        assert all(h.state is P.sched.JobState.DONE and h.fused
                   for h in fused)
        delta = system.stats.delta(snap)
        chunks = -(-n_iters // fuse_steps)     # a chunk is one launch
        assert fused[0].steps == chunks
        assert delta.kernel_launches == chunks
        assert fused[0].transfer.kernel_launches == chunks
        assert delta.shard_transfers == 2
        unfused = sched.sweep("linreg", (X, y), {"lr": lrs},
                              version="int32", n_iters=n_iters,
                              fused=False)
        log += drain_log(sched)
        assert sum(h.transfer.kernel_launches for h in unfused) \
            == n_iters * len(lrs)
        for hf, hu in zip(fused, unfused):
            assert np.array_equal(hf.result.attributes["coef_"],
                                  hu.result.attributes["coef_"])
            assert hf.result.attributes["intercept_"] \
                == hu.result.attributes["intercept_"]
        return sched, log

    (rs, rlog), (ps, plog) = both(scenario)
    assert plog == rlog
    assert_same_handles(rs.handles, ps.handles)
    assert_same(stats_sig(ps.stats()), stats_sig(rs.stats()), "stats")


def test_fused_sweep_logreg_and_lane_cancel():
    X, y, _ = jsyn.make_linear_dataset(512, 8, seed=1)
    lrs = [1.0, 2.0, 4.0]

    def scenario(P):
        sched = P.scheduler(8, 8)
        fused = sched.sweep("logreg", (X, y), {"lr": lrs},
                            version="int32_lut_wram", n_iters=20,
                            fused=True)
        sched.step()
        fused[1].cancel()
        log = drain_log(sched)
        assert fused[0].state is P.sched.JobState.DONE
        assert fused[1].state is P.sched.JobState.CANCELLED
        assert fused[2].state is P.sched.JobState.DONE
        ref = sched.sweep("logreg", (X, y), {"lr": [lrs[0]]},
                          version="int32_lut_wram", n_iters=20, fused=False)
        log += drain_log(sched)
        assert np.array_equal(fused[0].result.attributes["coef_"],
                              ref[0].result.attributes["coef_"])
        return sched, log

    (rs, rlog), (ps, plog) = both(scenario)
    assert plog == rlog
    assert_same_handles(rs.handles, ps.handles)


@pytest.mark.parametrize("policy", ["fifo", "deadline"])
@pytest.mark.parametrize("placement", ["first_fit", "contention"])
@pytest.mark.parametrize("backfill", [False, True])
def test_large_k_mixed_queue_admission(policy, placement, backfill):
    """The reference's K=16 mixed queue on a fragmented machine, under
    each policy, placement and backfill: the same admission order,
    leases and results turn by turn."""
    X, y, _ = jsyn.make_linear_dataset(256, 4, seed=0)
    Xb, _, _ = jsyn.make_blobs(256, 4, centers=4, seed=2)

    def scenario(P):
        sched = P.scheduler(16, 4, backfill=backfill, policy=policy,
                            placement=placement)
        handles = []
        for i in range(16):
            deadline = (None if i % 5 == 0 else 10.0 * (16 - i))
            if i % 4 == 3:
                handles.append(sched.submit(
                    "kmeans", Xb, n_clusters=4, max_iter=8, n_cores=8,
                    deadline_seconds=deadline))
            else:
                handles.append(sched.submit(
                    "linreg", (X, y), version="int32", n_iters=8,
                    n_cores=4, priority=i % 3, deadline_seconds=deadline))
        log = drain_log(sched)
        assert all(h.state is P.sched.JobState.DONE for h in handles)
        frag = sched.fragmentation()
        assert frag.free_cores == 16 and frag.n_free_extents == 1
        return sched, log

    (rs, rlog), (ps, plog) = both(scenario)
    assert plog == rlog
    assert admission_order(ps.handles) == admission_order(rs.handles)
    assert_same_handles(rs.handles, ps.handles)
    assert_same(stats_sig(ps.stats()), stats_sig(rs.stats()), "stats")


def test_manifest_runs_jobs_and_fused_sweep():
    doc = {
        "system": {"cores": 8, "rank_size": 4},
        "datasets": {
            "lin": {"kind": "linear", "samples": 256, "features": 8,
                    "seed": 0},
            "blobs": {"kind": "blobs", "samples": 256, "features": 4,
                      "centers": 4, "seed": 1},
        },
        "jobs": [
            {"workload": "kmeans", "dataset": "blobs", "cores": 4,
             "params": {"n_clusters": 4, "max_iter": 5}},
        ],
        "sweeps": [
            {"workload": "linreg", "dataset": "lin", "version": "int32",
             "cores": 4, "grid": {"lr": [0.05, 0.1]}, "fused": True,
             "params": {"n_iters": 6}},
        ],
    }

    def scenario(P):
        scheduler, handles = P.run_manifest(doc)
        assert len(handles) == 3
        assert all(h.state is P.sched.JobState.DONE for h in handles)
        rows = P.sched.job_report(handles)
        json.dumps(rows)
        assert rows[1]["fused"] and rows[2]["fused"]
        assert scheduler.stats()["jobs"]["done"] == 3
        return scheduler, handles, rows

    (rs, rh, rrows), (ps, ph, prows) = both(scenario)
    assert_same_handles(rh, ph)
    assert report_sig(prows) == report_sig(rrows)
    assert_same(stats_sig(ps.stats()), stats_sig(rs.stats()), "stats")
    assert ps.capacity_estimate(doc) == rs.capacity_estimate(doc)


def test_manifest_rejects_unknown_dataset():
    doc = {"system": {"cores": 4},
           "jobs": [{"workload": "linreg", "dataset": "nope"}]}
    for P in (REF, PORT):
        with pytest.raises(ValueError, match="unknown dataset"):
            P.run_manifest(doc)


def test_manifest_file_must_be_a_mapping(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text('[{"workload": "linreg"}]')
    for P in (REF, PORT):
        with pytest.raises(ValueError, match="must be a mapping"):
            P.sched.load_manifest(str(p))


def test_fused_zero_iteration_sweep_accounts_nothing():
    X, y, _ = jsyn.make_linear_dataset(128, 4, seed=0)

    def scenario(P):
        sched = P.scheduler(8, 8)
        hs = sched.sweep("linreg", (X, y), {"lr": [0.1, 0.2]},
                         version="int32", n_iters=0, fused=True)
        log = drain_log(sched)
        assert all(h.state is P.sched.JobState.DONE for h in hs)
        assert all(h.steps == 0 and h.modeled_seconds == 0.0 for h in hs)
        assert hs[0].transfer.kernel_launches == 0
        return sched, log

    (rs, rlog), (ps, plog) = both(scenario)
    assert plog == rlog
    assert_same_handles(rs.handles, ps.handles)


# ---------------------------------------------------------------------------
# Manifests: schema pieces, the capacity plan, the backend key.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    {"kind": "linear", "samples": 300, "features": 5, "seed": 2},
    {"kind": "classification", "samples": 300, "features": 10, "seed": 2},
    {"kind": "blobs", "samples": 300, "features": 5, "centers": 3,
     "seed": 2},
    {"kind": "recsys", "samples": 400, "seed": 2},
    {},
])
def test_build_dataset_and_shape_match_reference(spec):
    for a, b in zip(tsched.manifest.build_dataset(spec),
                    jsched.manifest.build_dataset(spec)):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    assert tsched.dataset_shape(spec) == jsched.dataset_shape(spec)


@pytest.mark.parametrize("spec,err", [
    ({"kind": "pim", "cores": 8, "bogus": 1}, ValueError),
    ({"kind": "host", "backend": "vmap"}, ValueError),
])
def test_build_system_rejects_what_the_reference_rejects(spec, err):
    for build in (jsched.manifest.build_system,
                  tsched.manifest.build_system):
        with pytest.raises(err):
            build(spec)


def test_build_system_kwargs_and_device():
    spec = {"kind": "pim", "cores": 16, "rank_size": 4, "backfill": True,
            "placement": "contention", "policy": "deadline",
            "reduce": "host", "threads": 11, "backend": "vmap"}
    jsys, jkw = jsched.manifest.build_system(spec)
    tsys, tkw = tsched.manifest.build_system(spec, device="cpu")
    assert tkw == jkw
    assert (tsys.kind, tsys.config.n_cores, tsys.config.n_threads) == (
        jsys.kind, jsys.config.n_cores, jsys.config.n_threads)
    assert tsys.device.type == "cpu"
    for kind in ("host", "gpu-model"):
        tsys, _ = tsched.manifest.build_system({"kind": kind, "cores": 4},
                                               device="cpu")
        assert tsys.kind == kind and tsys.device.type == "cpu"
    with pytest.raises(ValueError, match="process group"):
        tsched.manifest.build_system({"backend": "shard_map"},
                                     device="cpu")


@pytest.mark.parametrize("cores,rank,placement", [
    (32, 4, "first_fit"), (64, 16, "contention"), (2048, 64, "first_fit")])
def test_capacity_estimate_matches_reference(cores, rank, placement):
    doc = {
        "datasets": {
            "lin": {"kind": "linear", "samples": 6_291_456, "features": 16},
            "blobs": {"kind": "blobs", "samples": 25_600_000,
                      "features": 16},
            "emb": {"kind": "recsys", "samples": 100_000},
        },
        "jobs": [
            {"workload": "kmeans", "dataset": "blobs", "cores": cores // 4,
             "params": {"n_clusters": 16, "max_iter": 10}},
            {"workload": "logreg", "dataset": "lin", "cores": cores // 2,
             "version": "int32_lut_wram", "params": {"n_iters": 10}},
            {"workload": "dtree", "dataset": "lin", "cores": cores // 4},
            {"workload": "emb", "dataset": "emb", "cores": cores // 4},
        ],
        "sweeps": [
            {"workload": "linreg", "dataset": "lin", "cores": cores // 2,
             "version": "int32", "grid": {"lr": [0.1, 0.2, 0.3]},
             "params": {"n_iters": 10}},
        ],
    }
    want = jsched.PimScheduler(
        japi.make_system("pim", n_cores=cores), rank_size=rank,
        placement=placement).capacity_estimate(doc)
    got = tsched.PimScheduler(
        tapi.make_system("pim", n_cores=cores, device="cpu"),
        rank_size=rank, placement=placement).capacity_estimate(doc)
    assert got == want
    assert got["makespan_lower_bound"] > 0
    for bad in ({"jobs": []}, {"jobs": [{"workload": "linreg"}],
                               "datasets": {"a": {}, "b": {}}}):
        for sched in (jsched.PimScheduler(japi.make_system("pim",
                                                           n_cores=8)),
                      tsched.PimScheduler(tapi.make_system(
                          "pim", n_cores=8, device="cpu"))):
            with pytest.raises(ValueError):
                sched.capacity_estimate(bad)


@pytest.mark.parametrize("workload,version,params,cores", [
    ("linreg", "int32", {"n_iters": 7}, 4),
    ("linreg", "fp32", {"n_iters": 7}, 16),
    ("logreg", "int32_lut_mram", {"n_iters": 3}, 8),
    ("kmeans", "int16", {"n_clusters": 5}, 4),
    ("dtree", "fp32", {}, 4),
    ("emb", "int32", {"batch": 32}, 4),
])
def test_cost_helpers_equal_reference_as_floats(workload, version, params,
                                                cores):
    X, y, _ = jsyn.make_linear_dataset(640, 8, seed=3)
    for kind in ("pim", "host"):
        jsys = japi.make_system(kind, n_cores=16)
        tsys = tapi.make_system(kind, n_cores=16, device="cpu")
        jspec = japi.get_workload(workload).spec(version, **params)
        tspec = tapi.get_workload(workload).spec(version, **params)
        assert tsched.scheduler._estimate_job_seconds(
            workload, tspec, (X, y), cores, tsys) == \
            jsched.scheduler._estimate_job_seconds(
                workload, jspec, (X, y), cores, jsys)
        jh = jsched.JobHandle(0, japi.get_workload(workload), jspec, 0,
                              cores)
        th = tsched.JobHandle(0, tapi.get_workload(workload), tspec, 0,
                              cores)
        jsl = jsys.slice(jsched.BankLease(0, cores))
        tsl = tsys.slice(tsched.BankLease(0, cores))
        jds = jsl.put(X, y)
        tds = tsl.put(X, y)
        got = tsched.scheduler._modeled_step_seconds(th, tds, tsl)
        assert got == jsched.scheduler._modeled_step_seconds(jh, jds, jsl)
        assert (got > 0) == (kind == "pim")


# ---------------------------------------------------------------------------
# reference tests/test_elastic.py: preempt, resume, migrate, evict, retry,
# persist.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workload,version,params", [
    ("linreg", "int32", {"n_iters": 24, "fuse_steps": 4}),
    ("linreg", "hyb", {"n_iters": 24, "fuse_steps": 1}),
    ("linreg", "int32", {"n_iters": 24, "fuse_steps": 1,
                         "minibatch": 32}),
    ("logreg", "int32", {"n_iters": 24, "fuse_steps": 4}),
])
def test_preempt_resume_gd_bit_identical(workload, version, params):
    X, y = _regression()
    if workload == "logreg":
        y = (y > np.median(y)).astype(np.float32)

    def scenario(P):
        ref = P.scheduler()
        rh = ref.submit(workload, (X, y), version=version, **params)
        ref.drain()
        s = P.scheduler()
        h = s.submit(workload, (X, y), version=version, **params)
        s.step(); s.step(); s.step()
        h.preempt()
        s.step()
        assert h.state is P.sched.JobState.PREEMPTED
        assert h.snapshot is not None and h.snapshot_kind == "pim"
        mid = h.iters
        assert 0 < mid < params["n_iters"]
        s2 = P.scheduler()
        s2.resume(h, data=(X, y))
        log = drain_log(s2)
        assert h.state is P.sched.JobState.DONE
        assert h.iters == params["n_iters"] and h.preemptions == 1
        np.testing.assert_array_equal(np.asarray(h.result.model.w),
                                      np.asarray(rh.result.model.w))
        np.testing.assert_array_equal(np.asarray(h.result.model.b),
                                      np.asarray(rh.result.model.b))
        return h, mid, log, s2.counts()

    (rh, rmid, rlog, rc), (ph, pmid, plog, pc) = both(scenario)
    assert (pmid, plog, pc) == (rmid, rlog, rc)
    assert_same_handles([rh], [ph])


@pytest.mark.parametrize("fuse", [1, 4])
def test_kmeans_preempt_resume_bit_identical(fuse):
    X, _ = _blobs96()
    params = dict(n_clusters=4, max_iter=12, n_init=2, seed=1, tol=0.0,
                  fuse_steps=fuse)

    def scenario(P):
        ref = P.scheduler()
        rh = ref.submit("kmeans", (X, None), version="int16", **params)
        ref.drain()
        s = P.scheduler()
        h = s.submit("kmeans", (X, None), version="int16", **params)
        for _ in range(3):
            s.step()
        h.preempt()
        s.step()
        assert h.state is P.sched.JobState.PREEMPTED
        s2 = P.scheduler()
        s2.resume(h, data=(X, None))
        log = drain_log(s2)
        assert h.state is P.sched.JobState.DONE
        rm, hm = rh.result.model, h.result.model
        np.testing.assert_array_equal(hm.centroids, rm.centroids)
        np.testing.assert_array_equal(hm.labels, rm.labels)
        assert hm.inertia == rm.inertia and hm.n_iters == rm.n_iters
        return h, log

    (rh, rlog), (ph, plog) = both(scenario)
    assert plog == rlog
    assert_same_handles([rh], [ph])


def test_non_resumable_workload_restarts():
    X, y = _regression()
    y = (y > np.median(y)).astype(np.int32)

    def scenario(P):
        s = P.scheduler()
        h = s.submit("dtree", (X, y), max_depth=4)
        s.step(); s.step()
        h.preempt()
        s.step()
        assert h.state is P.sched.JobState.PREEMPTED and h.snapshot is None
        s.resume(h)
        log = drain_log(s)
        assert h.state is P.sched.JobState.DONE
        return s, log

    (rs, rlog), (ps, plog) = both(scenario)
    assert plog == rlog
    assert_same_handles(rs.handles, ps.handles)


def _mixed(P):
    return P.sched.PimScheduler({"pim": P.system("pim", 8),
                                 "host": P.system("host", 4)}, rank_size=4)


def test_fp32_migration_pim_to_host():
    X, y = _regression()

    def scenario(P):
        s = _mixed(P)
        h = s.submit("linreg", (X, y), version="fp32", n_iters=30,
                     target="pim")
        s.step(); s.step()
        h.preempt(); s.step()
        assert h.state is P.sched.JobState.PREEMPTED
        s.resume(h, target="host")
        log = drain_log(s)
        assert h.state is P.sched.JobState.DONE and h.target == "host"
        ref = P.sched.PimScheduler(P.system("host", 4))
        r = ref.submit("linreg", (X, y), version="fp32", n_iters=30)
        ref.drain()
        np.testing.assert_allclose(np.asarray(h.result.model.w),
                                   np.asarray(r.result.model.w),
                                   rtol=1e-4, atol=1e-5)
        return s, log

    (rs, rlog), (ps, plog) = both(scenario)
    assert plog == rlog
    assert_same_handles(rs.handles, ps.handles)
    assert_same(stats_sig(ps.stats()), stats_sig(rs.stats()), "stats")


def test_integer_migration_rejected_then_resumes_home():
    X, y = _regression()

    def scenario(P):
        s = _mixed(P)
        h = s.submit("linreg", (X, y), version="int32", n_iters=20,
                     target="pim")
        s.step()
        h.preempt(); s.step()
        with pytest.raises(ValueError, match="fixed-point"):
            s.resume(h, target="host")
        with pytest.raises(ValueError, match="PREEMPTED"):
            s.resume(s.submit("linreg", (X, y), n_iters=2))
        s.resume(h, target="pim")
        log = drain_log(s)
        assert h.state is P.sched.JobState.DONE
        return s, log

    (rs, rlog), (ps, plog) = both(scenario)
    assert plog == rlog
    assert_same_handles(rs.handles, ps.handles)


def test_high_priority_evicts_and_everyone_finishes():
    X, y = _regression()

    def scenario(P):
        s = P.scheduler(preemptive=True)
        low1 = s.submit("linreg", (X, y), version="int32", n_iters=30,
                        priority=0, name="low1")
        low2 = s.submit("linreg", (X, y), version="int32", n_iters=30,
                        priority=0, name="low2")
        s.step()
        hi = s.submit("linreg", (X, y), version="int32", n_iters=10,
                      priority=5, name="hi")
        s.step()
        assert hi.state is P.sched.JobState.RUNNING
        assert low1.preemptions + low2.preemptions == 1
        log = drain_log(s)
        assert all(h.state is P.sched.JobState.DONE
                   for h in (low1, low2, hi))
        assert s.metrics.counter("sched.evictions").value == 1
        return s, log

    (rs, rlog), (ps, plog) = both(scenario)
    assert plog == rlog
    assert_same_handles(rs.handles, ps.handles)
    assert_same(stats_sig(ps.stats()), stats_sig(rs.stats()), "stats")


def test_non_preemptive_never_evicts():
    X, y = _regression()

    def scenario(P):
        s = P.scheduler(preemptive=False)
        low = s.submit("linreg", (X, y), version="int32", n_iters=10,
                       n_cores=8)
        s.step()
        hi = s.submit("linreg", (X, y), version="int32", n_iters=10,
                      priority=5)
        s.step()
        assert hi.state is P.sched.JobState.QUEUED and low.preemptions == 0
        return s, drain_log(s)

    (rs, rlog), (ps, plog) = both(scenario)
    assert plog == rlog
    assert_same_handles(rs.handles, ps.handles)


def test_defragment_coalesces_holes():
    X, y = _regression()

    def scenario(P):
        s = P.scheduler(16, 4)
        hs = [s.submit("linreg", (X, y), version="int32", n_iters=60,
                       name=f"j{i}") for i in range(4)]
        s.step()
        hs[1].cancel(); hs[3].cancel()
        s.step()
        frag = s.fragmentation()
        assert frag.external_fragmentation > 0
        moved = s.defragment()
        assert moved == 2
        s.step()
        assert s.fragmentation().external_fragmentation == 0.0
        log = drain_log(s)
        assert hs[0].state is P.sched.JobState.DONE
        assert hs[2].state is P.sched.JobState.DONE
        np.testing.assert_array_equal(hs[0].result.model.w,
                                      hs[2].result.model.w)
        return s, log, dataclasses.asdict(frag)

    (rs, rlog, rf), (ps, plog, pf) = both(scenario)
    assert (plog, pf) == (rlog, rf)
    assert_same_handles(rs.handles, ps.handles)
    assert_same(stats_sig(ps.stats()), stats_sig(rs.stats()), "stats")


def test_churn():
    X, y = _regression()

    def scenario(P):
        s = P.scheduler(16, 4, preemptive=True)
        handles, log = [], []
        for wave in range(6):
            for i in range(3):
                handles.append(s.submit(
                    "linreg", (X, y), version="int32", n_iters=20,
                    priority=wave % 3, name=f"w{wave}j{i}"))
            for _ in range(4):
                s.step()
                log.append(turn_sig(s))
            if wave % 2:
                for h in handles:
                    if h.state is P.sched.JobState.RUNNING:
                        h.preempt()
                        break
                s.step()
                for h in handles:
                    if h.state is P.sched.JobState.PREEMPTED:
                        s.resume(h)
            s.defragment()
            log.append(turn_sig(s))
        log += drain_log(s)
        assert all(h.state in (P.sched.JobState.DONE,
                               P.sched.JobState.CANCELLED)
                   for h in handles)
        assert s.fragmentation().used_cores == 0
        return s, log

    (rs, rlog), (ps, plog) = both(scenario)
    assert plog == rlog
    assert_same_handles(rs.handles, ps.handles)
    assert_same(stats_sig(ps.stats()), stats_sig(rs.stats()), "stats")


@pytest.mark.parametrize("plan,budget,want", [
    ("faulty:3", 2, "done"), ("faulty:2:10", 1, "failed"),
    ("faulty:1", 0, "failed")])
def test_fault_injection_and_supervised_retry(plan, budget, want):
    X, y = _regression()

    def scenario(P):
        s = P.scheduler(fault_injector=P.elastic.FaultInjector.parse(plan))
        h = s.submit("linreg", (X, y), version="int32", n_iters=20,
                     fuse_steps=2, retry_budget=budget, name="faulty")
        log = drain_log(s)
        assert h.state.value == want
        assert isinstance(h.error, P.elastic.InjectedFault)
        if want == "done":
            ref = P.scheduler()
            r = ref.submit("linreg", (X, y), version="int32", n_iters=20,
                           fuse_steps=2)
            ref.drain()
            np.testing.assert_array_equal(h.result.model.w,
                                          r.result.model.w)
            assert s.stats()["recoveries"] == 1
        return s, log

    (rs, rlog), (ps, plog) = both(scenario)
    assert plog == rlog
    assert_same_handles(rs.handles, ps.handles)
    assert_same(stats_sig(ps.stats()), stats_sig(rs.stats()), "stats")


def test_fault_plan_from_environment(monkeypatch):
    X, y = _regression()
    monkeypatch.setenv(telastic.ENV_VAR, "envjob:2")
    assert telastic.ENV_VAR == jelastic.ENV_VAR

    def scenario(P):
        s = P.scheduler(default_retry_budget=1)
        h = s.submit("linreg", (X, y), version="int32", n_iters=6,
                     name="envjob")
        log = drain_log(s)
        assert h.state is P.sched.JobState.DONE and h.recoveries == 1
        return s, log

    (rs, rlog), (ps, plog) = both(scenario)
    assert plog == rlog
    assert_same_handles(rs.handles, ps.handles)


def test_straggler_stats_exposed():
    X, y = _regression()
    for P in (REF, PORT):
        s = P.scheduler()
        s.submit("linreg", (X, y), version="int32", n_iters=10)
        s.drain()
        stats = s.stats()
        assert stats["straggler_flags"] >= 0


def test_gpu_slice_attribution():
    X, y = _regression()

    def scenario(P):
        s = P.sched.PimScheduler(P.system("gpu-model", 8), rank_size=4)
        h1 = s.submit("linreg", (X, y), version="fp32", n_iters=16,
                      fuse_steps=4)
        h2 = s.submit("kmeans", (X, None), version="fp32", n_clusters=4,
                      max_iter=16, fuse_steps=4)
        log = drain_log(s)
        assert h1.gpu is not None and h2.gpu is not None
        assert h1.gpu.modeled_seconds > 0 and h2.gpu.modeled_seconds > 0
        total = s.system.gpu
        assert h1.gpu.launches + h2.gpu.launches <= total.launches
        assert (h1.gpu.modeled_seconds + h2.gpu.modeled_seconds
                <= total.modeled_seconds + 1e-12)
        return s, log

    (rs, rlog), (ps, plog) = both(scenario)
    assert plog == rlog
    assert [h.gpu.launches for h in ps.handles] == [
        h.gpu.launches for h in rs.handles]
    for r, p in zip(rs.handles, ps.handles):
        assert_same_result(p.result, r.result, "fp32")


def test_snapshot_disk_roundtrip(tmp_path):
    X, y = _regression()

    def scenario(P):
        ck = str(tmp_path / P.name)
        s = P.scheduler(checkpoint_dir=ck, checkpoint_every=2)
        h = s.submit("linreg", (X, y), version="int32", n_iters=20,
                     fuse_steps=2, minibatch=32, name="rt")
        for _ in range(4):
            s.step()
        d = P.elastic.job_dir(ck, "rt")
        assert P.elastic.has_checkpoint(d)
        snap, env = P.elastic.load_snapshot(d)
        assert env["workload"] == "linreg" and env["version"] == "int32"
        assert env["fingerprint"] == h.fingerprint
        assert env["system_kind"] == "pim"
        assert "rng_mt_keys" in snap["arrays"]
        assert snap["meta"]["iters"] == env["iters"] > 0
        with open(os.path.join(ck, "queue.json")) as fh:
            queue = json.load(fh)
        return h, env, {k: np.asarray(v) for k, v in
                        snap["arrays"].items()}, queue

    (rh, renv, rarr, rq), (ph, penv, parr, pq) = both(scenario)
    assert penv == renv
    assert pq == rq
    assert sorted(parr) == sorted(rarr)
    for k in rarr:
        np.testing.assert_array_equal(parr[k], rarr[k], err_msg=k)
    assert handle_sig(ph) == handle_sig(rh)


def test_fingerprint_mismatch_refused(tmp_path):
    X, y = _regression()
    for P in (REF, PORT):
        ck = str(tmp_path / P.name)
        s = P.scheduler(checkpoint_dir=ck)
        s.submit("linreg", (X, y), version="int32", n_iters=12, name="fp")
        for _ in range(3):
            s.step()
        snap, env = P.elastic.load_snapshot(P.elastic.job_dir(ck, "fp"))
        s2 = P.scheduler(checkpoint_dir=ck)
        h2 = s2.submit("linreg", (X + 1.0, y), version="int32",
                       n_iters=12, name="fp")
        with pytest.raises(ValueError, match="fingerprint"):
            s2.attach_resume_state(h2, snap, env)


def test_checkpoint_crosses_packages_through_attach(tmp_path):
    """A job checkpoint the reference's scheduler wrote resumes through
    the port's ``attach_resume_state`` (and back) bit-identically."""
    X, y = _regression()
    want = None
    for writer, reader in ((REF, PORT), (PORT, REF)):
        ck = str(tmp_path / writer.name)
        s = writer.scheduler(checkpoint_dir=ck)
        s.submit("linreg", (X, y), version="int32", n_iters=12,
                 fuse_steps=3, name="x")
        for _ in range(2):
            s.step()
        snap, env = reader.elastic.load_snapshot(
            reader.elastic.job_dir(ck, "x"))
        s2 = reader.scheduler(checkpoint_dir=ck)
        h = s2.submit("linreg", (X, y), version="int32", n_iters=12,
                      fuse_steps=3, name="x")
        s2.attach_resume_state(h, snap, env)
        assert h.iters == 6
        s2.drain()
        assert h.state is reader.sched.JobState.DONE and h.iters == 12
        if want is None:
            want = h.result.model.w
        np.testing.assert_array_equal(h.result.model.w, want)


LIN_MANIFEST = {
    "system": {"cores": 16, "rank_size": 4},
    "datasets": {"lin": {"kind": "linear", "samples": 256,
                         "features": 8, "seed": 0}},
    "jobs": [
        {"workload": "linreg", "dataset": "lin", "cores": 4,
         "name": "quick", "version": "int32",
         "params": {"n_iters": 6, "fuse_steps": 2}},
        {"workload": "linreg", "dataset": "lin", "cores": 4,
         "name": "long", "version": "int32",
         "params": {"n_iters": 60, "fuse_steps": 2}},
    ],
}


def test_killed_queue_resume_roundtrip(tmp_path):
    def scenario(P):
        ck = str(tmp_path / P.name)
        sched, handles = P.run_manifest(LIN_MANIFEST, drain=False,
                                        checkpoint_dir=ck)
        for _ in range(6):
            sched.step()
        by_name = {h.name: h for h in handles}
        assert by_name["quick"].state is P.sched.JobState.DONE
        assert by_name["long"].state is P.sched.JobState.RUNNING
        del sched
        with open(os.path.join(ck, "queue.json")) as fh:
            queue = json.load(fh)
        assert {r["name"]: r["state"] for r in queue["jobs"]} == {
            "quick": "done", "long": "running"}
        sched2, handles2 = P.run_manifest(LIN_MANIFEST, checkpoint_dir=ck,
                                          resume=True)
        by_name2 = {h.name: h for h in handles2}
        assert by_name2["quick"].restored
        assert by_name2["quick"].steps == by_name["quick"].steps
        long2 = by_name2["long"]
        assert long2.state is P.sched.JobState.DONE and not long2.restored
        assert long2.iters == 60
        _, ref_handles = P.run_manifest(LIN_MANIFEST)
        ref = {h.name: h for h in ref_handles}["long"]
        np.testing.assert_array_equal(long2.result.model.w,
                                      ref.result.model.w)
        with open(os.path.join(ck, "queue.json")) as fh:
            final = json.load(fh)
        return queue, final, handles2

    (rq, rf, rh), (pq, pf, ph) = both(scenario)
    assert (pq, pf) == (rq, rf)
    assert_same_handles(rh, ph)


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["reference-to-port", "port-to-reference"])
def test_pim_jobs_checkpoint_dir_resumes_across_packages(
        tmp_path, monkeypatch, writer, reader):
    """One package's ``pim_jobs --checkpoint-dir`` run loses job "long"
    to an injected fault at its fourth chunk (no retry budget); the
    other package's ``pim_jobs --resume`` on that directory restores
    "quick" without re-running it and finishes "long" from its last
    durable snapshot, bit-identical to an uninterrupted fit."""
    manifest = tmp_path / "lin.json"
    manifest.write_text(json.dumps(LIN_MANIFEST))
    ck = str(tmp_path / "ck")
    monkeypatch.setenv(jelastic.ENV_VAR, "long:4")
    assert writer.cli([str(manifest), "--checkpoint-dir", ck]) == 1
    with open(os.path.join(ck, "queue.json")) as fh:
        queue = json.load(fh)
    assert {r["name"]: (r["state"], r["iters"]) for r in queue["jobs"]} \
        == {"quick": ("done", 6), "long": ("failed", 6)}
    monkeypatch.delenv(jelastic.ENV_VAR)
    shutil.copytree(ck, str(tmp_path / "ck_copy"))

    out = tmp_path / "report.json"
    assert reader.cli([str(manifest), "--checkpoint-dir", ck, "--resume",
                       "--json", str(out)]) == 0
    rows = {r["name"]: r for r in json.loads(out.read_text())["jobs"]}
    assert rows["quick"]["restored"] and rows["quick"]["state"] == "done"
    assert "kernel_launches" not in rows["quick"]
    assert rows["long"]["state"] == "done" and rows["long"]["iters"] == 60
    assert rows["long"]["kernel_launches"] == (60 - 6) // 2   # chunks

    sched, handles = reader.run_manifest(
        LIN_MANIFEST, checkpoint_dir=str(tmp_path / "ck2"))
    uninterrupted = {h.name: h for h in handles}["long"]
    _, resumed = reader.run_manifest(LIN_MANIFEST,
                                     checkpoint_dir=str(tmp_path / "ck_copy"),
                                     resume=True)
    long_ = {h.name: h for h in resumed}["long"]
    np.testing.assert_array_equal(long_.result.model.w,
                                  uninterrupted.result.model.w)
    assert long_.result.model.b == uninterrupted.result.model.b


# ---------------------------------------------------------------------------
# reference tests/test_obs.py: attribution, traces, drift.
# ---------------------------------------------------------------------------

def _small_manifest(n_iters=12):
    return {
        "system": {"cores": 8, "rank_size": 4},
        "datasets": {"lin": {"kind": "linear", "samples": 256,
                             "features": 8, "seed": 0}},
        "jobs": [
            {"workload": "linreg", "dataset": "lin", "cores": 4,
             "version": "int32", "params": {"n_iters": n_iters}},
            {"workload": "logreg", "dataset": "lin", "cores": 4,
             "version": "int32", "params": {"n_iters": n_iters}},
        ],
    }


def test_mixed_target_parent_totals_equal_job_delta_sums():
    X, y, _ = jsyn.make_linear_dataset(192, 6, seed=0)

    def scenario(P):
        systems = {"pim": P.system("pim", 8), "host": P.system("host", 4),
                   "gpu": P.system("gpu-model", 4)}
        sched = P.sched.PimScheduler(systems, rank_size=4)
        for target, version in (("pim", "int32"), ("host", "fp32"),
                                ("gpu", "fp32")):
            sched.submit("linreg", (X, y), version=version, n_cores=4,
                         target=target, n_iters=10)
            sched.submit("logreg", (X, y), version=version, n_cores=4,
                         target=target, n_iters=10)
        log = drain_log(sched)
        handles = sched.handles
        assert all(h.state is P.sched.JobState.DONE for h in handles)
        for target, system in systems.items():
            jobs = [h for h in handles if h.target == target]
            for field in ("kernel_launches", "cpu_to_pim", "pim_to_cpu",
                          "shard_transfers", "shard_bytes", "dram_bytes"):
                assert sum(getattr(h.transfer, field) for h in jobs) \
                    == getattr(system.stats, field), (target, field)
        gpu_jobs = [h for h in handles if h.target == "gpu"]
        assert sum(h.gpu.launches for h in gpu_jobs) \
            == systems["gpu"].gpu.launches
        assert sum(h.gpu.modeled_seconds for h in gpu_jobs) \
            == pytest.approx(systems["gpu"].gpu.modeled_seconds)
        return sched, log

    (rs, rlog), (ps, plog) = both(scenario)
    assert plog == rlog
    assert_same_handles(rs.handles, ps.handles)
    r, p = stats_sig(rs.stats()), stats_sig(ps.stats())
    r.pop("gpu_model"), p.pop("gpu_model")   # launches, flops: PR 20's band
    assert p == r


def _trace(P, fn):
    P.tracer.clear()
    P.tracer.enable()
    try:
        fn()
        return P.tracer.events()
    finally:
        P.tracer.disable()
        P.tracer.clear()


def _sched_events(events) -> list:
    """The scheduler's own events: admissions, chunks, preempts,
    resumes, channel occupancy (the systems' launch spans carry kernel
    names that differ between the packages)."""
    return [(e["ph"], e["name"], e["track"]) for e in events
            if e["track"] == "sched" or e["track"].startswith(
                ("job:", "channels:", "target:"))]


def test_trace_deterministic_and_equal_to_reference():
    sigs = {}
    for P in (REF, PORT):
        first = _sched_events(_trace(P, lambda: P.run_manifest(
            _small_manifest())))
        second = _sched_events(_trace(P, lambda: P.run_manifest(
            _small_manifest())))
        assert first == second and first
        sigs[P.name] = first
    assert sigs["port"] == sigs["reference"]
    tracks = {t for _, _, t in sigs["port"]}
    assert "sched" in tracks
    assert any(t.startswith("job:") for t in tracks)
    assert any(t.startswith("channels:") for t in tracks)


def test_scheduler_trace_has_expected_tracks_and_spans():
    holder = {}

    def run():
        holder["out"] = PORT.run_manifest(_small_manifest())

    events = _trace(PORT, run)
    assert all(h.state is tsched.JobState.DONE for h in holder["out"][1])
    doc = to_chrome_trace(events)
    validate_chrome_trace(doc)
    names = {e["name"] for e in events}
    tracks = {e["track"] for e in events}
    assert {"sched", "target:pim", "channels:pim"} <= tracks
    assert any(t.startswith("job:") for t in tracks)
    assert "chunk" in names and "admit" in names
    assert any(n.startswith("channel") for n in names)
    assert any(n.startswith("map_reduce:") or n.startswith("chunk:")
               for n in names)


def test_preempt_resume_instants_in_trace():
    X, y, _ = jsyn.make_linear_dataset(256, 8, seed=1)
    for P in (REF, PORT):
        holder = {}

        def run():
            sched = P.sched.PimScheduler(P.system("pim", 8), rank_size=4)
            h = sched.submit("linreg", (X, y), version="int32", n_cores=4,
                             n_iters=30)
            sched.step()
            sched.step()
            h.preempt()
            sched.step()
            assert h.state is P.sched.JobState.PREEMPTED
            sched.resume(h)
            sched.drain()
            holder["h"] = h

        events = _trace(P, run)
        h = holder["h"]
        assert h.state is P.sched.JobState.DONE
        instants = [e["name"] for e in events if e["ph"] == "i"
                    and e["track"] == f"job:{h.name}"]
        assert "preempt" in instants and "resume" in instants


def test_stats_reports_per_job_drift_ratios():
    def scenario(P):
        scheduler, handles = P.run_manifest(_small_manifest())
        stats = scheduler.stats()
        json.dumps(stats)
        drift = stats["drift"]
        assert set(drift) == {h.name for h in handles}
        for h in handles:
            entry = drift[h.name]
            assert entry["ratio"] is not None and entry["ratio"] > 0
            assert entry["chunks"] == h.drift.count > 0
            assert entry["measured_seconds"] == h.measured_seconds > 0
            assert h.drift_ratio == pytest.approx(
                h.measured_seconds / h.modeled_seconds)
        hist = stats["metrics"]["sched.drift_ratio"]
        assert hist["count"] == sum(h.drift.count for h in handles)
        assert list(hist["bounds"]) == list(P.drift_buckets)
        m = handles[0].metrics()
        assert m["drift_ratio"] == handles[0].drift_ratio
        assert m["transfer"]["kernel_launches"] > 0
        return scheduler

    rs, ps = both(scenario)
    assert_same(stats_sig(ps.stats()), stats_sig(rs.stats()), "stats")
    assert sorted(handles_metrics_keys(ps)) == sorted(
        handles_metrics_keys(rs))


def handles_metrics_keys(sched) -> list:
    return [tuple(sorted(h.metrics())) for h in sched.handles]


def test_drift_ratio_none_when_model_cannot_price():
    X, y, _ = jsyn.make_linear_dataset(128, 4, seed=0)

    def scenario(P):
        sched = P.sched.PimScheduler(P.system("host", 4), rank_size=4)
        h = sched.submit("linreg", (X, y), version="fp32", n_cores=4,
                         n_iters=5)
        sched.drain()
        assert h.state is P.sched.JobState.DONE
        assert h.modeled_seconds == 0.0 and h.drift_ratio is None
        assert h.measured_seconds > 0.0
        return sched

    rs, ps = both(scenario)
    assert_same_handles(rs.handles, ps.handles)


def test_disabled_tracer_overhead_under_two_percent():
    import time
    assert not TTRACER.enabled
    t0 = time.perf_counter()
    _, handles = PORT.run_manifest(_small_manifest())
    makespan = time.perf_counter() - t0
    assert all(h.state is tsched.JobState.DONE for h in handles)
    n_sites = len(_trace(PORT, lambda: PORT.run_manifest(
        _small_manifest())))
    n_calls = 50_000
    t0 = time.perf_counter()
    for _ in range(n_calls):
        TTRACER.span("x", track="t")
        TTRACER.instant("x")
        TTRACER.counter("x", 1.0)
    per_site = (time.perf_counter() - t0) / (3 * n_calls)
    assert n_sites * per_site < 0.02 * makespan, (
        f"{n_sites} sites x {per_site * 1e9:.0f} ns "
        f"vs makespan {makespan:.3f}s")


# ---------------------------------------------------------------------------
# The CLI: pim_jobs.main in process.
# ---------------------------------------------------------------------------

def _cli_report(P, argv, tmp_path):
    out = tmp_path / f"{P.name}.json"
    rc = P.cli(list(argv) + ["--json", str(out)])
    return rc, json.loads(out.read_text())


@pytest.mark.parametrize("translate", [False, True], ids=["yaml", "json"])
def test_pim_jobs_on_example_manifest(tmp_path, translate):
    """``pim_jobs`` on ``examples/jobs.yaml`` (and on its JSON
    translation, the form a machine without PyYAML reads): the same
    report as the reference's, without its wall-clock fields."""
    path = EXAMPLE
    if translate:
        import yaml
        with open(EXAMPLE) as fh:
            doc = yaml.safe_load(fh)
        path = str(tmp_path / "jobs.json")
        with open(path, "w") as fh:
            json.dump(doc, fh)
        assert tsched.load_manifest(path) == jsched.load_manifest(EXAMPLE)
    rrc, rrep = _cli_report(REF, [path], tmp_path)
    prc, prep = _cli_report(PORT, [path], tmp_path)
    assert rrc == prc == 0
    assert report_sig(prep["jobs"]) == report_sig(rrep["jobs"])
    assert stats_sig(prep["scheduler"]) == stats_sig(rrep["scheduler"])
    assert prep["device"] == "cpu" and prep["launch_counts"] == {}
    assert {r["state"] for r in prep["jobs"]} == {"done"}


def test_pim_jobs_demo_and_argument_errors(tmp_path, capsys):
    rc, rep = _cli_report(PORT, ["--demo"], tmp_path)
    assert rc == 0 and len(rep["jobs"]) == 6
    rrc, rrep = _cli_report(REF, ["--demo"], tmp_path)
    assert report_sig(rep["jobs"]) == report_sig(rrep["jobs"])
    for argv in ([], ["--demo", "--resume"], ["--demo", "--serve"]):
        with pytest.raises(SystemExit):
            tjobs.main(argv)
    capsys.readouterr()


def test_pim_jobs_slo_rejection_report(tmp_path):
    rc, rep = _cli_report(PORT, ["--demo", "--max-modeled-seconds",
                                 "1e-12"], tmp_path)
    rrc, rrep = _cli_report(REF, ["--demo", "--max-modeled-seconds",
                                  "1e-12"], tmp_path)
    assert rc == rrc == 1
    assert rep == rrep and rep["rejected"] is True


@pytest.mark.slow
def test_pim_jobs_trace_flag_on_example_manifest(tmp_path):
    from repro_torch.obs import load_chrome_trace, track_names
    trace_path = os.path.join(str(tmp_path), "trace.json")
    try:
        rc = PORT.cli([EXAMPLE, "--trace", trace_path])
    finally:
        TTRACER.disable()
        TTRACER.clear()
    assert rc == 0
    doc = load_chrome_trace(trace_path)
    validate_chrome_trace(doc)
    tracks = track_names(doc)
    assert "channels:pim" in tracks and "target:pim" in tracks
    assert any(t.startswith("job:") for t in tracks)
