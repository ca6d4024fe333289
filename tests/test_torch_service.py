"""The port's training service against the JAX package's: the
background serve loop, SLO admission, deadline scheduling and the
manifest spool.

Each case of the reference's ``tests/test_service.py`` runs through
both packages on the CPU, on the same seeded data
(``make_linear_dataset(192, 6)``).  What does not depend on the wall
clock must be equal: job states, steps and iterations, leases,
``TransferStats`` deltas, modeled seconds, SLO rejections and their
messages, the metrics counters, the latency record counts and the
spool's sidecar verdicts.  Integer weights are bit-identical.  Every
wait and shutdown passes a timeout, so a hang fails the case instead of
eating the suite's clock.  The Poisson soak and the ``--serve`` CLI run
are ``slow``, as in the reference.

The reference's ``mul_round_f32`` calls ``jax.experimental.enable_x64``,
which this JAX no longer has; :func:`x64_alias` aliases it for this
file's tests only.  The last cases check the JSON translation of
``examples/jobs.yaml`` that ``chip_smoke.py`` hands the CLI on the card
(whose machine has no PyYAML).
"""
import dataclasses
import importlib.util
import json
import os
import threading
import time

import jax
import jax.experimental
import numpy as np
import pytest

import repro.api as japi
import repro.sched as jsched
from repro.data.synthetic import make_linear_dataset
from repro.launch import pim_jobs as jjobs

import repro_torch.api as tapi
import repro_torch.sched as tsched
from repro_torch.launch import pim_jobs as tjobs

N, F = 192, 6
WAIT = 120.0          # seconds any wait or shutdown may take
ROOT = os.path.join(os.path.dirname(__file__), os.pardir)


@pytest.fixture(scope="module", autouse=True)
def x64_alias():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        yield


@pytest.fixture(scope="module")
def lin_data():
    X, y, _ = make_linear_dataset(N, F, seed=0)
    return X, y


class Pkg:
    def __init__(self, port: bool):
        self.port = port
        self.name = "port" if port else "reference"
        self.api = tapi if port else japi
        self.sched = tsched if port else jsched
        self.jobs = tjobs if port else jjobs
        self.dev = {"device": "cpu"} if port else {}

    def scheduler(self, cores=8, rank=4, **kw):
        system = self.api.make_system("pim", n_cores=cores, **self.dev)
        return self.sched.PimScheduler(system, rank_size=rank, **kw)

    def cli(self, argv):
        return self.jobs.main(list(argv)
                              + (["--device", "cpu"] if self.port else []))

    def __repr__(self):
        return self.name


REF, PORT = Pkg(False), Pkg(True)


def both(scenario, *args):
    return scenario(REF, *args), scenario(PORT, *args)


def _manifest_doc(n_iters=20, name="job", cores=4):
    return {
        "system": {"cores": 8, "rank_size": 4},
        "datasets": {"lin": {"kind": "linear", "samples": N,
                             "features": F, "seed": 0}},
        "jobs": [
            {"workload": "linreg", "dataset": "lin", "cores": cores,
             "version": "int32", "name": name,
             "params": {"n_iters": n_iters, "fuse_steps": 5}},
        ],
    }


def job_sig(h) -> dict:
    """A handle without its wall-clock fields."""
    return {
        "name": h.name, "state": h.state.value, "steps": h.steps,
        "iters": h.iters, "cores": h.n_cores, "priority": h.priority,
        "lease": None if h.lease is None else (h.lease.start,
                                               h.lease.n_cores),
        "preemptions": h.preemptions,
        "modeled_seconds": h.modeled_seconds, "chunks": h.drift.count,
        "transfer": (None if h.transfer is None
                     else dataclasses.asdict(h.transfer)),
        "error": None if h.error is None else (type(h.error).__name__,
                                               str(h.error)),
        "has_deadline": h.deadline is not None,
        "started": h.started_at is not None,
        "finished": h.finished_at is not None,
        "w": (None if h.result is None
              else np.asarray(h.result.model.w).tolist()),
        "b": None if h.result is None else float(h.result.model.b),
    }


def counters(sched) -> dict:
    return {name: m for name, m in sched.metrics.to_dict().items()
            if not isinstance(m, dict)}


def latency_counts(sched) -> tuple:
    lat = sched.latency_summary()
    return (lat["queue"]["count"], lat["completion"]["count"],
            lat["deadline_misses"])


def assert_same_jobs(ref_handles, port_handles):
    assert [job_sig(h) for h in port_handles] == [
        job_sig(h) for h in ref_handles]


# ---------------------------------------------------------------------------
# Serve lifecycle: background drain, wait, shutdown without job loss.
# ---------------------------------------------------------------------------

def test_serve_lifecycle_and_latency(lin_data):
    X, y = lin_data

    def scenario(P):
        s = P.scheduler()
        assert not s.serving and s.idle
        s.serve(poll_interval=0.005)
        assert s.serving
        with pytest.raises(RuntimeError):
            s.serve()
        handles = [s.submit("linreg", (X, y), version="int32", n_cores=4,
                            n_iters=20, fuse_steps=5, name=f"j{i}")
                   for i in range(3)]
        assert s.wait(handles, timeout=WAIT)
        assert all(h.state is P.sched.JobState.DONE for h in handles)
        for h in handles:
            assert h.queue_latency is not None and h.queue_latency >= 0.0
            assert h.completion_latency >= h.queue_latency
            m = h.metrics()
            assert m["queue_latency"] == h.queue_latency
            assert m["deadline_missed"] is False
        lat = s.latency_summary()
        assert lat["completion"]["count"] == 3
        assert lat["queue"]["p50"] <= lat["queue"]["p99"]
        stats = s.stats()
        assert stats["serving"]
        assert stats["latency"]["completion"]["count"] == 3
        s.shutdown(wait=True, timeout=WAIT)
        assert not s.serving and s.idle
        assert s.metrics.counter("sched.serve_errors").value == 0
        return s

    rs, ps = both(scenario)
    _same_but_leases(rs, ps)
    assert counters(ps).keys() == counters(rs).keys()
    assert latency_counts(ps) == latency_counts(rs)


def _same_but_leases(rs, ps) -> None:
    """Which job a serving turn admits where depends on when each submit
    lands; everything else about the jobs does not."""
    strip = (lambda h: {k: v for k, v in job_sig(h).items()
                        if k != "lease"})
    assert [strip(h) for h in ps.handles] == [strip(h) for h in rs.handles]


def test_shutdown_drains_submitted_jobs(lin_data):
    X, y = lin_data

    def scenario(P):
        s = P.scheduler()
        s.serve(poll_interval=0.005)
        handles = [s.submit("linreg", (X, y), version="int32", n_cores=4,
                            n_iters=15, fuse_steps=5) for _ in range(4)]
        s.shutdown(wait=True, timeout=WAIT)
        assert all(h.state is P.sched.JobState.DONE for h in handles)
        assert s.idle and not s.serving
        s.shutdown(wait=True, timeout=WAIT)         # idempotent
        s.serve(poll_interval=0.005)                # restarts after a stop
        h = s.submit("linreg", (X, y), version="int32", n_cores=4,
                     n_iters=10, fuse_steps=5)
        assert s.wait([h], timeout=WAIT) and h.state is P.sched.JobState.DONE
        s.shutdown(wait=True, timeout=WAIT)
        return s

    rs, ps = both(scenario)
    _same_but_leases(rs, ps)
    assert latency_counts(ps) == latency_counts(rs)


def test_shutdown_without_wait_keeps_the_queue(lin_data):
    """``shutdown(wait=False)`` stops after the in-flight turn and loses
    nothing: a later ``drain`` finishes every job."""
    X, y = lin_data

    def scenario(P):
        s = P.scheduler(4, 4)
        handles = [s.submit("linreg", (X, y), version="int32", n_cores=4,
                            n_iters=10, fuse_steps=5, name=f"k{i}")
                   for i in range(3)]
        s.serve(poll_interval=0.005)
        s.shutdown(wait=False, timeout=WAIT)
        assert not s.serving
        s.drain()
        assert all(h.state is P.sched.JobState.DONE for h in handles)
        assert s.wait(handles, timeout=WAIT)
        return s

    rs, ps = both(scenario)
    assert_same_jobs(rs.handles, ps.handles)


def test_wait_times_out_without_a_draining_thread(lin_data):
    X, y = lin_data
    for P in (REF, PORT):
        s = P.scheduler()
        h = s.submit("linreg", (X, y), version="int32", n_cores=4,
                     n_iters=5)
        t0 = time.monotonic()
        assert s.wait([h], timeout=0.05) is False
        assert time.monotonic() - t0 < 5.0
        s.drain()
        assert s.wait([h], timeout=WAIT)


# ---------------------------------------------------------------------------
# SLO admission: the cost model answers before anything runs.
# ---------------------------------------------------------------------------

def test_submit_slo_rejection_is_failed_not_crash(lin_data):
    X, y = lin_data

    def scenario(P):
        s = P.scheduler()
        h = s.submit("linreg", (X, y), version="int32", n_cores=4,
                     n_iters=400, max_modeled_seconds=1e-12)
        assert h.state is P.sched.JobState.FAILED
        assert isinstance(h.error, P.sched.SloViolation)
        assert "max_modeled_seconds" in str(h.error)
        assert s.idle
        assert s.metrics.counter("sched.slo_rejections").value == 1
        ok = s.submit("linreg", (X, y), version="int32", n_cores=4,
                      n_iters=10, fuse_steps=5, max_modeled_seconds=1e9)
        s.drain()
        assert ok.state is P.sched.JobState.DONE
        return s

    rs, ps = both(scenario)
    assert_same_jobs(rs.handles, ps.handles)
    assert counters(ps) == counters(rs)


def test_scheduler_default_slo_bound(lin_data):
    X, y = lin_data

    def scenario(P):
        s = P.scheduler(max_modeled_seconds=1e-12)
        h = s.submit("linreg", (X, y), version="int32", n_cores=4,
                     n_iters=50)
        assert h.state is P.sched.JobState.FAILED
        assert isinstance(h.error, P.sched.SloViolation)
        ok = s.submit("linreg", (X, y), version="int32", n_cores=4,
                      n_iters=10, fuse_steps=5, max_modeled_seconds=1e9)
        s.drain()
        assert ok.state is P.sched.JobState.DONE
        return s

    rs, ps = both(scenario)
    assert_same_jobs(rs.handles, ps.handles)
    assert counters(ps) == counters(rs)


def test_manifest_slo_rejected_whole(lin_data):
    def scenario(P):
        s = P.scheduler()
        doc = _manifest_doc(n_iters=200)
        doc["slo"] = {"max_modeled_seconds": 1e-12}
        with pytest.raises(P.sched.SloViolation,
                           match="makespan lower bound") as err:
            P.sched.submit_manifest(s, doc)
        assert s.idle
        assert s.metrics.counter(
            "sched.manifest_slo_rejections").value == 1
        del doc["slo"]
        handles = P.sched.submit_manifest(s, doc)
        s.drain()
        assert all(h.state is P.sched.JobState.DONE for h in handles)
        return s, str(err.value)

    (rs, rmsg), (ps, pmsg) = both(scenario)
    assert pmsg == rmsg
    assert_same_jobs(rs.handles, ps.handles)
    assert counters(ps) == counters(rs)


def test_manifest_service_default_slo(lin_data):
    """The service-wide bound applies when the manifest has no ``slo``
    section, and the manifest's own section wins over it."""
    def scenario(P):
        s = P.scheduler()
        doc = _manifest_doc(n_iters=50)
        with pytest.raises(P.sched.SloViolation):
            P.sched.submit_manifest(s, doc, max_modeled_seconds=1e-12)
        doc["slo"] = {"max_modeled_seconds": 1e9}
        handles = P.sched.submit_manifest(s, doc,
                                          max_modeled_seconds=1e-12)
        s.drain()
        return s, [h.state.value for h in handles]

    (rs, rstates), (ps, pstates) = both(scenario)
    assert pstates == rstates == ["done"]
    assert counters(ps) == counters(rs)


# ---------------------------------------------------------------------------
# Deadline (EDF) policy: ordering and eviction.
# ---------------------------------------------------------------------------

def test_deadline_policy_orders_queue(lin_data):
    X, y = lin_data

    def scenario(P):
        s = P.scheduler(cores=4, rank=4, policy="deadline")
        kw = dict(version="int32", n_cores=4, n_iters=10, fuse_steps=5)
        a = s.submit("linreg", (X, y), name="no-deadline", **kw)
        b = s.submit("linreg", (X, y), name="late", deadline_seconds=100.0,
                     **kw)
        c = s.submit("linreg", (X, y), name="soon", deadline_seconds=10.0,
                     **kw)
        s.drain()
        assert all(h.state is P.sched.JobState.DONE for h in (a, b, c))
        assert c.started_at < b.started_at < a.started_at
        return s

    rs, ps = both(scenario)
    assert_same_jobs(rs.handles, ps.handles)


def test_deadline_outranks_evicts_at_chunk_boundary(lin_data):
    X, y = lin_data

    def scenario(P):
        s = P.scheduler(cores=4, rank=4, policy="deadline", preemptive=True)
        kw = dict(version="int32", n_cores=4, n_iters=40, fuse_steps=4)
        victim = s.submit("linreg", (X, y), name="no-deadline", **kw)
        s.step()
        assert victim.state is P.sched.JobState.RUNNING
        urgent = s.submit("linreg", (X, y), name="urgent",
                          deadline_seconds=5.0, **kw)
        s.step()
        assert victim.preemptions == 1
        assert victim.state is P.sched.JobState.QUEUED
        assert urgent.state is P.sched.JobState.RUNNING
        s.drain()
        assert urgent.state is P.sched.JobState.DONE
        assert urgent.deadline_missed is False
        assert victim.state is P.sched.JobState.DONE and victim.iters == 40
        assert urgent.finished_at < victim.finished_at
        return s

    rs, ps = both(scenario)
    assert_same_jobs(rs.handles, ps.handles)
    assert counters(ps) == counters(rs)


def test_fifo_policy_ignores_deadline_ordering(lin_data):
    X, y = lin_data

    def scenario(P):
        s = P.scheduler(cores=4, rank=4)
        kw = dict(version="int32", n_cores=4, n_iters=10, fuse_steps=5)
        a = s.submit("linreg", (X, y), **kw)
        b = s.submit("linreg", (X, y), deadline_seconds=1e-3, **kw)
        s.drain()
        assert a.started_at < b.started_at
        assert b.deadline_missed or b.completion_latency >= 0.0
        return s

    rs, ps = both(scenario)
    assert_same_jobs(rs.handles, ps.handles)


def test_bad_policy_rejected():
    for P in (REF, PORT):
        with pytest.raises(ValueError, match="policy"):
            P.scheduler(policy="lifo")


# ---------------------------------------------------------------------------
# Manifest spool: mid-flight admission with sidecar verdicts.
# ---------------------------------------------------------------------------

def _sidecars(spool) -> dict:
    out = {}
    for name in sorted(os.listdir(spool)):
        if name.endswith(".status.json"):
            with open(os.path.join(spool, name)) as fh:
                rec = json.load(fh)
            rec["path"] = os.path.basename(rec["path"])
            if "reason" in rec:
                rec["reason"] = rec["reason"].replace(str(spool), "<spool>")
            out[name] = rec
    return out


def test_serve_manifests_mid_flight(tmp_path, lin_data):
    def scenario(P):
        s = P.scheduler()
        handles = P.sched.submit_manifest(
            s, _manifest_doc(n_iters=30, name="first"))
        spool = tmp_path / P.name
        spool.mkdir()
        (spool / "m1.json").write_text(
            json.dumps(_manifest_doc(n_iters=20, name="second")))

        def drop_late():
            time.sleep(0.3)
            (spool / "m2.json").write_text(
                json.dumps(_manifest_doc(n_iters=10, name="third")))

        t = threading.Thread(target=drop_late)
        t.start()
        records = P.sched.serve_manifests(s, str(spool), poll_interval=0.02,
                                          idle_timeout=1.0, handles=handles)
        t.join(WAIT)
        s.shutdown(wait=True, timeout=WAIT)
        assert [r["state"] for r in records] == ["accepted", "accepted"]
        assert len(handles) == 3
        assert all(h.state is P.sched.JobState.DONE for h in handles)
        for name in ("m1.json", "m2.json"):
            sidecar = json.loads((spool / (name + ".status.json"))
                                 .read_text())
            assert sidecar["state"] == "accepted" and sidecar["jobs"] == 1
        # a restarted watcher replays the durable verdicts, runs nothing
        again = P.sched.serve_manifests(s, str(spool), poll_interval=0.02,
                                        idle_timeout=0.2)
        s.shutdown(wait=True, timeout=WAIT)
        assert all(r["replayed"] for r in again) and len(again) == 2
        return handles, _sidecars(str(spool))

    (rh, rside), (ph, pside) = both(scenario)
    assert pside == rside
    assert sorted(job_sig(h)["w"] for h in ph) == sorted(
        job_sig(h)["w"] for h in rh)


def test_serve_manifests_rejects_bad_and_slo_manifests(tmp_path, lin_data):
    def scenario(P):
        s = P.scheduler()
        spool = tmp_path / P.name
        spool.mkdir()
        (spool / "a_ok.json").write_text(
            json.dumps(_manifest_doc(n_iters=10, name="ok")))
        bad = _manifest_doc(name="bad")
        bad["jobs"][0]["dataset"] = "nope"
        (spool / "b_bad.json").write_text(json.dumps(bad))
        slo = _manifest_doc(n_iters=300, name="slo")
        slo["slo"] = {"max_modeled_seconds": 1e-12}
        (spool / "c_slo.json").write_text(json.dumps(slo))
        (spool / "d_list.json").write_text("[1, 2]")
        hi = _manifest_doc(n_iters=5, name="hi")
        hi["priority"] = 3
        (spool / "e_hi.json").write_text(json.dumps(hi))
        (spool / "notes.txt").write_text("not a manifest")

        handles = []
        records = P.sched.serve_manifests(s, str(spool), poll_interval=0.02,
                                          idle_timeout=0.8,
                                          handles=handles)
        s.shutdown(wait=True, timeout=WAIT)
        by_name = {os.path.basename(r["path"]): r for r in records}
        assert by_name["a_ok.json"]["state"] == "accepted"
        assert by_name["b_bad.json"]["state"] == "rejected"
        assert "unknown dataset" in by_name["b_bad.json"]["reason"]
        assert by_name["c_slo.json"]["state"] == "rejected"
        assert "SloViolation" in by_name["c_slo.json"]["reason"]
        assert "notes.txt" not in by_name
        # the priority lane: the priority-3 manifest admits first
        assert os.path.basename(records[0]["path"]) == "e_hi.json"
        assert all(h.state is P.sched.JobState.DONE for h in handles)
        return ([os.path.basename(r["path"]) for r in records],
                _sidecars(str(spool)), [job_sig(h) for h in handles])

    ref, port = both(scenario)
    assert port == ref


# ---------------------------------------------------------------------------
# Sustained load + the CLI face (slow tier, as in the reference).
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_poisson_soak_no_lost_jobs(lin_data):
    X, y = lin_data

    def scenario(P):
        rng = np.random.RandomState(7)
        s = P.scheduler(cores=16, rank=4, policy="deadline")
        s.serve(poll_interval=0.005)
        handles = []
        for i in range(12):
            time.sleep(float(rng.exponential(0.02)))
            handles.append(s.submit(
                "linreg", (X, y), version="int32", n_cores=4,
                n_iters=15, fuse_steps=5, deadline_seconds=30.0,
                name=f"soak{i}"))
        assert s.wait(handles, timeout=WAIT)
        s.shutdown(wait=True, timeout=WAIT)
        assert all(h.state is P.sched.JobState.DONE for h in handles)
        assert s.latency_summary()["completion"]["count"] == 12
        assert s.metrics.counter("sched.serve_errors").value == 0
        return s

    rs, ps = both(scenario)
    assert [job_sig(h)["w"] for h in ps.handles] == [
        job_sig(h)["w"] for h in rs.handles]


@pytest.mark.slow
def test_cli_serve_accepts_manifest_mid_flight(tmp_path, lin_data):
    def scenario(P):
        d = tmp_path / P.name
        d.mkdir()
        manifest = d / "initial.json"
        manifest.write_text(json.dumps(_manifest_doc(n_iters=40,
                                                     name="initial")))
        spool = d / "spool"
        spool.mkdir()
        out = d / "report.json"

        def drop_late():
            time.sleep(0.3)
            (spool / "late.json").write_text(
                json.dumps(_manifest_doc(n_iters=10, name="late")))

        t = threading.Thread(target=drop_late)
        t.start()
        rc = P.cli([str(manifest), "--serve", "--spool", str(spool),
                    "--poll-interval", "0.02", "--idle-timeout", "1.0",
                    "--json", str(out)])
        t.join(WAIT)
        assert rc == 0
        report = json.loads(out.read_text())
        assert {j["state"] for j in report["jobs"]} == {"done"}
        assert len(report["jobs"]) == 2
        assert [m["state"] for m in report["manifests"]] == ["accepted"]
        assert report["scheduler"]["latency"]["completion"]["count"] == 2
        return sorted((j["name"], j["iters"], j["kernel_launches"])
                      for j in report["jobs"])

    ref, port = both(scenario)
    assert port == ref


# ---------------------------------------------------------------------------
# The card's manifest: examples/jobs.yaml as JSON.
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_manifest_is_the_example_translated(tmp_path):
    import yaml
    with open(os.path.join(ROOT, "examples", "jobs.yaml")) as fh:
        want = yaml.safe_load(fh)
    doc = _chip_smoke().JOBS_YAML_AS_JSON
    assert doc == want
    path = tmp_path / "jobs.json"
    path.write_text(json.dumps(doc))
    assert tsched.load_manifest(str(path)) == want


def test_manifest_without_pyyaml_names_the_fix(tmp_path, monkeypatch):
    """On a machine without PyYAML a YAML manifest is refused with the
    reference's message (rewrite it as JSON); JSON still loads."""
    import builtins
    real_import = builtins.__import__

    def no_yaml(name, *args, **kwargs):
        if name == "yaml":
            raise ImportError("no PyYAML here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    for P in (REF, PORT):
        with pytest.raises(ValueError, match="rewrite the manifest as JSON"):
            P.sched.load_manifest(os.path.join(ROOT, "examples",
                                               "jobs.yaml"))
    path = tmp_path / "jobs.json"
    path.write_text(json.dumps(_chip_smoke().JOBS_YAML_AS_JSON))
    assert tsched.load_manifest(str(path))["system"]["cores"] == 32
