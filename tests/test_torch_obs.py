"""The port's telemetry layer (``repro_torch.obs``) against the JAX
package's ``repro.obs``.

The same calls must give the same events in both packages (phase, name,
track, category, args; timestamps differ), the same ring-buffer drops,
the same Chrome trace documents, accepted or rejected alike by both
validators, and the same metrics readings.  The port's instrumented
layers (``System`` launches, fused chunks, shard transfers, broadcasts)
must emit the reference's event sequence for the same fit.
"""
import json
import os
import re
import subprocess
import sys
import threading

import jax
import jax.experimental
import numpy as np
import pytest

import repro.api as japi
import repro.obs as jobs
from repro.data import synthetic as jsyn
from repro.obs import trace as jtrace

import repro_torch.api as tapi
import repro_torch.obs as tobs
from repro_torch.obs import trace as ttrace
from repro_torch.systems.base import TransferStats, _MirrorStats

PKGS = {"port": (tobs, ttrace), "reference": (jobs, jtrace)}


@pytest.fixture(scope="module", autouse=True)
def x64_alias():
    """The reference's ``mul_round_f32`` calls the removed
    ``jax.experimental.enable_x64``; alias it for this file only."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        yield


@pytest.fixture
def tracers():
    """Both global tracers, enabled and clean, restored afterwards."""
    for t in (tobs.TRACER, jobs.TRACER):
        t.clear()
        t.enable()
    yield tobs.TRACER, jobs.TRACER
    for t in (tobs.TRACER, jobs.TRACER):
        t.disable()
        t.clear()


def _script(t):
    """One fixed sequence of tracer calls."""
    with t.span("outer", track="target:pim", cat="chunk", job="j0"):
        with t.span("inner", track="target:pim"):
            t.instant("preempt", track="job:j0", cat="elastic", step=3)
    t.counter("channel0.occupancy", 0.5, track="channels:pim")
    t.instant("resume", track="job:j0")
    with t.span("ckpt.save", "sched", "elastic", iters=4):
        pass


def _shape(events) -> list:
    return [(e["ph"], e["name"], e["track"], e["cat"], e["args"])
            for e in events]


def test_same_calls_give_the_same_events():
    port, ref = ttrace.Tracer(), jtrace.Tracer()
    for t in (port, ref):
        t.enable()
        _script(t)
    assert _shape(port.events()) == _shape(ref.events())
    for e in port.events():
        assert e["ts"] >= 0 and e.get("dur", 0) >= 0


def test_module_level_helpers_emit_to_the_global_tracer(tracers):
    port, ref = tracers
    for mod in (ttrace, jtrace):
        with mod.span("s", "a", "c", x=1):
            mod.instant("i", "a", "c", y=2)
        mod.counter("n", 3.0, "counters")
    assert _shape(port.events()) == _shape(ref.events())
    assert len(port) == 3


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_disabled_tracer_emits_nothing_and_shares_null_span(pkg):
    _, trace = PKGS[pkg]
    t = trace.Tracer()
    assert not t.enabled
    span = t.span("x", track="a")
    assert span is trace.NULL_SPAN
    with span:
        pass
    t.instant("i")
    t.counter("c", 1.0)
    assert len(t) == 0 and t.events() == []


@pytest.mark.parametrize("capacity,n", [(4, 10), (1, 3), (5, 5), (7, 2)])
def test_ring_buffer_drops_the_oldest_as_the_reference(capacity, n):
    names = {}
    for pkg, (_, trace) in PKGS.items():
        t = trace.Tracer(capacity=capacity)
        t.enable()
        for i in range(n):
            t.instant(f"e{i}")
        names[pkg] = [e["name"] for e in t.events()]
    assert names["port"] == names["reference"]
    assert names["port"] == [f"e{i}" for i in range(max(0, n - capacity),
                                                    n)]


def test_enable_resizes_the_buffer():
    t = ttrace.Tracer(capacity=10)
    t.enable()
    for i in range(6):
        t.instant(f"e{i}")
    t.enable(capacity=3)
    assert [e["name"] for e in t.events()] == ["e3", "e4", "e5"]
    t.clear()
    assert len(t) == 0
    assert ttrace.DEFAULT_CAPACITY == jtrace.DEFAULT_CAPACITY == 200_000


# ---------------------------------------------------------------------------
# Chrome trace export.
# ---------------------------------------------------------------------------

def _events():
    t = ttrace.Tracer()
    t.enable()
    _script(t)
    return t.events()


def test_chrome_trace_documents_equal_the_reference():
    events = _events()
    doc = tobs.to_chrome_trace(events)
    assert doc == jobs.to_chrome_trace(events)
    for validate in (tobs.validate_chrome_trace, jobs.validate_chrome_trace):
        validate(doc)
    assert tobs.track_names(doc) == jobs.track_names(doc) == {
        "target:pim", "job:j0", "channels:pim", "sched"}
    assert tobs.summarize(doc) == jobs.summarize(doc)


_BAD_DOCS = [
    {},
    {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "tid": 1,
                      "ts": 0.0}]},
    {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "tid": "x",
                      "ts": 0.0, "dur": 1.0}]},
    {"traceEvents": [{"ph": "Q", "name": "a", "pid": 1, "tid": 1,
                      "ts": 0.0}]},
    {"traceEvents": [{"ph": "i", "name": "a", "pid": 1, "tid": 1,
                      "ts": "0"}]},
    {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "tid": 1,
                      "ts": 0.0, "dur": -1.0}]},
    {"traceEvents": [
        {"ph": "X", "name": "a", "pid": 1, "tid": 1, "ts": 0.0, "dur": 10.0},
        {"ph": "X", "name": "b", "pid": 1, "tid": 1, "ts": 5.0,
         "dur": 10.0}]},
]


@pytest.mark.parametrize("i", range(len(_BAD_DOCS)))
def test_validators_reject_the_same_malformed_docs(i):
    for validate in (tobs.validate_chrome_trace, jobs.validate_chrome_trace):
        with pytest.raises(ValueError):
            validate(_BAD_DOCS[i])


def test_write_and_load_roundtrip_across_packages(tmp_path):
    path = os.path.join(str(tmp_path), "out", "trace.json")
    doc = tobs.write_chrome_trace(_events(), path)
    assert not os.path.exists(path + ".tmp")
    assert jobs.load_chrome_trace(path) == tobs.load_chrome_trace(path) \
        == doc
    jobs.validate_chrome_trace(jobs.load_chrome_trace(path))


def test_obs_exports_the_reference_names():
    assert sorted(tobs.__all__) == sorted(jobs.__all__)


def test_repro_trace_env_var_exports_on_exit(tmp_path):
    path = os.path.join(str(tmp_path), "env_trace.json")
    env = dict(os.environ, REPRO_TRACE=path,
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(os.path.dirname(__file__), "..", "src"),
                    os.environ.get("PYTHONPATH", "")]))
    subprocess.run(
        [sys.executable, "-c",
         "from repro_torch.obs import TRACER\n"
         "assert TRACER.enabled\n"
         "with TRACER.span('s', 'job:x'):\n"
         "    TRACER.instant('i', 'job:x')\n"],
        env=env, check=True, timeout=120)
    doc = tobs.load_chrome_trace(path)
    tobs.validate_chrome_trace(doc)
    assert tobs.track_names(doc) == {"job:x"}


# ---------------------------------------------------------------------------
# Metrics registry.
# ---------------------------------------------------------------------------

def _exercise(pkg):
    reg = pkg.MetricsRegistry()
    c = reg.counter("launches")
    c.inc(3)
    snap = reg.snapshot()
    c.inc(2)
    reg.gauge("occupancy").set(0.75)
    h = reg.histogram("ratio", bounds=(1.0, 10.0))
    for v in (0.5, 1.0, 5.0, 50.0):
        h.observe(v)
    d = reg.histogram("drift")
    for v in (0.001, 0.05, 1.0, 3.0, 7e3, 2e6):
        d.observe(v)
    return (reg.delta(snap), reg.snapshot(), reg.to_dict(), reg.names(),
            h.delta({"bounds": [1.0, 10.0], "buckets": [1, 0, 0],
                     "count": 1, "total": 0.5}))


def test_metrics_readings_equal_the_reference():
    port, ref = _exercise(tobs), _exercise(jobs)
    assert port == ref
    assert port[0]["launches"] == 2
    assert port[1]["ratio"]["buckets"] == [2, 1, 1]
    assert tobs.DRIFT_BUCKETS == jobs.DRIFT_BUCKETS
    json.dumps(port[2])


def test_registry_parent_mirroring_and_kind_mismatch():
    parent = tobs.MetricsRegistry()
    a, b = (tobs.MetricsRegistry(parent=parent) for _ in range(2))
    a.counter("x").inc(3)
    b.counter("x").inc(4)
    a.histogram("h").observe(1.0)
    b.histogram("h").observe(2.0)
    a.gauge("g").set(2.5)
    assert parent.counter("x").value == 7
    assert parent.histogram("h").count == 2
    assert parent.gauge("g").value == 2.5
    assert a.counter("x").value == 3 and b.counter("x").value == 4
    with pytest.raises(TypeError):
        a.gauge("x")
    with pytest.raises(ValueError):
        tobs.Histogram(bounds=())
    h = tobs.Histogram(bounds=(1.0,))
    with pytest.raises(ValueError, match="bounds"):
        h.delta({"bounds": [2.0], "buckets": [0, 0], "count": 0,
                 "total": 0.0})


def test_concurrent_mirrored_metric_increments_are_exact():
    parent = tobs.MetricsRegistry()
    n_threads, n_incs = 8, 2000
    children = [tobs.MetricsRegistry(parent=parent)
                for _ in range(n_threads)]
    for child in children:
        child.counter("steps")

    def work(child):
        c = child.counter("steps")
        h = child.histogram("seconds", bounds=(1.0, 10.0))
        for i in range(n_incs):
            c.inc()
            h.observe(float(i % 3))

    threads = [threading.Thread(target=work, args=(c,)) for c in children]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert parent.counter("steps").value == n_threads * n_incs
    hist = parent.histogram("seconds", bounds=(1.0, 10.0))
    assert hist.count == sum(hist.buckets) == n_threads * n_incs
    assert all(c.counter("steps").value == n_incs for c in children)


def test_concurrent_mirror_stats_increments_are_exact():
    parent = TransferStats()
    n_threads, n_incs = 8, 2000
    mirrors = [_MirrorStats(parent) for _ in range(n_threads)]
    stop = threading.Event()
    seen = []

    def bump(m):
        for _ in range(n_incs):
            m.cpu_to_pim += 3
            m.host_syncs += 1

    def read():
        while not stop.is_set():
            seen.append(parent.snapshot().cpu_to_pim)

    threads = [threading.Thread(target=bump, args=(m,)) for m in mirrors]
    reader = threading.Thread(target=read)
    reader.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    reader.join()
    assert parent.cpu_to_pim == n_threads * n_incs * 3
    assert parent.host_syncs == n_threads * n_incs
    assert all(m.cpu_to_pim == n_incs * 3 for m in mirrors)
    assert seen == sorted(seen) and all(v % 3 == 0 for v in seen)


# ---------------------------------------------------------------------------
# The instrumented layers.
# ---------------------------------------------------------------------------

def _normalized(events) -> list:
    """Events as (phase, name, track, category, args), with the
    reference's kernel-backend tag and a chunk name's learning-rate and
    sample-count suffix dropped (names the port's programs do not
    carry)."""
    out = []
    for e in events:
        name = re.sub(r"/be=[^/]*", "", e["name"])
        name = re.sub(r"/lr[^/]*/n\d+$", "", name)
        out.append((e["ph"], name, e["track"], e["cat"], e["args"]))
    return out


@pytest.mark.parametrize("kind", ["pim", "host"])
@pytest.mark.parametrize("workload,version,fuse", [
    ("linreg", "int32", 1), ("linreg", "int32", 2),
    ("logreg", "int32_lut_wram", 1), ("kmeans", "int16", 1)])
def test_a_traced_fit_emits_the_reference_events(tracers, kind, workload,
                                                 version, fuse):
    port, ref = tracers
    X, y, _ = jsyn.make_linear_dataset(200, 5, seed=0)
    if workload == "logreg":
        y = (y > np.median(y)).astype(np.float32)
    if workload == "kmeans":
        y = None
        params = dict(n_clusters=3, max_iter=4, tol=0.0, fuse_steps=fuse)
    else:
        params = dict(n_iters=4, fuse_steps=fuse)
    ts = tapi.make_system(kind, n_cores=4, device="cpu")
    js = japi.make_system(kind, n_cores=4)
    tapi.make_estimator(workload, version=version, system=ts,
                        **params).fit(ts.put(X, y))
    japi.make_estimator(workload, version=version, system=js,
                        **params).fit(js.put(X, y))
    got, want = _normalized(port.events()), _normalized(ref.events())
    assert got == want
    launches = [e for e in got if e[3] == "launch"]
    assert launches and all(e[2] == f"system:{kind}" for e in launches)
    doc = tobs.to_chrome_trace(port.events())
    tobs.validate_chrome_trace(doc)
    jobs.validate_chrome_trace(doc)


def test_an_untraced_fit_emits_nothing():
    tobs.TRACER.disable()
    tobs.TRACER.clear()
    X, y, _ = jsyn.make_linear_dataset(100, 4, seed=0)
    ts = tapi.make_system("pim", n_cores=4, device="cpu")
    tapi.make_estimator("linreg", version="int32", n_iters=3,
                        system=ts).fit(ts.put(X, y))
    assert len(tobs.TRACER) == 0


def test_launch_span_builds_no_name_while_disabled():
    """The overhead contract: with tracing off, ``_launch_span`` returns
    the shared no-op without reading the kernel key."""
    tobs.TRACER.disable()
    ts = tapi.make_system("pim", n_cores=4, device="cpu")
    assert ts._launch_span("map_reduce", None) is ttrace.NULL_SPAN
    assert ts._trace_track == "system:pim"
    assert tapi.make_system("gpu-model", n_cores=2,
                            device="cpu")._trace_track == "system:gpu-model"
