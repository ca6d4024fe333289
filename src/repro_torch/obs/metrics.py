"""Metrics registry: counters, gauges, histograms.

A copy of ``repro.obs.metrics``.

One structured home for the runtime's numeric telemetry, with the two
semantics every existing ad-hoc stats object already needed:

  ``snapshot()/delta()``   attributable readings when many jobs share
                           one instrument (the ``TransferStats``
                           discipline);
  parent mirroring         a child registry forwards every increment to
                           its parent, so slice-scoped metrics stay
                           per-job readable while global totals keep
                           accumulating — the ``_MirrorStats`` /
                           ``_MirrorGpuReport`` pattern
                           generalized to arbitrary metrics.

In the reference the scheduler owns a registry for its control-plane
counters (admissions, evictions, checkpoints, drift samples); the port's
scheduler is not ported yet.

Histograms are fixed-boundary (no allocation per observe): ``bounds``
gives the upper edges; observations above the last edge land in the
overflow bucket.  ``DRIFT_BUCKETS`` is the log ladder for
modeled-vs-measured wall-time ratios (container wall time over modeled
UPMEM seconds routinely sits orders of magnitude above 1 — the point is
*stability*, not unity).
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Optional, Sequence, Tuple

#: log-spaced ratio buckets for measured/modeled drift histograms
DRIFT_BUCKETS: Tuple[float, ...] = (
    0.01, 0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 100.0, 1e3, 1e4, 1e5, 1e6)

#: One process-wide reentrant lock serializes every metric write AND the
#: registry's lazy creation path.  The scheduler's background drain
#: thread (serve mode) increments these concurrently
#: with caller-thread ``stats()``/``metrics()`` reads; a single coarse
#: lock keeps parent-mirroring chains atomic end to end (child += n and
#: parent += n commit together) at negligible cost — metric updates are
#: control-plane, not hot-loop.  Reentrant because a mirrored child's
#: update calls the parent's under the same lock.
_LOCK = threading.RLock()


class Counter:
    """Monotonic counter; increments forward to a parent counter."""

    __slots__ = ("value", "_parent")

    def __init__(self, parent: Optional["Counter"] = None):
        self.value = 0
        self._parent = parent

    def inc(self, n: int = 1) -> None:
        with _LOCK:
            self.value += n
            if self._parent is not None:
                self._parent.inc(n)

    def snapshot(self) -> int:
        return self.value

    def delta(self, snapshot: int) -> int:
        return self.value - snapshot


class Gauge:
    """Point-in-time value; sets propagate to the parent (last write
    wins there, exactly as a shared gauge should behave)."""

    __slots__ = ("value", "_parent")

    def __init__(self, parent: Optional["Gauge"] = None):
        self.value = 0.0
        self._parent = parent

    def set(self, value: float) -> None:
        with _LOCK:
            self.value = float(value)
            if self._parent is not None:
                self._parent.set(value)

    def snapshot(self) -> float:
        return self.value

    def delta(self, snapshot: float) -> float:
        return self.value - snapshot


class Histogram:
    """Fixed-boundary histogram with count/total/min/max.

    ``bounds`` are inclusive upper edges; bucket i counts observations
    ``<= bounds[i]`` (and the final bucket everything above the last
    edge).  ``observe`` forwards to the parent histogram when mirrored.
    """

    __slots__ = ("bounds", "buckets", "count", "total", "min", "max",
                 "_parent")

    def __init__(self, bounds: Sequence[float] = DRIFT_BUCKETS,
                 parent: Optional["Histogram"] = None):
        self.bounds = tuple(sorted(float(b) for b in bounds))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket edge")
        self.buckets = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._parent = parent

    def observe(self, value: float) -> None:
        value = float(value)
        with _LOCK:
            self.buckets[bisect.bisect_left(self.bounds, value)] += 1
            self.count += 1
            self.total += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)
            if self._parent is not None:
                self._parent.observe(value)

    @property
    def mean(self) -> Optional[float]:
        return (self.total / self.count) if self.count else None

    def to_dict(self) -> dict:
        with _LOCK:   # consistent multi-field reading vs. observe()
            return {"bounds": list(self.bounds),
                    "buckets": list(self.buckets),
                    "count": self.count, "total": self.total,
                    "mean": self.mean, "min": self.min, "max": self.max}

    def snapshot(self) -> dict:
        return self.to_dict()

    def delta(self, snapshot: dict) -> dict:
        """Observations since ``snapshot`` (bucket-wise difference;
        min/max cannot be un-merged and are reported as None)."""
        if tuple(snapshot.get("bounds", ())) != self.bounds:
            raise ValueError("histogram delta across different bounds")
        buckets = [a - b for a, b in zip(self.buckets,
                                         snapshot["buckets"])]
        count = self.count - snapshot["count"]
        total = self.total - snapshot["total"]
        return {"bounds": list(self.bounds), "buckets": buckets,
                "count": count, "total": total,
                "mean": (total / count) if count else None,
                "min": None, "max": None}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Named metrics with registry-level snapshot/delta and mirroring.

    ``MetricsRegistry(parent=global_registry)`` creates a *child* whose
    metrics forward every increment/observation to the same-named
    metric of the parent (created there on demand with matching type) —
    per-slice attribution without double bookkeeping.
    """

    def __init__(self, parent: Optional["MetricsRegistry"] = None):
        self._parent = parent
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, kind: str, **kwargs):
        with _LOCK:
            metric = self._metrics.get(name)
            if metric is None:
                parent_metric = (self._parent._get(name, kind, **kwargs)
                                 if self._parent is not None else None)
                metric = _KINDS[kind](parent=parent_metric, **kwargs)
                self._metrics[name] = metric
            elif not isinstance(metric, _KINDS[kind]):
                raise TypeError(
                    f"metric {name!r} is a {type(metric).__name__}, "
                    f"not a {kind}")
            return metric

    def counter(self, name: str) -> Counter:
        return self._get(name, "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get(name, "gauge")

    def histogram(self, name: str,
                  bounds: Sequence[float] = DRIFT_BUCKETS) -> Histogram:
        return self._get(name, "histogram", bounds=bounds)

    def names(self) -> tuple:
        with _LOCK:
            return tuple(sorted(self._metrics))

    def snapshot(self) -> dict:
        """Plain-value snapshot of every metric (JSON-serializable)."""
        with _LOCK:
            return {name: m.snapshot()
                    for name, m in sorted(self._metrics.items())}

    def delta(self, snapshot: dict) -> dict:
        """Per-metric change since ``snapshot``.  Metrics created after
        the snapshot delta against a zero baseline."""
        with _LOCK:
            out = {}
            for name, m in sorted(self._metrics.items()):
                if name in snapshot:
                    out[name] = m.delta(snapshot[name])
                elif isinstance(m, Histogram):
                    out[name] = m.to_dict()
                else:
                    out[name] = m.snapshot()
            return out

    def to_dict(self) -> dict:
        with _LOCK:
            return {name: (m.to_dict() if isinstance(m, Histogram)
                           else m.value)
                    for name, m in sorted(self._metrics.items())}
