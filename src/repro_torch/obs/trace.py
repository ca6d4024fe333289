"""Span tracer: the event source of the telemetry layer.

A copy of ``repro.obs.trace``.  One process-global :class:`Tracer`
collects timing *events* — nestable spans, instant markers and counter
samples — into a thread-safe ring buffer.  The port's execution layers
emit to it: ``System`` kernel launches and fused chunks
(systems/base.py), dataset shard transfers (api/dataset.py), model
broadcasts (systems/pim.py), job checkpoints (elastic/checkpoint.py) and
allocator channel occupancy (sched/allocator.py).  The buffer renders to
a Chrome trace-event file via :mod:`repro_torch.obs.chrome_trace` (or the
``REPRO_TRACE`` environment variable, :mod:`repro_torch.obs`).

Overhead contract: the tracer is **disabled by default** and a disabled
call is one attribute check plus a constant return — no event dict, no
timestamp, no lock.  Hot paths that would pay even for building a span
*name* guard on ``TRACER.enabled`` first (the ``_launch_span`` idiom in
systems/base.py).  Enabled, each event is one ``perf_counter`` pair and
one deque append; the ring buffer (default 200k events) bounds memory
by dropping the *oldest* events.

Tracks: every event names a ``track`` — a free-form string rendered as
its own timeline row:

  ``sched``             scheduler control flow, job checkpoints
  ``target:<name>``     per-execution-System timeline of chunk spans
  ``job:<name>``        per-job timeline (one row per tenant)
  ``system:<kind>``     kernel launches / transfers of one System kind
  ``channels:<name>``   per-memory-channel occupancy counters

Timestamps are microseconds of ``time.perf_counter()`` since tracer
construction (monotonic; wall-clock anchoring travels in the run
metadata envelope, repro_torch/obs/runmeta.py).  Spans measure the
*host*: on a CUDA device a launch span covers the enqueue of the
launch's kernels, which return before the card has run them (as JAX's
async dispatch does in the reference), plus whatever the call itself
waits for (a host reduce's copy).  No span synchronizes the device.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

#: default ring-buffer capacity (events); ~100 B/event -> ~20 MB ceiling
DEFAULT_CAPACITY = 200_000


class _NullSpan:
    """Shared no-op context manager returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """An open span; appends one complete ("X") event on exit."""

    __slots__ = ("_tracer", "_name", "_track", "_cat", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, track: str, cat: str,
                 args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._track = track
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = self._tracer.now_us()
        return self

    def __exit__(self, *exc):
        t = self._tracer
        t._append({"ph": "X", "name": self._name, "cat": self._cat,
                   "track": self._track, "ts": self._t0,
                   "dur": t.now_us() - self._t0,
                   "args": self._args or {}})
        return False


class Tracer:
    """Thread-safe ring buffer of trace events.

    ``enabled`` is the single hot-path gate: every emitting method
    checks it first and returns immediately when off.  Events are plain
    dicts (``ph``/``name``/``cat``/``track``/``ts``[/``dur``]/``args``)
    — the exporter maps ``track`` strings onto Chrome trace pid/tid
    pairs (repro_torch/obs/chrome_trace.py)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.enabled = False
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()

    # -- control -------------------------------------------------------------

    def enable(self, capacity: Optional[int] = None) -> None:
        """Turn event collection on (idempotent).  ``capacity`` resizes
        the ring buffer, discarding buffered events."""
        if capacity is not None and capacity != self._events.maxlen:
            with self._lock:
                self._events = deque(self._events, maxlen=capacity)
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def now_us(self) -> float:
        """Microseconds since tracer construction (monotonic)."""
        return (time.perf_counter() - self._epoch) * 1e6

    def _append(self, event: dict) -> None:
        # deque.append with maxlen is atomic under the GIL; the lock
        # only guards structural operations (events()/clear()/resize)
        self._events.append(event)

    # -- emission ------------------------------------------------------------

    def span(self, name: str, track: str = "main", cat: str = "default",
             **args):
        """Context manager timing a nested span on ``track``.

        Disabled: returns the shared no-op immediately.  Spans on one
        track must nest (the exporter validates containment) — which
        they do by construction when emitted from ``with`` blocks on a
        single thread per track."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, track, cat, args or None)

    def instant(self, name: str, track: str = "main",
                cat: str = "default", **args) -> None:
        """A zero-duration marker (elastic preempt/resume/retry/...)."""
        if not self.enabled:
            return
        self._append({"ph": "i", "name": name, "cat": cat, "track": track,
                      "ts": self.now_us(), "args": args})

    def counter(self, name: str, value: float, track: str = "counters",
                cat: str = "counter") -> None:
        """Sample a numeric series (e.g. per-channel occupancy)."""
        if not self.enabled:
            return
        self._append({"ph": "C", "name": name, "cat": cat, "track": track,
                      "ts": self.now_us(), "args": {"value": value}})

    # -- inspection ----------------------------------------------------------

    def events(self) -> list:
        """Snapshot of the buffered events (oldest first)."""
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        return len(self._events)


#: the process-global tracer every instrumentation site emits to
TRACER = Tracer()


def span(name: str, track: str = "main", cat: str = "default", **args):
    return TRACER.span(name, track, cat, **args)


def instant(name: str, track: str = "main", cat: str = "default",
            **args) -> None:
    TRACER.instant(name, track, cat, **args)


def counter(name: str, value: float, track: str = "counters") -> None:
    TRACER.counter(name, value, track)
