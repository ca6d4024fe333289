"""Chrome trace-event JSON export of the tracer buffer.

A copy of ``repro.obs.chrome_trace``.  Renders
:mod:`repro_torch.obs.trace` events as the Trace Event Format that
``chrome://tracing`` and Perfetto load: the scheduler timeline becomes
one row per target System, per job, and per memory channel, with
elastic preempt/resume/retry markers as instant events and channel
occupancy as counter series.

Track mapping: the tracer's free-form ``track`` strings carry a
``group:member`` convention (``target:pim``, ``job:job0:linreg/int32``,
``channels:pim``).  The exporter assigns one Chrome *process* (pid) per
group and one *thread* (tid) per distinct track, then emits ``M``
metadata events naming both — so Perfetto groups the rows exactly along
the repo's span taxonomy.  Assignment order is first-appearance, which
is deterministic for a deterministic event stream.

``validate_chrome_trace`` is the schema contract the tests assert:
required fields per phase, numeric timestamps, and proper span
containment per (pid, tid) row.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

#: phases this exporter emits (a subset of the trace-event format)
_PHASES = ("X", "i", "C", "M")


def to_chrome_trace(events: List[dict]) -> dict:
    """Convert tracer events to a ``{"traceEvents": [...]}`` document.

    Events keep their buffer order (which is time order per track);
    metadata rows for every pid/tid are prepended so viewers label the
    tracks before the first sample arrives."""
    pids: dict = {}
    tids: dict = {}
    body = []
    for ev in events:
        track = str(ev.get("track", "main"))
        group = track.split(":", 1)[0]
        pid = pids.setdefault(group, len(pids) + 1)
        if track not in tids:
            tids[track] = (pid, len(tids) + 1)
        tid = tids[track][1]
        out = {
            "ph": ev["ph"],
            "name": str(ev["name"]),
            "cat": str(ev.get("cat", "default")),
            "ts": float(ev["ts"]),
            "pid": pid,
            "tid": tid,
            "args": dict(ev.get("args") or {}),
        }
        if ev["ph"] == "X":
            out["dur"] = max(0.0, float(ev.get("dur", 0.0)))
        elif ev["ph"] == "i":
            out["s"] = "t"      # thread-scoped instant
        body.append(out)

    meta = []
    for group, pid in pids.items():
        meta.append({"ph": "M", "name": "process_name", "pid": pid,
                     "tid": 0, "ts": 0.0,
                     "args": {"name": group}})
    for track, (pid, tid) in tids.items():
        meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                     "tid": tid, "ts": 0.0,
                     "args": {"name": track}})
    return {"traceEvents": meta + body, "displayTimeUnit": "ms"}


def write_chrome_trace(events: List[dict], path: str) -> dict:
    """Export ``events`` to ``path`` (atomic tmp+rename); returns the
    document."""
    doc = to_chrome_trace(events)
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh)
    os.replace(tmp, path)
    return doc


def track_names(doc: dict) -> set:
    """The track (thread) names declared by a trace document."""
    return {ev["args"]["name"] for ev in doc.get("traceEvents", [])
            if ev.get("ph") == "M" and ev.get("name") == "thread_name"}


def validate_chrome_trace(doc: dict) -> None:
    """Assert the trace-event schema; raises ``ValueError`` on the
    first violation.

    Checks:
      * top level is ``{"traceEvents": [...]}``;
      * every event has ``ph``/``name``/``pid``/``tid``/``ts``, with
        integer pid/tid and numeric ts;
      * ``X`` events carry a non-negative ``dur``;
      * per (pid, tid) row, ``X`` spans properly nest — a span either
        starts after the enclosing one ends or lies fully inside it.
    """
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace document must carry a traceEvents list")
    rows: dict = {}
    for i, ev in enumerate(events):
        for field in ("ph", "name", "pid", "tid", "ts"):
            if field not in ev:
                raise ValueError(f"event {i} missing {field!r}: {ev}")
        if ev["ph"] not in _PHASES:
            raise ValueError(f"event {i} has unknown phase {ev['ph']!r}")
        if not isinstance(ev["pid"], int) or not isinstance(ev["tid"], int):
            raise ValueError(f"event {i} pid/tid must be ints: {ev}")
        if not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"event {i} ts must be numeric: {ev}")
        if ev["ph"] == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i} X-span needs dur >= 0: {ev}")
            rows.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    for key, spans in rows.items():
        _check_nesting(key, spans)


def _check_nesting(row, spans: List[dict]) -> None:
    """Spans on one row must form a forest: children inside parents."""
    stack: List[tuple] = []     # (start, end) of open ancestors
    for ev in sorted(spans, key=lambda e: (e["ts"], -e["dur"])):
        start, end = ev["ts"], ev["ts"] + ev["dur"]
        while stack and start >= stack[-1][1]:
            stack.pop()
        if stack and end > stack[-1][1] + 1e-6:
            raise ValueError(
                f"row {row}: span {ev['name']!r} [{start}, {end}] "
                f"overlaps its enclosing span ending at {stack[-1][1]}")
        stack.append((start, end))


def load_chrome_trace(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def summarize(doc: dict) -> dict:
    """Per-track event counts + span time (quick CLI sanity line)."""
    names = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[(ev["pid"], ev["tid"])] = ev["args"]["name"]
    out: dict = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "M":
            continue
        track = names.get((ev["pid"], ev["tid"]),
                          f"{ev['pid']}:{ev['tid']}")
        row = out.setdefault(track, {"events": 0, "span_us": 0.0})
        row["events"] += 1
        if ev["ph"] == "X":
            row["span_us"] += ev.get("dur", 0.0)
    return out
