"""The telemetry layer (port of ``repro.obs``).

  :mod:`repro_torch.obs.trace`         span tracer (ring buffer, global TRACER)
  :mod:`repro_torch.obs.chrome_trace`  Chrome trace-event JSON export
  :mod:`repro_torch.obs.metrics`       counters / gauges / histograms registry
  :mod:`repro_torch.obs.format`        column-spec table rendering
  :mod:`repro_torch.obs.runmeta`       provenance envelope for persisted JSON

Environment hook: setting ``REPRO_TRACE=/path/to/trace.json`` enables the
global tracer at import time and registers an atexit export of the buffer
to that path, so any entry point becomes traceable without code changes.
"""
from __future__ import annotations

import atexit
import os

from .chrome_trace import (load_chrome_trace, summarize, to_chrome_trace,
                           track_names, validate_chrome_trace,
                           write_chrome_trace)
from .format import Column, format_bytes, format_ratio, render_table
from .metrics import DRIFT_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry
from .runmeta import run_meta, write_json
from .trace import TRACER, Tracer, counter, instant, span

__all__ = [
    "TRACER", "Tracer", "span", "instant", "counter",
    "to_chrome_trace", "write_chrome_trace", "validate_chrome_trace",
    "load_chrome_trace", "track_names", "summarize",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DRIFT_BUCKETS",
    "Column", "render_table", "format_bytes", "format_ratio",
    "run_meta", "write_json",
]


def _install_env_trace() -> None:
    path = os.environ.get("REPRO_TRACE")
    if not path:
        return
    TRACER.enable()

    def _export() -> None:
        events = TRACER.events()
        if events:
            write_chrome_trace(events, path)

    atexit.register(_export)


_install_env_trace()
