"""Telemetry the launch CLIs share (port of part of ``repro.obs``).

  :mod:`repro_torch.obs.format`   column-spec table rendering
  :mod:`repro_torch.obs.runmeta`  provenance envelope for persisted JSON

The reference's tracer, Chrome-trace export and metrics registry are
not ported yet.
"""
from __future__ import annotations

from .format import Column, format_bytes, format_ratio, render_table
from .runmeta import run_meta, write_json

__all__ = ["Column", "format_bytes", "format_ratio", "render_table",
           "run_meta", "write_json"]
