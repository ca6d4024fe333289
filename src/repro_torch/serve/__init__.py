"""Serving: the slot-based batch engine (port of ``repro.serve``)."""
