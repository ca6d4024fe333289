"""Job checkpoints on disk: snapshot dicts through the atomic format.

Port of ``repro.elastic.checkpoint``.  One job, one checkpoint directory
(``<root>/<job-key>/``) of ``step_<iters>/`` entries written by
:func:`repro_torch.train.checkpoint.save`: the tmp-dir-and-rename publish
and ``keep_last`` pruning, so a crash mid-save never shadows a good
checkpoint.

The snapshot's ``arrays`` section is the saved tree; its ``meta`` section
(nested under ``snap_meta``) and the scheduler-level envelope (workload,
version, params, fingerprint, accounting) ride in the manifest's
``extra_meta``.  :func:`load_snapshot` rebuilds the exact ``{"arrays",
"meta"}`` dict a trainer's ``fit_steps(state=...)`` consumes.  The keys
are the reference's, so a snapshot saved by either package loads in the
other.
"""
from __future__ import annotations

import os
import re
from typing import Optional, Tuple

from ..obs.trace import TRACER
from ..train import checkpoint as ckpt
from .state import SCHEMA_VERSION

#: manifest keys that belong to the envelope, not to the trainer's meta
_ENVELOPE_KEYS = ("elastic_schema", "workload", "version", "params",
                  "fingerprint", "system_kind", "iters", "steps",
                  "accounting")


def job_dir(root: str, key: str) -> str:
    """Filesystem-safe per-job checkpoint directory under ``root``."""
    safe = re.sub(r"[^A-Za-z0-9._-]+", "_", key)
    return os.path.join(root, safe)


def save_snapshot(directory: str, snapshot: dict, *, envelope: dict,
                  keep_last: int = 2) -> str:
    """Write one job snapshot atomically; returns the checkpoint path.

    ``envelope`` carries the job's identity and accounting (workload,
    version, params, fingerprint, system_kind, iters, steps); the
    trainer's ``meta`` section is nested under ``snap_meta`` so its keys
    can never collide with the envelope's or the base format's.
    """
    iters = int(envelope.get("iters", 0))
    extra = {"elastic_schema": SCHEMA_VERSION,
             "snap_meta": dict(snapshot.get("meta", {})),
             **envelope}
    if not TRACER.enabled:
        return ckpt.save(directory, iters,
                         dict(snapshot.get("arrays", {})),
                         keep_last=keep_last, extra_meta=extra)
    with TRACER.span("ckpt.save", "sched", "elastic", iters=iters):
        return ckpt.save(directory, iters,
                         dict(snapshot.get("arrays", {})),
                         keep_last=keep_last, extra_meta=extra)


def load_snapshot(directory: str,
                  step: Optional[int] = None) -> Tuple[dict, dict]:
    """``(snapshot, envelope)`` from the latest (or given) checkpoint.

    Raises FileNotFoundError when the directory holds no checkpoint.
    """
    if step is None:
        step = ckpt.latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint under {directory!r}")
    arrays, manifest = ckpt.restore_raw(directory, step)
    schema = manifest.get("elastic_schema")
    if schema != SCHEMA_VERSION:
        raise ValueError(
            f"checkpoint {directory!r} step {step} has elastic schema "
            f"{schema!r}; this runtime reads {SCHEMA_VERSION}")
    snapshot = {"arrays": arrays,
                "meta": dict(manifest.get("snap_meta", {}))}
    envelope = {k: manifest[k] for k in _ENVELOPE_KEYS if k in manifest}
    return snapshot, envelope


def has_checkpoint(directory: str) -> bool:
    return ckpt.latest_step(directory) is not None
