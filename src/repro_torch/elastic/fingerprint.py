"""Config + dataset fingerprints: what makes a checkpoint resumable.

A copy of ``repro.elastic.fingerprint``: equal inputs give equal strings
in both packages, so a checkpoint fingerprinted by either is recognised
by the other.

A chunk-boundary snapshot is only valid against the *same* training
problem: same host arrays, same workload/version/hyperparameters.  The
fingerprint is a sha256 over both, stored inside every job checkpoint
and re-derived at resume time — a mismatch (edited
manifest, regenerated dataset, different seed) refuses to resume
instead of silently continuing a different fit.
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, Mapping, Optional

import numpy as np


def _hash_array(h, arr: Optional[np.ndarray]) -> None:
    if arr is None:
        h.update(b"none")
        return
    a = np.ascontiguousarray(arr)
    h.update(str(a.shape).encode())
    h.update(str(a.dtype).encode())
    h.update(a.tobytes())


def _jsonable(value: Any) -> Any:
    """Params may hold numpy scalars / enums; normalize for hashing."""
    if isinstance(value, (np.integer, np.floating)):
        return value.item()
    return value


def dataset_fingerprint(X: np.ndarray,
                        y: Optional[np.ndarray] = None) -> str:
    h = hashlib.sha256()
    _hash_array(h, np.asarray(X))
    _hash_array(h, None if y is None else np.asarray(y))
    return h.hexdigest()[:32]


def spec_fingerprint(workload: str, version: str,
                     params: Mapping[str, Any]) -> str:
    h = hashlib.sha256()
    doc = {"workload": workload, "version": version,
           "params": {k: _jsonable(v) for k, v in sorted(params.items())}}
    h.update(json.dumps(doc, sort_keys=True, default=str).encode())
    return h.hexdigest()[:32]


def job_fingerprint(workload: str, version: str,
                    params: Mapping[str, Any], X: np.ndarray,
                    y: Optional[np.ndarray] = None) -> str:
    """The combined identity a checkpoint is bound to."""
    return (spec_fingerprint(workload, version, params)
            + "-" + dataset_fingerprint(X, y))
