"""Run-metadata envelope for persisted results.

Port of ``repro.obs.runmeta``.  A JSON record written into
``benchmarks/out/`` is unattributable once the tree moves without its
provenance; :func:`run_meta` captures it:

  ``git_sha``        commit the run was taken at (None outside a repo)
  ``git_dirty``      whether the worktree had uncommitted changes
  ``timestamp``      UTC ISO-8601 wall-clock instant
  ``torch_version``  the library executing the kernels
  ``gpu``            the card's name and power limit as
                     ``nvidia-smi --query-gpu=name,power.limit
                     --format=csv,noheader`` prints them (None without a
                     card)
  ``python`` / ``platform``  interpreter and host identification

:func:`write_json` stamps the envelope under a ``run_meta`` key and
writes atomically (tmp + rename).
"""
from __future__ import annotations

import json
import os
import platform as _platform
import subprocess
import sys
from datetime import datetime, timezone
from typing import Optional


def _run(args, cwd: Optional[str] = None) -> Optional[str]:
    try:
        out = subprocess.run(args, cwd=cwd, capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    if out.returncode != 0:
        return None
    return out.stdout.strip()


def gpu_name_and_power_limit() -> Optional[str]:
    """The first card's ``name, power.limit`` line from nvidia-smi, or
    None when there is no card (or no nvidia-smi)."""
    import torch
    if not torch.cuda.is_available():
        return None
    out = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    return out.splitlines()[0].strip() if out else None


def run_meta(cwd: Optional[str] = None) -> dict:
    """The provenance envelope; every field degrades to None rather than
    raising (git absent, no card, ...)."""
    import torch
    cwd = cwd or os.path.dirname(os.path.abspath(__file__))
    sha = _run(["git", "rev-parse", "HEAD"], cwd)
    status = _run(["git", "status", "--porcelain"], cwd)
    return {
        "git_sha": sha,
        "git_dirty": bool(status) if status is not None else None,
        "timestamp": datetime.now(timezone.utc).isoformat(),
        "torch_version": torch.__version__,
        "gpu": gpu_name_and_power_limit(),
        "python": sys.version.split()[0],
        "platform": _platform.platform(),
    }


def write_json(path: str, payload: dict, indent: int = 2) -> dict:
    """Stamp ``payload["run_meta"]`` and write atomically; returns the
    stamped payload."""
    payload = dict(payload)
    payload["run_meta"] = run_meta()
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, indent=indent)
    os.replace(tmp, path)
    return payload
