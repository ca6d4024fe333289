"""Build the CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, under ``build/repro_torch/``
at the repository root; ``csrc/sm90.cuh`` holds the Hopper helpers (TMA,
mbarrier, wgmma) that several of them include, ``csrc/attention.cuh``
what the attention forward and backward share.  The file name carries a
hash of the source, every header of ``csrc/`` and the flags, so a stale
library is never loaded.  No library links ``-lcuda``: the TMA tensor maps' encoder comes
from the driver through the runtime's entry-point query.  :func:`build`
starts one ``nvcc`` per missing library, all at once, and waits for
every one.
Nothing falls back: a missing ``nvcc`` or a failed compile raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("fx_matvec", "lut_sigmoid", "kmeans_assign", "gini_counts",
           "emb_gather", "emb_scatter_add", "int_matmul", "flash_attention",
           "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda; "
                           "the CUDA kernels cannot be built")
    return nvcc


def library_path(name: str) -> Path:
    """The library's path; its hash covers the source, the shared headers
    of ``csrc/`` and the flags."""
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _build_locked(names) -> dict[str, str]:
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library of ``names`` not built yet; returns the
    compiler's output (register and shared-memory use) per source."""
    with _LOCK:
        return _build_locked(names)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _build_locked((name,))
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib
