"""The elastic job runtime's base (port of ``repro.elastic``).

Resumable trainers expose their chunk-boundary carry as lazy
:class:`~repro_torch.systems.base.ChunkTick` snapshots; this package
gives those snapshots an on-disk life (atomic job checkpoints through
``train/checkpoint.py``), an identity (config and dataset fingerprints),
a migration rule (which System kinds a carry may resume on) and a
failure source (deterministic fault injection).  Snapshots and
checkpoints cross packages: one written by ``repro`` resumes here and
vice versa.
"""
from __future__ import annotations

from .checkpoint import (has_checkpoint, job_dir, load_snapshot,
                         save_snapshot)
from .fault import (ENV_VAR, FaultInjector, InjectedFault,
                    injector_from_env)
from .fingerprint import (dataset_fingerprint, job_fingerprint,
                          spec_fingerprint)
from .state import (SCHEMA_VERSION, check_migration, migration_ok,
                    pack_rng, snapshot_iters, unpack_rng)

__all__ = [
    "ENV_VAR", "FaultInjector", "InjectedFault", "SCHEMA_VERSION",
    "check_migration", "dataset_fingerprint", "has_checkpoint",
    "injector_from_env", "job_dir", "job_fingerprint", "load_snapshot",
    "migration_ok", "pack_rng", "save_snapshot", "snapshot_iters",
    "spec_fingerprint", "unpack_rng",
]
