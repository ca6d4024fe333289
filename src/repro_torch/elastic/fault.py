"""Fault injection: deterministic step failures for recovery testing.

A copy of ``repro.elastic.fault``.  ``REPRO_INJECT_FAULT`` (env) or a
scheduler-level :class:`FaultInjector` plants exceptions inside job
steps; the reference scheduler's supervised-retry path restores the
job's last in-memory snapshot and continues, burning one unit of the
job's retry budget per recovery.

Env syntax — comma-separated ``pattern:step[:count]`` entries::

    REPRO_INJECT_FAULT="job0*:3"        # fail job0* at its 3rd step
    REPRO_INJECT_FAULT="*:2:5"          # fail every job's step 2, 5x
    REPRO_INJECT_FAULT="lin*:1,kme*:4"  # several plans

``pattern`` is an fnmatch glob over the job name; ``step`` is the
1-based scheduling turn at which the fault fires; ``count`` is how many
times that entry fires across retries (default 1 — the retry survives).
"""
from __future__ import annotations

import dataclasses
import fnmatch
import os
from typing import List, Optional

ENV_VAR = "REPRO_INJECT_FAULT"


class InjectedFault(RuntimeError):
    """The planted failure (distinguishable from organic errors)."""


@dataclasses.dataclass
class _Plan:
    pattern: str
    step: int
    count: int


class FaultInjector:
    """Callable scheduler hook: ``injector(job_name, step) -> bool``
    returns True when a planted fault should fire this turn (the
    scheduler then raises :class:`InjectedFault` inside the job's step,
    where it is indistinguishable from a real kernel failure)."""

    def __init__(self, plans: Optional[List[_Plan]] = None):
        self.plans = list(plans or [])
        self.fired = 0

    @classmethod
    def parse(cls, text: str) -> "FaultInjector":
        plans = []
        for entry in filter(None, (e.strip() for e in text.split(","))):
            parts = entry.split(":")
            if len(parts) not in (2, 3):
                raise ValueError(
                    f"bad {ENV_VAR} entry {entry!r}; expected "
                    f"pattern:step[:count]")
            plans.append(_Plan(parts[0], int(parts[1]),
                               int(parts[2]) if len(parts) == 3 else 1))
        return cls(plans)

    def plan(self, pattern: str, step: int, count: int = 1) -> None:
        self.plans.append(_Plan(pattern, step, count))

    def __call__(self, job_name: str, step: int) -> bool:
        for p in self.plans:
            if p.count > 0 and p.step == step \
                    and fnmatch.fnmatch(job_name, p.pattern):
                p.count -= 1
                self.fired += 1
                return True
        return False


def injector_from_env(environ=None) -> Optional[FaultInjector]:
    """The ambient injector, or None when ``REPRO_INJECT_FAULT`` is
    unset/empty.  Read once at scheduler construction."""
    text = (environ if environ is not None else os.environ).get(ENV_VAR)
    if not text:
        return None
    return FaultInjector.parse(text)
