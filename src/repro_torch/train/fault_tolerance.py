"""Straggler detection for the job runtime.

Port of the part of ``repro.train.fault_tolerance`` the scheduler uses:
:class:`StragglerMonitor`, a per-step wall-time EWMA with z-score
flagging.  It is fed step times measured on the host clock; on a card a
step's time is only meaningful when the step ends in a synchronization
(a GD step's host reduce or update read does).  The reference's
``plan_rescale`` and ``run_with_recovery`` belong to the LM training
stack, which is not ported yet.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA + z-score step-time outlier detection."""
    alpha: float = 0.1
    z_threshold: float = 3.0
    warmup_steps: int = 5

    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    flagged: int = 0

    def observe(self, step_seconds: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        self.n += 1
        if self.n <= self.warmup_steps:
            # prime the statistics
            delta = step_seconds - self.mean
            self.mean += delta / self.n
            self.var += delta * (step_seconds - self.mean)
            return False
        std = math.sqrt(max(self.var / max(self.n - 1, 1), 1e-12))
        z = (step_seconds - self.mean) / max(std, 1e-9)
        is_outlier = z > self.z_threshold
        if is_outlier:
            self.flagged += 1
        else:
            # EWMA update only on healthy steps (outliers would poison it)
            self.mean = (1 - self.alpha) * self.mean \
                + self.alpha * step_seconds
            self.var = (1 - self.alpha) * self.var \
                + self.alpha * (step_seconds - self.mean) ** 2
        return is_outlier
