"""Fault-tolerance runtime: straggler detection and elastic rescale (port
of ``repro.train.fault_tolerance``).

  - :class:`StragglerMonitor`: a per-step wall-time EWMA with z-score
    flagging.  It is fed step times measured on the host clock; on a card
    a step's time is only meaningful when the step ends in a
    synchronization (a GD step's host reduce, an LM step's loss read).
  - :func:`plan_rescale`: the largest (dp x tp) mesh the surviving devices
    hold with tp kept, so the checkpoint's weight shards stay valid.
  - :func:`run_with_recovery`: the supervision loop; a step that raises
    restores the last checkpoint and training continues from there.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional


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


def plan_rescale(n_surviving: int, tp: int,
                 pod_axis: bool = False) -> Optional[tuple]:
    """Largest usable mesh shape from surviving devices, keeping tp fixed.

    Returns ("pod", "data", "model") or ("data", "model") dims, or None if
    fewer than one tp group survives.  Keeping tp constant means weight
    shards from the checkpoint remain bitwise-valid; only the data axis
    shrinks.
    """
    if n_surviving < tp:
        return None
    dp = n_surviving // tp
    if pod_axis and dp % 2 == 0:
        return (2, dp // 2, tp)
    return (dp, tp)


@dataclasses.dataclass
class RecoveryStats:
    failures: int = 0
    restores: int = 0
    steps_lost: int = 0


def run_with_recovery(step_fn: Callable, save_fn: Callable,
                      restore_fn: Callable, *, n_steps: int,
                      ckpt_every: int, state,
                      monitor: Optional[StragglerMonitor] = None,
                      max_failures: int = 10):
    """Supervised training loop with checkpoint/restart semantics.

    ``step_fn(state, step) -> state`` may raise (injected faults in tests;
    a lost device on a real machine).  On failure: restore the latest
    checkpoint and continue from there (from step 0 when none was saved).
    -> ``(state, RecoveryStats)``.
    """
    stats = RecoveryStats()
    last_saved = -1
    step = 0
    while step < n_steps:
        try:
            t0 = time.perf_counter()
            state = step_fn(state, step)
            dt = time.perf_counter() - t0
            if monitor is not None:
                monitor.observe(dt)
            if (step + 1) % ckpt_every == 0:
                save_fn(state, step + 1)
                last_saved = step + 1
            step += 1
        except Exception:
            stats.failures += 1
            if stats.failures > max_failures:
                raise
            if last_saved >= 0:
                state = restore_fn(last_saved)
                stats.steps_lost += step - last_saved
                step = last_saved
            else:
                stats.steps_lost += step
                step = 0
            stats.restores += 1
    return state, stats
