"""EMB registered behind the Workload protocol.

``make_estimator("emb", version="int32", flush_every=8)`` trains the
bank-sharded embedding tables through the same registry surface as the
paper's four workloads, so the estimator and the ``pim_ml`` launcher pick
EMB up without special cases.
"""
from __future__ import annotations

import numpy as np

from ..api.registry import FitResult, TrainerSpec, Workload, \
    register_workload
from . import trainer


class EmbWorkload(Workload):
    """EMB: deferred-update embedding regression (LazyDP-style)."""

    name = "emb"
    aliases = ("EMB", "embedding")
    versions = trainer.VERSIONS
    resumable = True
    defaults = {"n_iters": 200, "batch": 64, "dim": 8, "lr": 0.05,
                "frac_bits": 10, "flush_every": 1, "deferred": None,
                "compress_flush": False, "placement": "mod",
                "n_users": None, "n_items": None, "record_every": 0,
                "seed": 0, "fuse_steps": 1, "pipeline_depth": 2}

    def _config(self, spec: TrainerSpec) -> trainer.EmbConfig:
        return trainer.EmbConfig(version=spec.version, **spec.params)

    def _result(self, spec: TrainerSpec, r: trainer.EmbResult) -> FitResult:
        return FitResult(spec, r, {"user_emb_": r.user_emb,
                                   "item_emb_": r.item_emb,
                                   "n_flushes_": r.n_flushes})

    def fit(self, dataset, spec: TrainerSpec) -> FitResult:
        return self._result(spec, trainer.fit(dataset, self._config(spec)))

    def fit_steps(self, dataset, spec: TrainerSpec, *, state=None):
        r = yield from trainer.fit_steps(dataset, self._config(spec),
                                         state=state)
        return self._result(spec, r)

    def predict(self, result: FitResult, X):
        return result.model.predict(np.asarray(X))

    def score(self, result: FitResult, X, y=None) -> float:
        """R^2 of the predicted ratings (regression convention)."""
        y = np.asarray(y, np.float64)
        pred = self.predict(result, X)
        ss_res = float(((y - pred) ** 2).sum())
        ss_tot = float(((y - y.mean()) ** 2).sum())
        return 1.0 - ss_res / max(ss_tot, 1e-12)


register_workload(EmbWorkload())
