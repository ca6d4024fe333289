"""LIN and LOG registered behind the Workload protocol.

Each adapter maps the unified ``TrainerSpec`` onto the native trainer
config (``GdConfig``/``LogRegConfig``), fits on a resident
:class:`~repro_torch.api.dataset.PimDataset`, and serves host-side
prediction as the paper's sklearn deployment does (§4).  DTR, KME and
EMB are not ported yet.
"""
from __future__ import annotations

import numpy as np

from ..core import linreg, logreg, metrics
from .registry import FitResult, TrainerSpec, Workload, register_workload


class LinRegWorkload(Workload):
    """LIN (paper §3.1): linear regression via gradient descent."""

    name = "linreg"
    versions = linreg.VERSIONS
    defaults = {"n_iters": 500, "lr": 0.1, "frac_bits": 10, "x8_frac": 7,
                "w16_frac": 8, "record_every": 0, "minibatch": 0, "seed": 0,
                "fuse_steps": 1}

    def _config(self, spec: TrainerSpec) -> linreg.GdConfig:
        return linreg.GdConfig(version=spec.version, **spec.params)

    def fit(self, dataset, spec: TrainerSpec) -> FitResult:
        r = linreg.fit(dataset, self._config(spec))
        return FitResult(spec, r, {"coef_": r.w, "intercept_": r.b})

    def fit_steps(self, dataset, spec: TrainerSpec, *, state=None):
        r = yield from linreg.fit_steps(dataset, self._config(spec),
                                        state=state)
        return FitResult(spec, r, {"coef_": r.w, "intercept_": r.b})

    def predict(self, result: FitResult, X):
        return result.model.predict(np.asarray(X))

    def score(self, result: FitResult, X, y=None) -> float:
        """R^2, the sklearn regression convention."""
        y = np.asarray(y, np.float64)
        pred = self.predict(result, X)
        ss_res = float(((y - pred) ** 2).sum())
        ss_tot = float(((y - y.mean()) ** 2).sum())
        return 1.0 - ss_res / max(ss_tot, 1e-12)


class LogRegWorkload(Workload):
    """LOG (paper §3.2): logistic regression, Taylor or LUT sigmoid."""

    name = "logreg"
    versions = logreg.VERSIONS
    defaults = {"n_iters": 500, "lr": 5.0, "frac_bits": 10, "x8_frac": 7,
                "w16_frac": 8, "record_every": 0, "minibatch": 0, "seed": 0,
                "taylor_terms": 8, "lut_boundary": 20, "lut_frac_bits": 10,
                "fuse_steps": 1}

    def _config(self, spec: TrainerSpec) -> logreg.LogRegConfig:
        return logreg.LogRegConfig(version=spec.version, **spec.params)

    def fit(self, dataset, spec: TrainerSpec) -> FitResult:
        r = logreg.fit(dataset, self._config(spec))
        return FitResult(spec, r, {"coef_": r.w, "intercept_": r.b})

    def fit_steps(self, dataset, spec: TrainerSpec, *, state=None):
        r = yield from logreg.fit_steps(dataset, self._config(spec),
                                        state=state)
        return FitResult(spec, r, {"coef_": r.w, "intercept_": r.b})

    def decision_function(self, result: FitResult, X):
        return result.model.predict(np.asarray(X))

    def predict_proba(self, result: FitResult, X):
        z = self.decision_function(result, X)
        p1 = 1.0 / (1.0 + np.exp(-z))
        return np.stack([1.0 - p1, p1], axis=1)

    def predict(self, result: FitResult, X):
        return (self.decision_function(result, X) > 0.0).astype(np.int32)

    def score(self, result: FitResult, X, y=None) -> float:
        return metrics.accuracy(self.predict(result, X),
                                np.asarray(y) > 0.5)


register_workload(LinRegWorkload())
register_workload(LogRegWorkload())
