"""Legacy scikit-learn-style estimator classes (paper §4).

Port of ``repro.core.estimators``: deprecation shims, each a thin
subclass of the generic :class:`repro_torch.api.PimEstimator` facade
bound to its registered workload; new code constructs estimators with
``repro_torch.api.make_estimator(name, version=...)``.  Every
construction emits exactly one :class:`DeprecationWarning`; behaviour is
otherwise identical to the facade.  Every shim accepts ``version`` and
the full hyperparameter surface of its workload, so the sklearn clone
round-trip ``cls(**est.get_params())`` reconstructs it.  Without
``pim=`` an estimator builds a ``PimSystem`` on the default device,
``"cuda"``.
"""
from __future__ import annotations

import warnings
from typing import Optional

from ..api.estimator import PimEstimator
from ..systems import System


def _warn_legacy(cls_name: str, workload: str) -> None:
    warnings.warn(
        f"{cls_name} is deprecated; use "
        f"repro_torch.api.make_estimator({workload!r}, version=...)",
        DeprecationWarning, stacklevel=3)


class PimLinearRegression(PimEstimator):
    """LIN on the PIM system.  ``version`` in {fp32, int32, hyb, bui}."""

    def __init__(self, version: str = "fp32", n_iters: int = 500,
                 lr: float = 0.1, n_cores: int = 16,
                 pim: Optional[System] = None, **params):
        _warn_legacy("PimLinearRegression", "linreg")
        super().__init__("linreg", version=version, n_cores=n_cores,
                         system=pim, n_iters=n_iters, lr=lr, **params)


class PimLogisticRegression(PimEstimator):
    """LOG on the PIM system.  ``version`` in logreg.VERSIONS."""

    def __init__(self, version: str = "fp32", n_iters: int = 500,
                 lr: float = 5.0, n_cores: int = 16,
                 pim: Optional[System] = None, **params):
        _warn_legacy("PimLogisticRegression", "logreg")
        super().__init__("logreg", version=version, n_cores=n_cores,
                         system=pim, n_iters=n_iters, lr=lr, **params)


class PimDecisionTreeClassifier(PimEstimator):
    """DTR (extremely randomized tree) on the PIM system."""

    def __init__(self, max_depth: int = 10, n_classes: int = 2,
                 seed: int = 0, n_cores: int = 16,
                 pim: Optional[System] = None,
                 version: Optional[str] = None, **params):
        _warn_legacy("PimDecisionTreeClassifier", "dtree")
        super().__init__("dtree", version=version, n_cores=n_cores,
                         system=pim, max_depth=max_depth,
                         n_classes=n_classes, seed=seed, **params)


class PimKMeans(PimEstimator):
    """KME on the PIM system (quantized Lloyd's with restarts)."""

    def __init__(self, n_clusters: int = 16, max_iter: int = 300,
                 tol: float = 1e-4, n_init: int = 1, seed: int = 0,
                 n_cores: int = 16, pim: Optional[System] = None,
                 version: Optional[str] = None, **params):
        _warn_legacy("PimKMeans", "kmeans")
        super().__init__("kmeans", version=version, n_cores=n_cores,
                         system=pim, n_clusters=n_clusters,
                         max_iter=max_iter, tol=tol, n_init=n_init,
                         seed=seed, **params)
