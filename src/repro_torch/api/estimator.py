"""Generic sklearn-style estimator facade over the registered workloads.

``fit`` accepts raw arrays (one placement per call) or a
:class:`~repro_torch.api.dataset.PimDataset` — the sweep path where the
placement is paid once.  ``system=`` accepts any
:class:`~repro_torch.systems.base.System`::

    make_estimator("linreg", version="int32",
                   system=make_system("pim", n_cores=16)).fit(X, y)

Without ``system=`` the estimator builds a ``PimSystem`` of ``n_cores``
cores on the default device, ``"cuda"``.  Every hyperparameter the
workload declares passes through, ``fuse_steps`` and ``pipeline_depth``
included: ``make_estimator("linreg", version="int32", fuse_steps=10)``
runs ten GD iterations per fused chunk, bit-identical to ``fuse_steps=1``
for the integer versions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..systems import PimConfig, PimSystem, System
from .dataset import PimDataset
from .registry import FitResult, Workload, get_workload


class PimEstimator:
    """sklearn-style facade over any registered workload."""

    def __init__(self, workload, version: Optional[str] = None,
                 n_cores: int = 16, system: Optional[System] = None,
                 **params):
        self.workload: Workload = (get_workload(workload)
                                   if isinstance(workload, str) else workload)
        # validate eagerly so a typo'd hyperparameter fails at construction
        spec = self.workload.spec(version, **params)
        self.version = spec.version
        self.system: System = system or PimSystem(PimConfig(n_cores=n_cores))
        self.n_cores = self.system.config.n_cores
        self._params = dict(spec.params)
        self.result_: Optional[FitResult] = None

    # -- sklearn parameter protocol -----------------------------------------

    def get_params(self, deep: bool = True) -> dict:
        out = {"version": self.version, "n_cores": self.n_cores}
        out.update(self._params)
        return out

    def set_params(self, **params) -> "PimEstimator":
        # validate the full candidate combination FIRST so a rejected
        # call leaves the estimator untouched
        version = params.pop("version", self.version)
        n_cores = params.pop("n_cores", None)
        system = params.pop("system", None)
        unknown = set(params) - set(self.workload.defaults)
        if unknown:
            raise ValueError(f"invalid parameters {sorted(unknown)} for "
                             f"{self.workload.name}")
        hyper = dict(self._params)
        hyper.update(params)
        self.workload.spec(version, **hyper)

        self.version = version
        self._params = hyper
        if n_cores is not None:
            # rebuild the session at the new core count, keeping the rest
            # of its config (kind, reduce strategy, device)
            self.n_cores = int(n_cores)
            self.system = type(self.system)(dataclasses.replace(
                self.system.config, n_cores=self.n_cores))
        if system is not None:
            self.system = system
            self.n_cores = self.system.config.n_cores
        return self

    # -- estimation protocol -------------------------------------------------

    def fit(self, X, y=None) -> "PimEstimator":
        if isinstance(X, PimDataset):
            if y is not None:
                raise ValueError(
                    "y must not be passed alongside a PimDataset — the "
                    "dataset already holds its labels")
            # a dataset is bound to the system holding its shards
            ds = X
            self.system = ds.system
            self.n_cores = self.system.config.n_cores
        else:
            ds = self.system.put(X, None if self.workload.unsupervised
                                 else y)
        spec = self.workload.spec(self.version, **self._params)
        self.result_ = self.workload.fit(ds, spec)
        for name, value in self.result_.attributes.items():
            setattr(self, name, value)
        return self

    def _fitted(self) -> FitResult:
        if self.result_ is None:
            raise RuntimeError(
                f"this {self.workload.name} estimator is not fitted yet; "
                f"call fit first")
        return self.result_

    def predict(self, X):
        return self.workload.predict(self._fitted(), X)

    def score(self, X, y=None) -> float:
        return self.workload.score(self._fitted(), X, y)

    def decision_function(self, X):
        return self._optional("decision_function", X)

    def predict_proba(self, X):
        return self._optional("predict_proba", X)

    def _optional(self, method: str, X):
        fn = getattr(self.workload, method, None)
        if fn is None:
            raise AttributeError(
                f"{self.workload.name} does not implement {method}")
        return fn(self._fitted(), X)

    def __repr__(self) -> str:
        kv = ", ".join(f"{k}={v!r}" for k, v in self.get_params().items())
        return f"PimEstimator({self.workload.name!r}, {kv})"


def make_estimator(name: str, version: Optional[str] = None,
                   n_cores: int = 16, system: Optional[System] = None,
                   **params) -> PimEstimator:
    """Construct an estimator for a registered workload by name."""
    return PimEstimator(get_workload(name), version=version,
                        n_cores=n_cores, system=system, **params)
