"""Workload protocol + registry.

Workloads plug in behind one ``TrainerSpec -> FitResult`` shape:

  * :class:`TrainerSpec` normalizes a workload's config into a
    (workload, version, params) triple;
  * :class:`Workload` adapts a trainer to the spec: build the native
    config, fit on a :class:`~repro_torch.api.dataset.PimDataset`, and
    serve host-side prediction and scoring off the fitted model;
  * :func:`register_workload` / :func:`get_workload` is the lookup the
    estimator facade and the launcher resolve names through.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

from .dataset import PimDataset


@dataclasses.dataclass(frozen=True)
class TrainerSpec:
    """Normalized description of one training run."""

    workload: str
    version: str
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FitResult:
    """What every workload's ``fit`` returns: the workload-native model
    plus the sklearn-style attributes the estimator re-exports."""

    spec: TrainerSpec
    model: Any
    attributes: Mapping[str, Any] = dataclasses.field(default_factory=dict)


class Workload:
    """Adapter base: one instance per registered workload."""

    name: str = ""
    aliases: tuple = ()
    versions: tuple = ()
    #: default hyperparameters (the estimator facade's get_params surface)
    defaults: Mapping[str, Any] = {}
    #: True when fit consumes (X,) only — no targets (K-Means)
    unsupervised: bool = False
    #: True when ``fit_steps`` accepts ``state=`` and yields
    #: :class:`~repro_torch.systems.base.ChunkTick` snapshots; a
    #: non-resumable workload (DTR grows its tree host-side in one
    #: macro-pass) restarts from scratch
    resumable: bool = False

    def spec(self, version: Optional[str] = None, **params) -> TrainerSpec:
        version = version or self.versions[0]
        if self.versions and version not in self.versions:
            raise ValueError(
                f"{self.name}: unknown version {version!r}; "
                f"known: {self.versions}")
        unknown = set(params) - set(self.defaults)
        if unknown:
            raise TypeError(
                f"{self.name}: unknown hyperparameters {sorted(unknown)}; "
                f"known: {sorted(self.defaults)}")
        merged = dict(self.defaults)
        merged.update(params)
        return TrainerSpec(self.name, version, merged)

    def fit(self, dataset: PimDataset, spec: TrainerSpec) -> FitResult:
        raise NotImplementedError

    def fit_steps(self, dataset: PimDataset, spec: TrainerSpec, *,
                  state: Optional[dict] = None):
        """Generator: one training step per ``next()``; the FitResult
        travels on StopIteration.  ``state`` is a snapshot from a
        ``ChunkTick`` to resume from."""
        raise NotImplementedError

    def predict(self, result: FitResult, X):
        raise NotImplementedError

    def score(self, result: FitResult, X, y=None) -> float:
        raise NotImplementedError


_REGISTRY: dict[str, Workload] = {}


def register_workload(workload: Workload) -> Workload:
    """Register a workload under its name and aliases (idempotent)."""
    for key in (workload.name, *workload.aliases):
        existing = _REGISTRY.get(key)
        if existing is not None and type(existing) is not type(workload):
            raise ValueError(f"workload name {key!r} already registered "
                             f"by {type(existing).__name__}")
        _REGISTRY[key] = workload
    return workload


def get_workload(name: str) -> Workload:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no workload registered under {name!r}; "
                       f"known: {sorted(set(_REGISTRY))}") from None


def list_workloads() -> dict[str, Workload]:
    """Canonical name -> workload (aliases folded away)."""
    return {w.name: w for w in _REGISTRY.values()}
