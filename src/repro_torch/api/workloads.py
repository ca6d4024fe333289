"""LIN, LOG, DTR and KME registered behind the Workload protocol.

Each adapter maps the unified ``TrainerSpec`` onto the native trainer
config (``GdConfig``/``LogRegConfig``/``TreeConfig``/``KMeansConfig``),
fits on a resident :class:`~repro_torch.api.dataset.PimDataset`, and
serves host-side prediction as the paper's sklearn deployment does
(§4).  EMB lives in its own subsystem (:mod:`repro_torch.emb`); the
import at the end of this module registers it.
"""
from __future__ import annotations

import numpy as np

from ..core import dtree, kmeans, linreg, logreg, metrics
from .registry import FitResult, TrainerSpec, Workload, register_workload


def kmeans_sq_distances(X, C) -> np.ndarray:
    """Squared Euclidean distances (n, k) between rows of X and centroids:
    the single helper shared by K-Means ``predict`` and ``score``.  It
    keeps the ``||x||^2`` term, so the values are true squared distances,
    safe for argmin and for scoring."""
    X = np.asarray(X, np.float32)
    C = np.asarray(C, np.float32)
    return ((X * X).sum(1)[:, None] - 2.0 * X @ C.T
            + (C * C).sum(1)[None, :])


class LinRegWorkload(Workload):
    """LIN (paper §3.1): linear regression via gradient descent."""

    name = "linreg"
    aliases = ("lin", "linear_regression")
    versions = linreg.VERSIONS
    resumable = True
    defaults = {"n_iters": 500, "lr": 0.1, "frac_bits": 10, "x8_frac": 7,
                "w16_frac": 8, "record_every": 0, "minibatch": 0, "seed": 0,
                "fuse_steps": 1, "pipeline_depth": 2}

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
    aliases = ("log", "logistic_regression")
    versions = logreg.VERSIONS
    resumable = True
    defaults = {"n_iters": 500, "lr": 5.0, "frac_bits": 10, "x8_frac": 7,
                "w16_frac": 8, "record_every": 0, "minibatch": 0, "seed": 0,
                "taylor_terms": 8, "lut_boundary": 20, "lut_frac_bits": 10,
                "fuse_steps": 1, "pipeline_depth": 2}

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


class DecisionTreeWorkload(Workload):
    """DTR (paper §3.3): extremely randomized tree classification."""

    name = "dtree"
    aliases = ("dtr", "decision_tree")
    versions = ("fp32",)
    defaults = {"max_depth": 10, "n_classes": 2, "min_samples_split": 2,
                "seed": 0}

    def _config(self, spec: TrainerSpec) -> dtree.TreeConfig:
        return dtree.TreeConfig(**spec.params)

    def fit(self, dataset, spec: TrainerSpec) -> FitResult:
        tree = dtree.fit(dataset, self._config(spec))
        return FitResult(spec, tree,
                         {"tree_": tree, "n_nodes_": tree.n_nodes})

    def fit_steps(self, dataset, spec: TrainerSpec, *, state=None):
        # not resumable: the tree builds host-side in one macro-pass, so
        # a preempted tree job restarts from scratch
        if state is not None:
            raise ValueError("dtree is not resumable; it cannot accept "
                             "a checkpoint state")
        tree = yield from dtree.fit_steps(dataset, self._config(spec))
        return FitResult(spec, tree,
                         {"tree_": tree, "n_nodes_": tree.n_nodes})

    def predict(self, result: FitResult, X):
        return result.model.predict(np.asarray(X))

    def score(self, result: FitResult, X, y=None) -> float:
        return metrics.accuracy(self.predict(result, X), np.asarray(y))


class KMeansWorkload(Workload):
    """KME (paper §3.4): quantized Lloyd's with restarts."""

    name = "kmeans"
    aliases = ("kme",)
    #: "int16" = the paper's quantized PIM version; "fp32" = the
    #: processor-centric float baseline
    versions = kmeans.VERSIONS
    unsupervised = True
    resumable = True
    defaults = {"n_clusters": 16, "max_iter": 300, "tol": 1e-4,
                "n_init": 1, "seed": 0, "fuse_steps": 1,
                "pipeline_depth": 2}

    def _config(self, spec: TrainerSpec) -> kmeans.KMeansConfig:
        p = spec.params
        return kmeans.KMeansConfig(k=p["n_clusters"],
                                   max_iters=p["max_iter"], tol=p["tol"],
                                   n_init=p["n_init"], seed=p["seed"],
                                   fuse_steps=p["fuse_steps"],
                                   pipeline_depth=p["pipeline_depth"],
                                   version=spec.version)

    @staticmethod
    def _result(spec: TrainerSpec, r: kmeans.KMeansResult) -> FitResult:
        return FitResult(spec, r, {"cluster_centers_": r.centroids,
                                   "inertia_": r.inertia,
                                   "labels_": r.labels,
                                   "n_iter_": r.n_iters})

    def fit(self, dataset, spec: TrainerSpec) -> FitResult:
        return self._result(spec, kmeans.fit(dataset, self._config(spec)))

    def fit_steps(self, dataset, spec: TrainerSpec, *, state=None):
        r = yield from kmeans.fit_steps(dataset, self._config(spec),
                                        state=state)
        return self._result(spec, r)

    def predict(self, result: FitResult, X):
        d = kmeans_sq_distances(X, result.model.centroids)
        return d.argmin(1).astype(np.int32)

    def score(self, result: FitResult, X, y=None) -> float:
        """Negative inertia of X under the fitted centroids (sklearn)."""
        d = kmeans_sq_distances(X, result.model.centroids)
        return -float(d.min(1).sum())


register_workload(LinRegWorkload())
register_workload(LogRegWorkload())
register_workload(DecisionTreeWorkload())
register_workload(KMeansWorkload())

# EMB lives in its own subsystem: importing its adapter registers it
from ..emb.workload import EmbWorkload  # noqa: E402,F401
