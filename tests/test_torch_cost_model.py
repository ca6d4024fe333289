"""The cost model, the legacy shims and Table 3's configs against the JAX
package, and the port's op counter on its own.

``HierarchicalCostModel`` is pure Python arithmetic kept in the
reference's order of operations, so every price must equal the
reference's as a float (``==``), over a grid of workloads and versions,
core counts (1, 7 and 2560 pad or straddle ranks; 64 and 2048 are the
paper's sizes), tasklet counts and sample counts (Table 3's and a small
one).  The same holds for ``workload_element_bytes``, ``DpuCostModel``
(one ``DeprecationWarning`` per process), the A100 roofline constants
and the copied configs.

The declared costs of the six PIM-ML kernel ops are held to the byte
and operation counts ``PERF.md`` section 6 bounds the kernels with, and
the op counter (``systems/gpu_model.py``) to its stated conventions.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import repro.configs.pim_ml as jcfg
import repro.configs.shapes as jshapes
import repro.core.pim as jcore_pim
import repro.systems.pim as jpim
from repro.configs.base import get_config as jget_config
from repro.launch.roofline import a100 as ja100
from repro.systems.topology import HierarchicalCostModel as JModel
from repro.systems.topology import WORKLOAD_LEG_BYTES as JLEGS

import repro_torch.api as tapi
import repro_torch.configs.pim_ml as tcfg
import repro_torch.configs.shapes as tshapes
import repro_torch.core.pim as tcore_pim
import repro_torch.systems.pim as tpim
from repro_torch.configs.base import ARCH_IDS
from repro_torch.configs.base import get_config as tget_config
from repro_torch.core.estimators import (PimDecisionTreeClassifier,
                                         PimKMeans, PimLinearRegression,
                                         PimLogisticRegression)
from repro_torch.core.lut import build_sigmoid_lut
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import dispatch
from repro_torch.launch.roofline import a100 as ta100
from repro_torch.systems.gpu_model import OpCounter
from repro_torch.systems.topology import HierarchicalCostModel as TModel
from repro_torch.systems.topology import WORKLOAD_LEG_BYTES as TLEGS

WORKLOAD_VERSIONS = [
    ("lin", "fp32"), ("lin", "int32"), ("lin", "hyb"), ("lin", "bui"),
    ("log", "fp32"), ("log", "int32"), ("log", "int32_lut_mram"),
    ("log", "int32_lut_wram"), ("log", "hyb_lut"), ("log", "bui_lut"),
    ("dtr", "fp32"), ("kme", "int16"), ("kme", "fp32"), ("emb", "fp32"),
    ("emb", "int32")]
CORES = (1, 7, 64, 2048, 2560)
#: Table 3's strong-scaling sample counts, and a small one
TABLE3_SAMPLES = {"lin": 6_291_456, "log": 6_291_456, "dtr": 153_600_000,
                  "kme": 25_600_000, "emb": 100_480_507}
SMALL_SAMPLES = 1000


@pytest.mark.parametrize("cores", CORES)
@pytest.mark.parametrize("workload,version", WORKLOAD_VERSIONS)
def test_cost_model_prices_equal_the_reference(workload, version, cores):
    jm, tm = JModel.for_cores(cores), TModel.for_cores(cores)
    assert dataclasses.asdict(tm.topology) == dataclasses.asdict(jm.topology)
    for n in (TABLE3_SAMPLES[workload], SMALL_SAMPLES):
        for f in (2, 16):
            for threads in (1, 11, 16):
                for k in (8, 16):
                    args = (workload, version, n, f)
                    assert tm.workload_seconds(*args, cores, threads, k) \
                        == jm.workload_seconds(*args, cores, threads, k)
                    assert tm.step_seconds(*args, cores, threads, k) \
                        == jm.step_seconds(*args, cores, threads, k)
                    for sharers in (1, 3):
                        assert tm.job_seconds(
                            *args, 7, cores, threads, k, 0, sharers) \
                            == jm.job_seconds(*args, 7, cores, threads, k,
                                              0, sharers)
    bcast, gather = TLEGS[workload](16, 32)
    assert (bcast, gather) == JLEGS[workload](16, 32)
    for start, extent in ((0, cores), (cores // 3, cores - cores // 3)):
        for sharers in (1, 2, 5):
            assert tm.broadcast_seconds(bcast, extent, start, sharers) \
                == jm.broadcast_seconds(bcast, extent, start, sharers)
            assert tm.gather_seconds(gather, extent, start, sharers) \
                == jm.gather_seconds(gather, extent, start, sharers)
            kw = dict(broadcast_bytes_per_dpu=bcast,
                      gather_bytes_per_dpu=gather, n_cores=extent,
                      start=start, sharers=sharers)
            assert tm.launch_seconds(1.5e6, 3.3e5, 12, **kw) \
                == jm.launch_seconds(1.5e6, 3.3e5, 12, **kw)
        live = [(0, max(1, cores // 2)), (cores // 4, max(1, cores // 4)),
                (cores - 1, 1), (0, 0)]
        assert tm.contention_sharers(start, extent, live) \
            == jm.contention_sharers(start, extent, live)


def test_cost_model_refuses_what_the_reference_refuses():
    for model in (TModel.for_cores(8), JModel.for_cores(8)):
        with pytest.raises(ValueError, match="n_threads"):
            model.kernel_seconds(10.0, 10.0, 0)
        with pytest.raises(ValueError):
            model.workload_seconds("nope", "fp32", 100, 4, 8, 16)
    assert tapi.make_system("pim", n_cores=8, device="cpu").config \
        .n_threads == jpim.PimConfig().n_threads == 16


def test_pim_system_cost_model_is_its_topology():
    system = tapi.make_system("pim", n_cores=96, ranks_per_channel=2,
                              device="cpu")
    model = system.cost_model()
    assert model.topology == system.topology
    assert model.topology.dpus_per_rank == 48
    jsys = jpim.PimSystem(jpim.PimConfig(n_cores=96, ranks_per_channel=2))
    assert model.step_seconds("lin", "int32", 10_000, 16) \
        == jsys.cost_model().step_seconds("lin", "int32", 10_000, 16)


@pytest.mark.parametrize("key", sorted(jpim.WORKLOAD_STORAGE_DTYPE)
                         + [("lin", "int8"), ("nope", "fp32")])
def test_workload_element_bytes_equal_the_reference(key):
    if key in jpim.WORKLOAD_STORAGE_DTYPE:
        assert tpim.WORKLOAD_STORAGE_DTYPE[key] \
            == jpim.WORKLOAD_STORAGE_DTYPE[key]
        assert tpim.workload_element_bytes(*key) \
            == jpim.workload_element_bytes(*key)
        return
    for fn in (tpim.workload_element_bytes, jpim.workload_element_bytes):
        with pytest.raises(ValueError, match="WORKLOAD_STORAGE_DTYPE"):
            fn(*key)


@pytest.mark.parametrize("workload,version", WORKLOAD_VERSIONS)
def test_dpu_cost_model_warns_once_and_equals_the_reference(
        monkeypatch, workload, version):
    monkeypatch.setattr(tpim, "_DPU_COST_MODEL_WARNED", False)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        models = [tpim.DpuCostModel(), tpim.DpuCostModel(freq_hz=350e6)]
    deps = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    assert len(deps) == 1 and "HierarchicalCostModel" in str(deps[0].message)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        refs = [jpim.DpuCostModel(), jpim.DpuCostModel(freq_hz=350e6)]
    for tm, jm in zip(models, refs):
        assert tm.topology.n_cores == 1
        for n_cores, threads in ((1, 16), (64, 8), (2048, 11)):
            args = (workload, version, TABLE3_SAMPLES[workload], 16,
                    n_cores, threads)
            assert tm.workload_seconds(*args) == jm.workload_seconds(*args)
        assert tm.kernel_seconds(1e5, 4e4, 5) == jm.kernel_seconds(1e5, 4e4,
                                                                   5)


def test_core_pim_reexports_the_references_names():
    assert tcore_pim.__all__ == jcore_pim.__all__
    for name in jcore_pim.__all__ + ["_host_sum", "_leaf_bytes",
                                     "_tree_bytes"]:
        assert hasattr(tcore_pim, name), name
    assert tcore_pim.PimSystem is tpim.PimSystem
    assert tcore_pim.DPU_OP_CYCLES == jcore_pim.DPU_OP_CYCLES
    for name in ("DPU_FREQ_HZ", "DPU_MRAM_BYTES_PER_CYCLE",
                 "DPU_PIPELINE_SATURATION_THREADS"):
        assert getattr(tcore_pim, name) == getattr(jcore_pim, name)
    assert {v.value for v in tcore_pim.ReduceVia} \
        == {v.value for v in jcore_pim.ReduceVia}
    system = tapi.make_system("pim", n_cores=4, device="cpu",
                              reduce=tcore_pim.ReduceVia.HOST)
    assert type(tcore_pim.resolve_reduce_strategy(
        None, system.config.reduce)).__name__ == "HostReduce"


def test_configs_are_the_references():
    assert tcfg.ALL.keys() == jcfg.ALL.keys()
    for name in jcfg.ALL:
        assert dataclasses.asdict(tcfg.ALL[name]) \
            == dataclasses.asdict(jcfg.ALL[name])
    assert (tcfg.LIN.strong_scaling_samples, tcfg.DTR.strong_scaling_samples,
            tcfg.KME.strong_scaling_samples) == (6_291_456, 153_600_000,
                                                 25_600_000)
    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    assert tshapes.TRAIN_MICROBATCHES == jshapes.TRAIN_MICROBATCHES
    for arch in ARCH_IDS:
        for shape in tshapes.SHAPES:
            tc, jc = tget_config(arch), jget_config(arch)
            assert dataclasses.asdict(tshapes.shape_for(tc, shape)) \
                == dataclasses.asdict(jshapes.shape_for(jc, shape))
            assert tshapes.supports(tc, shape) == jshapes.supports(jc, shape)
    assert tshapes.all_cells() == jshapes.all_cells()


def test_roofline_is_the_references_a100():
    t, j = ta100(), ja100()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for flops, nbytes in ((0.0, 0.0), (3.7e4, 1.0e5), (1e12, 1e9)):
        assert t.kernel_seconds(flops, nbytes) \
            == j.kernel_seconds(flops, nbytes)
        assert t.kernel_energy_j(1e-3) == j.kernel_energy_j(1e-3)


# ---------------------------------------------------------------------------
# The legacy estimator classes.
# ---------------------------------------------------------------------------

def _lin():
    X, y, _ = tsyn.make_linear_dataset(256, 8, seed=0)
    return X, y


def _blobs():
    X, _, _ = tsyn.make_blobs(256, 4, centers=4, seed=2)
    return X, None


def _cls():
    return tsyn.make_classification(256, 8, seed=3, class_sep=1.5)


LEGACY = [
    (PimLinearRegression, "linreg", dict(version="int32", n_iters=20),
     _lin, "coef_"),
    (PimLogisticRegression, "logreg",
     dict(version="int32_lut_wram", n_iters=15), _lin, "coef_"),
    (PimKMeans, "kmeans", dict(n_clusters=4, max_iter=10),
     _blobs, "cluster_centers_"),
    (PimDecisionTreeClassifier, "dtree", dict(max_depth=3), _cls, None),
]


@pytest.mark.parametrize("cls,name,params,data,attr", LEGACY,
                         ids=[c[1] for c in LEGACY])
def test_legacy_estimators_warn_once_and_fit_as_make_estimator(
        cls, name, params, data, attr):
    X, y = data()
    if name == "logreg":
        y = (y > np.median(y)).astype(np.float32)
    system = tapi.make_system("pim", n_cores=8, device="cpu")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        legacy = cls(pim=system, **params)
    deps = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    assert len(deps) == 1 and "make_estimator" in str(deps[0].message)
    legacy.fit(X, y)
    new = tapi.make_estimator(
        name, system=tapi.make_system("pim", n_cores=8, device="cpu"),
        **params).fit(X, y)
    assert legacy.get_params() == new.get_params()
    if attr is None:
        assert np.array_equal(legacy.predict(X), new.predict(X))
        assert legacy.n_nodes_ == new.n_nodes_
    else:
        assert np.array_equal(getattr(legacy, attr), getattr(new, attr))
    assert legacy.score(X, y) == new.score(X, y)


# ---------------------------------------------------------------------------
# Declared kernel costs and the op counter.
# ---------------------------------------------------------------------------

def _i(*shape, lo=-100, hi=100, dtype=torch.int32):
    return torch.randint(lo, hi, shape, dtype=torch.int32).to(dtype)


def _declared_cases():
    """(op, args, the PERF.md section 6 formulas: ops, bytes, rate), at
    small shapes of each op's main path; C cores, R rows a core."""
    c, r, f, k, leaves, b, d, vocab = 4, 24, 16, 6, 5, 7, 3, 40
    n = c * r
    lut = build_sigmoid_lut()
    ids = torch.arange(c * 10, dtype=torch.int32).reshape(c, 10)
    return [
        ("fx_matvec", (_i(c, r, f), _i(f), 10),
         (n * f * 4, n * f * 4 + f * 4 + n * 4, "int32")),
        ("lut_sigmoid", (_i(c, r), lut, "mram"),
         (n * 5, n * 8 + lut.table.numel() * 2, "int32")),
        ("kmeans_assign", (_i(c, r, f, dtype=torch.int16),
                           _i(k, f, dtype=torch.int16)),
         (4 * 2 * n * k * f,
          n * f * 2 + k * f * 2 + n * 4 + c * k * (f + 1) * 4, "int8")),
        ("gini_split", (torch.rand(c, r, f), _i(c, r, lo=0, hi=2),
                        _i(c, r, lo=0, hi=leaves), torch.rand(leaves, f), 2),
         (n * f, n * (f + 2) * 4 + leaves * f * 4
          + c * leaves * 2 * (f + 1) * 4, "fp32")),
        ("emb_gather", (torch.rand(c, 10, d), ids, _i(b, lo=0, hi=vocab)),
         (0, c * b * d * 4 + b * d * 4 + b * 4, "int32")),
        ("emb_scatter_add", (_i(c, 10, d), ids, _i(b, lo=0, hi=vocab),
                             _i(b, d)),
         (c * 10 * b, 2 * c * 10 * d * 4 + c * 10 * 4 + b * 4 + b * d * 4,
          "int32")),
    ]


@pytest.mark.parametrize("case", _declared_cases(), ids=lambda c: c[0])
def test_declared_costs_are_the_kernel_bounds_counts(case):
    op, args, (ops, nbytes, rate) = case
    cost = dispatch.declared_cost(op, *args)
    assert (cost.ops, cost.bytes, cost.rate) == (ops, nbytes, rate)
    # under the counter the op is charged exactly that, whatever runs
    with OpCounter() as counter:
        out = dispatch.launch(op, *args)
    assert (counter.flops, counter.bytes) == (ops, nbytes)
    ref = dispatch.get_op(op).plain(*args)
    for o, r in zip(out if isinstance(out, tuple) else (out,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert torch.equal(o, r)


def test_an_op_without_a_cost_raises_under_the_counter():
    # every kernel op declares a cost since int_matmul's: a stand-in op
    # registered without one
    a, b = _i(4, 8, dtype=torch.int8), _i(8, 4, dtype=torch.int8)
    dispatch.register_op("no_cost", cuda=None,
                         plain=lambda x, y: x.int() @ y.int())
    try:
        dispatch.launch("no_cost", a, b)          # no counter: runs
        with OpCounter(), pytest.raises(NotImplementedError, match="cost"):
            dispatch.launch("no_cost", a, b)
    finally:
        dispatch._OPS.pop("no_cost")
    assert dispatch.meters == []


def test_op_counter_conventions():
    x, w = torch.rand(6, 5), torch.rand(5, 3)
    with OpCounter() as c:
        y = x @ w                                  # mm: 2 m n k
    assert c.flops == 2 * 6 * 5 * 3
    assert c.bytes == (30 + 15 + 18) * 4
    with OpCounter() as c:
        x @ w[:, 0]                                # mv: 2 m n
        x.reshape(30).view(5, 6)                   # views: nothing
        torch.empty(100)                           # allocation: nothing
    assert c.flops == 2 * 6 * 5 and c.bytes == (30 + 5 + 6) * 4
    with OpCounter() as c:
        z = torch.sigmoid(y) + 1.0                 # pointwise: per output
    assert c.flops == 2 * 18 and c.bytes == 2 * (18 + 18) * 4
    with OpCounter() as c:
        torch.sum(z, dim=0)                        # reduction: per input
        torch.argmin(z, dim=1)
    assert c.flops == 2 * 18
    assert c.bytes == (18 + 3) * 4 + 18 * 4 + 6 * 8
    acc, at, ones = torch.zeros(4, 3), torch.tensor([0, 2, 2]), \
        torch.ones(3, 3)
    with OpCounter() as c:
        acc.index_add_(0, at, ones)                # scatter-add: per update
    assert c.flops == 9 and c.bytes == (12 + 3 * 2 + 9 + 12) * 4
    with OpCounter() as c:
        torch.empty(3, device="meta").sum()        # shape bookkeeping
    assert (c.flops, c.bytes) == (0, 0)
