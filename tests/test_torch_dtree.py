"""Decision-tree training through the port against the JAX package.

Both packages fit ``make_estimator("dtree", ...)`` on the same
numpy-seeded classification data, on ``pim`` at several core counts (7
and 16 pad the last shard) and on ``host``, under every reduce strategy.
The thresholds are drawn from the same MT19937 stream and every count
is an integer, so the trees must be identical — feature, threshold,
children, class, depth and node count — and ``TransferStats`` equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.api as japi
from repro.core import dtree as jdt

import repro_torch.api as tapi
from repro_torch.core import dtree as tdt
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import dispatch

SYSTEMS = [("pim", 1), ("pim", 7), ("pim", 16), ("host", 8)]
TREE_FIELDS = ("feature", "threshold", "left", "right", "leaf_class",
               "depth")


@pytest.fixture(scope="module")
def data():
    return tsyn.make_classification(1200, 8, n_informative=3,
                                    n_redundant=2, seed=5, class_sep=1.4)


def _fit_both(kind, n_cores, X, y, reduce="fabric", **params):
    js = japi.make_system(kind, n_cores=n_cores, reduce=reduce)
    ts = tapi.make_system(kind, n_cores=n_cores, reduce=reduce, device="cpu")
    p = {"max_depth": 6, **params}
    je = japi.make_estimator("dtree", system=js, **p).fit(X, y)
    te = tapi.make_estimator("dtree", system=ts, **p).fit(X, y)
    return je, te, js, ts


def _assert_same_tree(je, te, js, ts):
    for name in TREE_FIELDS:
        a, b = getattr(te.tree_, name), getattr(je.tree_, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert te.n_nodes_ == je.n_nodes_ > 1
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)


@pytest.mark.parametrize("kind,n_cores", SYSTEMS)
def test_tree_matches_reference(kind, n_cores, data):
    _assert_same_tree(*_fit_both(kind, n_cores, *data))


@pytest.mark.parametrize("reduce", ["host", "hierarchical",
                                    "hierarchical-auto"])
def test_reduce_strategies_match_reference(reduce, data):
    _assert_same_tree(*_fit_both("pim", 16, *data, reduce=reduce))


@pytest.mark.parametrize("params", [{"max_depth": 3, "seed": 2},
                                    {"min_samples_split": 40},
                                    {"n_classes": 3}])
def test_tree_options_match_reference(params, data):
    X, y = data
    if params.get("n_classes") == 3:
        y = (np.arange(y.size) % 3).astype(np.int32)
    _assert_same_tree(*_fit_both("pim", 7, X, y, **params))


def test_reference_kernel_backend_gives_the_same_tree(data):
    """The reference's Pallas kernel (interpret mode) grows the tree the
    port's plain version grows."""
    je, te, js, ts = _fit_both("pim", 7, *data, max_depth=4)
    jk = japi.make_estimator("dtree", system=js, max_depth=4,
                             kernel_backend="pallas_interpret").fit(*data)
    for name in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(te.tree_, name),
                                      getattr(jk.tree_, name))


def test_prediction_and_score_match_reference(data):
    X, y = data
    je, te, _, _ = _fit_both("pim", 16, X, y)
    np.testing.assert_array_equal(te.predict(X), je.predict(X))
    assert te.score(X, y) == je.score(X, y) > 0.8


def test_one_round_per_step_and_one_eval_launch_per_round(data):
    """fit_steps yields once per committed round; each round runs one
    split-evaluate, and the last (no split) round commits nothing."""
    ts = tapi.make_system("pim", n_cores=4, device="cpu")
    ds = ts.put(*data)
    gen = tdt.fit_steps(ds, tdt.TreeConfig(max_depth=5))
    rounds = 0
    while True:
        try:
            assert next(gen) == 1
            rounds += 1
        except StopIteration as stop:
            tree = stop.value
            break
    depth = int(tree.depth[:tree.n_nodes].max())
    assert rounds == depth and depth <= 5
    # per round: min-max + split-evaluate, + commit in all but the last
    assert ts.stats.kernel_launches == 3 * (rounds + 1) - 1
    assert ts.registered_kernels() == ("dtr.commit", "dtr.eval/m128.c2",
                                       "dtr.minmax/m128")


def test_dtree_is_not_resumable(data):
    ts = tapi.make_system("pim", n_cores=4, device="cpu")
    wl = tapi.get_workload("dtr")
    ds = ts.put(*data)
    with pytest.raises(ValueError, match="not resumable"):
        next(wl.fit_steps(ds, wl.spec(), state={"arrays": {}, "meta": {}}))
    assert ds.tree_view() is ds.tree_view()         # one cached view
    assert ts.stats.shard_transfers == 2


def test_cpu_fit_counts_no_kernel_launches(data):
    dispatch.reset_launch_counts()
    ts = tapi.make_system("host", device="cpu")
    tapi.make_estimator("dtree", system=ts, max_depth=3).fit(*data)
    assert dispatch.launch_counts == {}


def test_jax_tree_predicts_like_the_port_tree(data):
    """Tree.predict is a verbatim copy: the same arrays predict the same."""
    X, _ = data
    ts = tapi.make_system("pim", n_cores=3, device="cpu")
    t = tapi.make_estimator("dtree", system=ts, max_depth=4).fit(*data).tree_
    j = jdt.Tree(t.feature, t.threshold, t.left, t.right, t.leaf_class,
                 t.depth, t.n_nodes)
    np.testing.assert_array_equal(t.predict(X), j.predict(X))


def test_pad_rows_count_nowhere(data):
    """7 cores pad the last shard (1200 = 7 * 172 - 4): the split-evaluate
    kernel sends those rows to leaf -1, and the counts equal a count over
    the valid rows alone."""
    X, y = data
    ts = tapi.make_system("pim", n_cores=7, device="cpu")
    Xs, ys, valid = ts.put(X, y).tree_view()
    assert int((~valid).sum()) == valid.numel() - X.shape[0] == 4
    rng = np.random.RandomState(2)
    leaf = torch.from_numpy(rng.randint(0, 128, valid.shape)
                            .astype(np.int32))
    th = torch.from_numpy(rng.randn(128, X.shape[1]).astype(np.float32))
    out = tdt.make_split_eval_kernel(128, 2)(Xs, ys, leaf, valid, th)
    v = valid.numpy()
    xv, yv, lv = Xs.numpy()[v], ys.numpy()[v], leaf.numpy()[v]
    below = np.zeros((128, 2, X.shape[1]), np.int64)
    total = np.zeros((128, 2), np.int64)
    np.add.at(total, (lv, yv), 1)
    np.add.at(below, (lv, yv), xv <= th.numpy()[lv])
    np.testing.assert_array_equal(out["below"].sum(0).numpy(), below)
    np.testing.assert_array_equal(out["total"].sum(0).numpy(), total)
    _assert_same_tree(*_fit_both("pim", 7, X, y))
