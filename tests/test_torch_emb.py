"""EMB training through the port against the JAX package.

Both packages run on the same numpy-seeded inputs:

* the sparse kernels' plain versions against the reference's
  ``emb_gather_ref`` / ``emb_scatter_add_ref`` and its Pallas kernels in
  interpret mode: int32 bit-exact (integer sums wrap, in any order);
  float32 bit-exact when no row takes more than two updates.  A row that
  takes three or more is summed in batch order here and in another
  grouping by XLA's CPU dot, so it is held to ``FP32_SCATTER_RTOL`` of
  the sum of the magnitudes it adds;
* plain-torch models of what the CUDA kernels compute, on the same
  inputs: the gather searches each core's ids sorted once per placement
  (the gather index, against a brute-force search) and selects the rows
  it finds; the scatter sums each batch id's update rows once, in batch
  order, and adds the sum to the rows that hold the id.  Both equal the
  plain versions bit for bit, and the reference where it is exact;
* ``ShardedTable`` placement grids, round trips and the staging ledger;
* whole fits through ``make_estimator("emb")`` on ``pim`` (1, 7 and 16
  cores; 7 and 16 pad both vocabularies) and ``host``, under every
  reduce strategy, eager, deferred D=1, D=8 and D=8 with compressed
  flushes.  int32 must give identical tables, history, flush counts and
  ``TransferStats``.  fp32 tables are held to ``FP32_RTOL``/``FP32_ATOL``
  and its history to ``FP32_HIST_RTOL``: the reference's compiled
  ``sum(u * i)`` fuses its multiply-adds, ATen's rounds each product;
* mid-window snapshots from either package resuming in the port, and
  the port's resuming in the reference.

Inputs exclude -0.0 and non-finite table entries: the reference's
one-hot dot multiplies every row by 0 or 1 (a NaN poisons a whole shard
there), where the port selects the matching row; training tables never
hold either.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.data import synthetic as jsyn
from repro.emb import trainer as jtrain
from repro.kernels.sparse_gather import ops as jops
from repro.kernels.sparse_gather.ref import (emb_gather_ref,
                                             emb_scatter_add_ref)
from repro.systems import compress as jcompress

import repro_torch.api as tapi
from repro_torch.data import synthetic as tsyn
from repro_torch.emb import trainer as ttrain
from repro_torch.kernels import dispatch
from repro_torch.kernels.sparse_gather import (IDX_PAD, ROW_PAD_ID,
                                               emb_gather_plain,
                                               emb_scatter_add_plain,
                                               gather_index)
from repro_torch.launch import pim_ml
from repro_torch.systems import compress as tcompress

FP32_SCATTER_RTOL = 1e-6
FP32_RTOL, FP32_ATOL = 1e-5, 1e-6
FP32_HIST_RTOL = 1e-5
SYSTEMS = [("pim", 1), ("pim", 7), ("pim", 16), ("host", 8)]
MODES = {
    "eager": {},
    "deferred_d1": {"flush_every": 1, "deferred": True},
    "d8": {"flush_every": 8},
    "d8_compressed": {"flush_every": 8, "compress_flush": True},
}
PARAMS = {"n_iters": 20, "batch": 32, "dim": 4, "lr": 1.0, "frac_bits": 12,
          "seed": 1, "record_every": 4}


@pytest.fixture(scope="module")
def recsys():
    return tsyn.make_recsys(768, 45, 35, dim=4, seed=3)


# ---------------------------------------------------------------------------
# The two kernels' plain versions against the reference.
# ---------------------------------------------------------------------------

def _shard(dtype, r=22, d=3, vmax=40, seed=0):
    """One shard's rows, with two ROW_PAD_ID slots and zero rows there."""
    rng = np.random.RandomState(seed)
    ids = rng.choice(vmax, size=r - 2, replace=False).astype(np.int32)
    ids = np.concatenate([ids, [ROW_PAD_ID, ROW_PAD_ID]]).astype(np.int32)
    rng.shuffle(ids)
    if dtype == "int32":
        tab = rng.randint(-2 ** 31, 2 ** 31 - 1, (r, d), np.int64)
        tab = tab.astype(np.int32)
    else:
        tab = rng.randn(r, d).astype(np.float32)
        tab[tab == 0] = 1.0                      # no -0.0 (nor +0.0)
    tab[ids == ROW_PAD_ID] = 0
    return tab, ids


def _lookups(ids, b, seed, kind):
    rng = np.random.RandomState(seed)
    owned = ids[ids >= 0]
    if kind == "hits":
        return rng.choice(owned, size=b).astype(np.int32)
    if kind == "misses":                       # owned elsewhere or IDX_PAD
        other = np.setdiff1d(np.arange(60), owned)
        idx = rng.choice(other, size=b).astype(np.int32)
        idx[::3] = IDX_PAD
        return idx
    if kind == "mixed":
        idx = rng.choice(np.concatenate([owned, [41, 57, IDX_PAD]]), size=b)
        return idx.astype(np.int32)
    if kind == "all_same":                     # one hot id, b times
        return np.full(b, owned[3], np.int32)
    raise ValueError(kind)


def _updates(dtype, b, d, seed):
    rng = np.random.RandomState(seed)
    if dtype == "int32":
        return rng.randint(-2 ** 31, 2 ** 31 - 1, (b, d),
                           np.int64).astype(np.int32)
    return rng.randn(b, d).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _stack_cores(n_cores, dtype, seed=0, r=22, d=3):
    shards = [_shard(dtype, r=r, d=d, seed=seed + c) for c in range(n_cores)]
    return (np.stack([s[0] for s in shards]),
            np.stack([s[1] for s in shards]))


@pytest.mark.parametrize("kind", ["hits", "misses", "mixed", "all_same"])
@pytest.mark.parametrize("b", [1, 20, 64])
@pytest.mark.parametrize("dtype", ["int32", "fp32"])
def test_gather_plain_equals_reference(dtype, b, kind):
    tabs, idss = _stack_cores(3, dtype)
    idx = _lookups(idss[0], b, seed=b, kind=kind)
    out = emb_gather_plain(_t(tabs), _t(idss), _t(idx)).numpy()
    for c in range(3):
        ref = np.asarray(emb_gather_ref(tabs[c], idss[c], idx))
        pal = np.asarray(jops._emb_gather_pallas(
            jnp.asarray(tabs[c]), jnp.asarray(idss[c]), jnp.asarray(idx),
            interpret=True, block_b=8))
        np.testing.assert_array_equal(out[c], ref)
        np.testing.assert_array_equal(out[c], pal)
    if kind == "misses":
        np.testing.assert_array_equal(out[0], 0)


def test_sentinels_never_match():
    assert (ROW_PAD_ID, IDX_PAD) == (-1, -2)
    tab, ids = _shard("int32")
    idx = np.full(5, IDX_PAD, np.int32)           # padded lookups ...
    out = emb_gather_plain(_t(tab[None]), _t(ids[None]), _t(idx))
    assert not out.any()                          # ... hit no padded slot
    upd = np.ones((5, 3), np.int32)
    out = emb_scatter_add_plain(_t(tab[None]), _t(ids[None]), _t(idx),
                                _t(upd))
    np.testing.assert_array_equal(out[0].numpy(), tab)


@pytest.mark.parametrize("dtype", ["int32", "fp32"])
def test_empty_batch(dtype):
    tabs, idss = _stack_cores(2, dtype)
    none = np.zeros(0, np.int32)
    out = emb_gather_plain(_t(tabs), _t(idss), _t(none))
    assert out.shape == (2, 0, 3) and out.dtype == _t(tabs).dtype
    ref = np.asarray(jops._emb_gather_pallas(tabs[0], idss[0], none))
    assert ref.shape == (0, 3)
    upd = np.zeros((0, 3), tabs.dtype)
    out = emb_scatter_add_plain(_t(tabs), _t(idss), _t(none), _t(upd))
    np.testing.assert_array_equal(out.numpy(), tabs)
    np.testing.assert_array_equal(
        np.asarray(jops._emb_scatter_add_pallas(tabs[0], idss[0], none,
                                                upd[:, :3])), tabs[0])


@pytest.mark.parametrize("kind", ["hits", "mixed", "all_same"])
@pytest.mark.parametrize("b", [1, 2, 30, 64])
@pytest.mark.parametrize("dtype", ["int32", "fp32"])
def test_scatter_add_plain_equals_reference(dtype, b, kind):
    tabs, idss = _stack_cores(3, dtype)
    idx = _lookups(idss[1], b, seed=b + 7, kind=kind)
    upd = _updates(dtype, b, 3, seed=b)
    out = emb_scatter_add_plain(_t(tabs), _t(idss), _t(idx),
                                _t(upd)).numpy()
    most = int(np.unique(idx, return_counts=True)[1].max())
    for c in range(3):
        ref = np.asarray(emb_scatter_add_ref(tabs[c], idss[c], idx, upd))
        pal = np.asarray(jops._emb_scatter_add_pallas(
            tabs[c], idss[c], idx, upd, interpret=True, block_r=8))
        np.testing.assert_array_equal(ref, pal)
        if dtype == "int32" or most <= 2:
            np.testing.assert_array_equal(out[c], ref)
        else:
            mass = np.abs(tabs[c]) + np.abs(emb_scatter_add_plain(
                _t(np.zeros_like(tabs[c:c + 1])), _t(idss[c:c + 1]),
                _t(idx), _t(np.abs(upd))).numpy()[0])
            assert np.all(np.abs(out[c] - ref) <= FP32_SCATTER_RTOL * mass)
    if kind == "all_same":
        (r,), = np.nonzero(idss[1] == idx[0])
        want = (tabs[1, r].astype(np.int64)
                + upd.astype(np.int64).sum(0)).astype(tabs.dtype)
        if dtype == "int32":                       # wraps as int32
            np.testing.assert_array_equal(out[1, r], want)


def test_scatter_add_leaves_the_input_table_alone():
    """The trainer's cached view is the table it starts from: the scatter
    writes a new table."""
    tabs, idss = _stack_cores(2, "int32")
    before = tabs.copy()
    t = _t(tabs)
    out = emb_scatter_add_plain(t, _t(idss), _t(idss[0, :4].copy()),
                                _t(np.ones((4, 3), np.int32)))
    np.testing.assert_array_equal(t.numpy(), before)
    assert not np.array_equal(out.numpy(), before)


# ---------------------------------------------------------------------------
# The CUDA kernels' lookups, modelled in plain torch.
# ---------------------------------------------------------------------------

def _lower_bound(keys, key):
    """How many of the ascending ``keys`` are below ``key``."""
    return int(torch.searchsorted(keys, torch.tensor([key], dtype=keys.dtype),
                                  side="left"))


def _gather_model(table, index, idx):
    """emb_gather.cu: per core, the lower bound of each lookup in the
    sorted ids, then the rows of the run of equal ids, summed from zero."""
    keys, rows = index
    n_cores, n_rows, dim = table.shape
    out = torch.zeros((n_cores, idx.shape[0], dim), dtype=table.dtype)
    for c in range(n_cores):
        for b, key in enumerate(idx.tolist()):
            acc = torch.zeros(dim, dtype=table.dtype)
            r = _lower_bound(keys[c], key)
            while r < n_rows and int(keys[c, r]) == key:
                acc = acc + table[c, int(rows[c, r])]
                r += 1
            out[c, b] = acc
    return out


def _scatter_model(table, ids, idx, upd):
    """emb_scatter_add.cu: the batch ids sorted (stable), each id's update
    rows summed once in batch order from zero at its first sorted
    position, and every table row plus the sum its id finds (+0 if
    none)."""
    keys, order = torch.sort(idx, stable=True)
    sums = torch.zeros((idx.shape[0], upd.shape[1]), dtype=table.dtype)
    for p in range(idx.shape[0]):
        if p and keys[p] == keys[p - 1]:
            continue
        acc = torch.zeros(upd.shape[1], dtype=table.dtype)
        t = p
        while t < idx.shape[0] and keys[t] == keys[p]:
            acc = acc + upd[int(order[t])].to(table.dtype)
            t += 1
        sums[p] = acc
    flat_ids = ids.reshape(-1)
    pos = torch.searchsorted(keys, flat_ids, side="left")
    found = pos < idx.shape[0]
    found[found.clone()] = keys[pos[found]] == flat_ids[found]
    add = torch.zeros((flat_ids.shape[0], upd.shape[1]), dtype=table.dtype)
    add[found] = sums[pos[found]]
    return table + add.reshape(table.shape)


def _brute_force_rows(ids, key):
    return [np.flatnonzero(ids[c] == key).tolist() for c in range(len(ids))]


def _index_rows(index, key):
    keys, rows = index
    found = []
    for c in range(keys.shape[0]):
        r = _lower_bound(keys[c], key)
        run = []
        while r < keys.shape[1] and int(keys[c, r]) == key:
            run.append(int(rows[c, r]))
            r += 1
        found.append(run)
    return found


@pytest.mark.parametrize("n_shards", [1, 7, 16])
@pytest.mark.parametrize("placement", ["mod", "hash"])
def test_gather_index_equals_a_brute_force_search(placement, n_shards):
    """Every id of the vocabulary, ids past it, IDX_PAD and ROW_PAD_ID (the
    pad slots: a run of them, in ascending row order), through a table's
    gather index, on the CPU; again after place_rows, which moves rows but
    keeps the placement, and so the index."""
    W = np.random.RandomState(n_shards).randn(45, 3).astype(np.float32)
    ts = tapi.make_system("pim", n_cores=n_shards, device="cpu")
    t = ts.put_table(W, placement=placement, seed=5)
    index = t.gather_index()
    assert t.gather_index() is index                  # built once
    assert all(a.dtype == torch.int32 and a.shape == t.ids.shape
               for a in index)
    keys = list(range(48)) + [IDX_PAD, ROW_PAD_ID]
    for key in keys:
        assert _index_rows(index, key) == _brute_force_rows(t.ids, key)
    t.place_rows(np.zeros((45, 3), np.float32))
    assert t.gather_index() is index
    for key in keys:
        assert _index_rows(index, key) == _brute_force_rows(t.ids, key)


def test_gather_index_of_ids_on_several_cores():
    ids = np.stack([np.random.RandomState(c).permutation(30)
                    for c in range(4)]).astype(np.int32)
    ids[2, 7] = ROW_PAD_ID
    index = gather_index(_t(ids))
    for key in range(-2, 32):
        assert _index_rows(index, key) == _brute_force_rows(ids, key)


@pytest.mark.parametrize("ids", [[[3, 5, 3]], [[0, 1], [4, 4]],
                                 [[ROW_PAD_ID, 2, 2, ROW_PAD_ID]]])
def test_gather_index_refuses_an_id_twice_on_one_core(ids):
    with pytest.raises(ValueError, match="repeats on core"):
        gather_index(_t(np.asarray(ids, np.int32)))


def test_gather_index_takes_pad_slots_and_int32_only():
    index = gather_index(_t(np.asarray([[ROW_PAD_ID, 4, ROW_PAD_ID]],
                                       np.int32)))
    assert index.ids.tolist() == [[ROW_PAD_ID, ROW_PAD_ID, 4]]
    assert index.rows.tolist() == [[0, 2, 1]]
    with pytest.raises(ValueError, match="int32"):
        gather_index(torch.zeros((2, 3), dtype=torch.int64))


@pytest.mark.parametrize("kind", ["hits", "misses", "mixed", "all_same",
                                  "shared"])
@pytest.mark.parametrize("dtype", ["int32", "fp32"])
def test_gather_model_equals_plain_and_reference(dtype, kind):
    tabs, idss = _stack_cores(3, dtype)
    if kind == "shared":                     # every core owns ids 0..21
        idss = np.stack([np.random.RandomState(c).permutation(22)
                         for c in range(3)]).astype(np.int32)
        idx = np.random.RandomState(9).randint(-2, 26, 40).astype(np.int32)
    else:
        idx = _lookups(idss[0], 40, seed=3, kind=kind)
    if dtype == "fp32":
        tabs[:, ::4] = -0.0                  # the sum from zero gives +0.0
    out = _gather_model(_t(tabs), gather_index(_t(idss)), _t(idx))
    plain = emb_gather_plain(_t(tabs), _t(idss), _t(idx))
    assert torch.equal(out, plain)
    assert not torch.signbit(out[out == 0]).any()
    if dtype == "int32":
        for c in range(3):
            np.testing.assert_array_equal(
                out[c].numpy(), np.asarray(emb_gather_ref(tabs[c], idss[c],
                                                          idx)))


@pytest.mark.parametrize("kind", ["hits", "mixed", "all_same", "shared"])
@pytest.mark.parametrize("b", [1, 64, 300])
@pytest.mark.parametrize("dtype", ["int32", "fp32"])
def test_scatter_model_equals_plain_and_reference(dtype, b, kind):
    """One sum per batch id, in batch order: bit for bit the plain
    version's, in float32 with 64 copies of one id too."""
    tabs, idss = _stack_cores(3, dtype)
    if kind == "shared":
        idss = np.stack([np.random.RandomState(c).permutation(22)
                         for c in range(3)]).astype(np.int32)
        idx = np.random.RandomState(b).randint(-2, 26, b).astype(np.int32)
    else:
        idx = _lookups(idss[1], b, seed=b, kind=kind)
    upd = _updates(dtype, b, 3, seed=b + 1)
    if dtype == "fp32":
        tabs[:, ::5] = -0.0
        upd[::3] = -0.0
    out = _scatter_model(_t(tabs), _t(idss), _t(idx), _t(upd))
    assert torch.equal(out, emb_scatter_add_plain(_t(tabs), _t(idss),
                                                  _t(idx), _t(upd)))
    if dtype == "int32":
        for c in range(3):
            np.testing.assert_array_equal(
                out[c].numpy(), np.asarray(emb_scatter_add_ref(
                    tabs[c], idss[c], idx, upd)))


# ---------------------------------------------------------------------------
# ShardedTable.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 7, 16])
@pytest.mark.parametrize("placement", ["mod", "hash"])
def test_table_grid_equals_reference(placement, n_shards):
    W = np.random.RandomState(n_shards).randn(23, 3).astype(np.float32)
    jt = japi.make_system("pim", n_cores=n_shards).put_table(
        W, placement=placement, seed=5)
    ts = tapi.make_system("pim", n_cores=n_shards, device="cpu")
    tt = ts.put_table(W, placement=placement, seed=5)
    np.testing.assert_array_equal(tt.ids, jt.ids)
    assert tt.rows_per_shard == jt.rows_per_shard
    for version in ("fp32", "int32"):
        js, jids = jt.view(version, frac_bits=10)
        shards, ids = tt.view(version, frac_bits=10)
        np.testing.assert_array_equal(shards.numpy(), np.asarray(js))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert tt.shard_stats == jt.shard_stats
    assert tt.n_views == 2
    # round trips: the placement and its inverse
    np.testing.assert_array_equal(tt.unshard(tt.view("fp32")[0].numpy()), W)
    raw = np.arange(23 * 3, dtype=np.int32).reshape(23, 3)
    placed = tt.place_rows(raw)
    np.testing.assert_array_equal(placed.numpy(),
                                  np.asarray(jt.place_rows(raw)))
    np.testing.assert_array_equal(tt.unshard(placed.numpy()), raw)
    assert tt.shard_stats == jt.shard_stats
    assert tt.lookup_shard(5) == jt.lookup_shard(5)


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_ledger_drain_equals_reference(dtype, dedup):
    W = np.zeros((8, 2), np.float32)
    jt = japi.make_system("pim", n_cores=2).put_table(W)
    tt = tapi.make_system("pim", n_cores=2, device="cpu").put_table(W)
    rng = np.random.RandomState(0)
    for _ in range(3):
        idx = rng.randint(0, 8, 5)
        upd = (rng.randint(-2 ** 31, 2 ** 31 - 1, (5, 2), np.int64)
               .astype(dtype))
        jt.stage(idx, upd)
        tt.stage(idx, upd)
    assert (tt.pending_batches, tt.pending_rows) == (3, 15)
    for a, b in zip(tt.pending_arrays(), jt.pending_arrays()):
        np.testing.assert_array_equal(a, b)
    got, want = tt.drain(dedup=dedup), jt.drain(dedup=dedup)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tt.pending_batches == 0
    for a, b in zip(tt.drain(), jt.drain()):       # empty ledger
        assert a.shape == b.shape and a.dtype == b.dtype


# ---------------------------------------------------------------------------
# Whole fits.
# ---------------------------------------------------------------------------

def _fit_both(version, kind, n_cores, data, reduce="fabric", **params):
    X, y = data
    js = japi.make_system(kind, n_cores=n_cores, reduce=reduce)
    ts = tapi.make_system(kind, n_cores=n_cores, reduce=reduce, device="cpu")
    p = {**PARAMS, **params}
    je = japi.make_estimator("emb", version=version, system=js, **p).fit(X, y)
    te = tapi.make_estimator("emb", version=version, system=ts, **p).fit(X, y)
    return je.result_.model, te.result_.model, js.stats, ts.stats


def _assert_same_fit(jm, tm, jstats, tstats, version):
    assert tm.user_raw.dtype == jm.user_raw.dtype
    assert tm.n_flushes == jm.n_flushes
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert [h[0] for h in tm.history] == [h[0] for h in jm.history]
    if version == "int32":
        np.testing.assert_array_equal(tm.user_raw, jm.user_raw)
        np.testing.assert_array_equal(tm.item_raw, jm.item_raw)
        np.testing.assert_array_equal(tm.user_emb, jm.user_emb)
        assert tm.history == jm.history
    else:
        for a, b in ((tm.user_raw, jm.user_raw), (tm.item_raw, jm.item_raw)):
            np.testing.assert_allclose(a, b, rtol=FP32_RTOL, atol=FP32_ATOL)
        np.testing.assert_allclose([h[1] for h in tm.history],
                                   [h[1] for h in jm.history],
                                   rtol=FP32_HIST_RTOL)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kind,n_cores", SYSTEMS)
@pytest.mark.parametrize("version", ["int32", "fp32"])
def test_fit_matches_reference(version, kind, n_cores, mode, recsys):
    _assert_same_fit(*_fit_both(version, kind, n_cores, recsys,
                                **MODES[mode]), version)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("reduce", ["host", "hierarchical"])
@pytest.mark.parametrize("kind,n_cores", SYSTEMS)
def test_reduce_strategies_match_reference(kind, n_cores, reduce, mode,
                                           recsys):
    _assert_same_fit(*_fit_both("int32", kind, n_cores, recsys,
                                reduce=reduce, **MODES[mode]), "int32")


@pytest.mark.parametrize("version", ["int32", "fp32"])
def test_fp32_and_int32_at_batch_above_32(version, recsys):
    """Batches over 32 take the reference's windowed float32 loss sum."""
    _assert_same_fit(*_fit_both(version, "pim", 7, recsys, batch=100,
                                placement="hash", flush_every=3), version)


def test_deferred_d1_equals_eager(recsys):
    X, y = recsys
    fits = {}
    for mode in ("eager", "deferred_d1"):
        ts = tapi.make_system("pim", n_cores=7, device="cpu")
        fits[mode] = (tapi.make_estimator("emb", version="int32", system=ts,
                                          **PARAMS, **MODES[mode])
                      .fit(X, y).result_.model, ts.stats.flush_bytes)
    (a, fa), (b, fb) = fits["eager"], fits["deferred_d1"]
    np.testing.assert_array_equal(a.user_raw, b.user_raw)
    np.testing.assert_array_equal(a.item_raw, b.item_raw)
    assert fa == fb


def _snapshot(pkg, X, y, params, step):
    """The snapshot a ``pkg`` fit on 8 cores takes after ``step`` steps."""
    kw = {} if pkg is japi else {"device": "cpu"}
    wl = pkg.get_workload("emb")
    gen = wl.fit_steps(pkg.make_system("pim", n_cores=8, **kw).put(X, y),
                       wl.spec("int32", **params))
    done = 0
    while True:
        tick = next(gen)
        done += int(tick)
        if done >= step:
            return tick.snapshot()


@pytest.mark.parametrize("source,target", [("reference", "port"),
                                           ("port", "port"),
                                           ("port", "reference")])
def test_mid_window_snapshot_resumes(source, target, recsys):
    """A snapshot taken 10 steps into a D=4 compressed fit (two steps
    staged in the ledger, a compression residual pending) resumes on 3
    cores as the uninterrupted reference fit ends, whichever package took
    it and whichever resumes it."""
    X, y = recsys
    params = {**PARAMS, "flush_every": 4, "compress_flush": True}
    full = japi.make_estimator("emb", version="int32", **params,
                               system=japi.make_system("pim", n_cores=8))
    ref = full.fit(X, y).result_.model
    snap = _snapshot(japi if source == "reference" else tapi, X, y, params,
                     step=10)
    assert snap["meta"]["pend_u_batches"] > 0
    assert snap["arrays"]["pend_u_idx"].size > 0
    pkg = japi if target == "reference" else tapi
    kw = {} if pkg is japi else {"device": "cpu"}
    wl = pkg.get_workload("emb")
    res = _drain(wl.fit_steps(
        pkg.make_system("pim", n_cores=3, **kw).put(X, y),
        wl.spec("int32", **params), state=snap)).model
    np.testing.assert_array_equal(res.user_raw, ref.user_raw)
    np.testing.assert_array_equal(res.item_raw, ref.item_raw)
    assert res.history == ref.history and res.n_flushes < ref.n_flushes


def _drain(gen):
    while True:
        try:
            next(gen)
        except StopIteration as stop:
            return stop.value


# ---------------------------------------------------------------------------
# CompressedReduce, the estimator, the launcher.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inner", ["fabric", "host", "hierarchical"])
def test_compressed_reduce_equals_reference(inner):
    rng = np.random.RandomState(4)
    # quarter-integers: the float sums are exact in any order, so the
    # quantizer sees equal payloads in both packages
    rows = (rng.randint(-400, 400, (48, 3)) / 4).astype(np.float32)
    ints = rng.randint(-99, 99, (48, 2)).astype(np.int32)
    js = japi.make_system("pim", n_cores=16)
    ts = tapi.make_system("pim", n_cores=16, device="cpu")
    jx, ji = js.shard_rows(rows), js.shard_rows(ints)
    tx, ti = ts.shard_rows(rows), ts.shard_rows(ints)
    jk = js.named_kernel("t.sums", lambda: (
        lambda xs, qs: {"s": jnp.sum(xs, axis=0), "q": jnp.sum(qs, axis=0)}))
    jstrat = jcompress.CompressedReduce(inner)
    tstrat = tcompress.CompressedReduce(inner)
    for _ in range(3):                 # the error feedback carries over
        jo = js.map_reduce(jk, (jx, ji), (), strategy=jstrat)
        to = ts.map_reduce(
            lambda xs, qs: {"s": xs.sum(1), "q": qs.sum(1, dtype=torch.int32)},
            (tx, ti), (), strategy=tstrat)
        for key in ("s", "q"):
            got = to[key].numpy() if isinstance(to[key], torch.Tensor) \
                else np.asarray(to[key])
            np.testing.assert_array_equal(got, np.asarray(jo[key]))
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)
    assert ts.stats.compressed_bytes > 0


def test_quantize_rows_equals_reference():
    rng = np.random.RandomState(2)
    for upd in (rng.randint(-5000, 5000, (9, 4)).astype(np.int32),
                rng.randn(9, 4).astype(np.float32),
                np.zeros((0, 4), np.int32)):
        for a, b in zip(tcompress.quantize_rows(upd),
                        jcompress.quantize_rows(upd)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        err = np.zeros(upd.shape, np.float32)
        for a, b in zip(tcompress.ef_quantize(upd, err),
                        jcompress.ef_quantize(upd, err)):
            np.testing.assert_array_equal(a, b)


def test_estimator_round_trip():
    X, y = tsyn.make_recsys(2048, 128, 96, dim=4, seed=0)
    jX, jy = jsyn.make_recsys(2048, 128, 96, dim=4, seed=0)
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    params = dict(version="int32", n_iters=60, batch=64, dim=4, lr=1.0,
                  frac_bits=12, flush_every=4, seed=1)
    ts = tapi.make_system("pim", n_cores=8, device="cpu")
    est = tapi.make_estimator("emb", system=ts, **params)
    est.fit(ts.put(X, y))
    ref = japi.make_estimator("emb", **params,
                              system=japi.make_system("pim", n_cores=8))
    ref.fit(X, y)
    assert est.score(X, y) == ref.score(X, y) > 0.4
    np.testing.assert_array_equal(est.predict(X[:5]), ref.predict(X[:5]))
    np.testing.assert_array_equal(est.user_emb_, ref.user_emb_)
    assert est.n_flushes_ == ref.n_flushes_ == 15
    wl = tapi.get_workload("EMB")
    assert wl is tapi.get_workload("embedding") and wl.resumable
    assert wl.defaults == {k: v for k, v in
                           japi.get_workload("emb").defaults.items()
                           if k != "kernel_backend"}


def test_step_fusion_is_refused_until_ported(recsys):
    """Step fusion runs: fused deferred int32 windows equal the serial
    deferred fit (tables and history), one launch a chunk plus the
    flushes."""
    fits = {}
    for fuse in (1, 4):
        ts = tapi.make_system("pim", n_cores=4, device="cpu")
        fits[fuse] = (tapi.make_estimator(
            "emb", version="int32", fuse_steps=fuse, flush_every=4,
            system=ts, **PARAMS).fit(*recsys).result_.model, ts.stats)
    (r1, s1), (r4, s4) = fits[1], fits[4]
    np.testing.assert_array_equal(r4.user_raw, r1.user_raw)
    np.testing.assert_array_equal(r4.item_raw, r1.item_raw)
    assert r4.history == r1.history and r4.n_flushes == r1.n_flushes == 5
    assert s4.kernel_launches == 5 + 5 and s1.kernel_launches == 20 + 5


def test_emb_view_validation():
    ts = tapi.make_system("pim", n_cores=2, device="cpu")
    y = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="index pairs"):
        ts.put(np.zeros((3, 3)), y).emb_view()
    with pytest.raises(ValueError, match="integral"):
        ts.put(np.full((3, 2), 0.5), y).emb_view()
    with pytest.raises(ValueError, match="non-negative"):
        ts.put(-np.ones((3, 2), np.int64), y).emb_view()
    with pytest.raises(ValueError, match="targets"):
        ts.put(np.zeros((3, 2), np.int32)).emb_view()
    pairs, targets = ts.put(np.ones((3, 2)), y).emb_view()
    assert pairs.dtype == np.int32 and targets.dtype == np.float32


def test_cpu_fit_counts_no_kernel_launches(recsys):
    dispatch.reset_launch_counts()
    ts = tapi.make_system("pim", n_cores=4, device="cpu")
    tapi.make_estimator("emb", version="int32", n_iters=3, batch=16,
                        system=ts).fit(*recsys)
    assert dispatch.launch_counts == {}


def test_launcher_trains_emb_on_cpu(capsys):
    pim_ml.main(["--workload", "emb", "--device", "cpu", "--samples",
                 "2000", "--features", "4", "--iters", "20", "--cores", "7",
                 "--param", "flush_every=4"])
    out = capsys.readouterr().out
    assert "session: emb on pim (7 cores" in out
    rows = [line.split() for line in out.splitlines()
            if line.strip().startswith(("fp32", "int32"))]
    assert [r[0] for r in rows] == ["fp32", "int32"]
    assert all(np.isfinite(float(r[1])) for r in rows)
    assert "transfers:" in out


def test_batch_loss_sums_in_the_reference_order():
    """The loss helper against the reference's compiled update, at batch
    sizes on both sides of its 32-element reduce window."""
    for b in (7, 32, 33, 100):
        cfg = jtrain.EmbConfig(version="int32", batch=b, dim=16)
        _, update = jtrain.make_emb_step_fns(cfg)
        rng = np.random.RandomState(b)
        red = {"u": rng.randint(-2000, 2000, (b, 16)).astype(np.int32),
               "i": rng.randint(-2000, 2000, (b, 16)).astype(np.int32),
               "y": rng.randint(-20000, 20000, b).astype(np.int32)}
        _, (_, _, sq) = jax.jit(update)(jnp.int32(0), red)
        tcfg = ttrain.EmbConfig(version="int32", batch=b, dim=16)
        _, _, err = ttrain.make_emb_update(tcfg, torch.device("cpu"))(
            {k: torch.from_numpy(v) for k, v in red.items()})
        e = err.numpy().astype(np.float32) * np.float32(2.0 ** -10)
        assert ttrain.batch_sq_error(e) == np.float32(sq)

