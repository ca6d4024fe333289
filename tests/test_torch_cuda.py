"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode), is
marked ``cuda`` and skips without one.  The file imports no JAX, so it
runs where only the port is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import copy
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.api import make_estimator, make_system
from repro_torch.core.lut import SigmoidLut, build_sigmoid_lut
from repro_torch.data.synthetic import (make_blobs, make_classification,
                                        make_linear_dataset, make_recsys)
from repro_torch.kernels import dispatch
from repro_torch.kernels.gini_split import gini_split_cuda, gini_split_plain
from repro_torch.kernels.kmeans_assign import (kmeans_assign_cuda,
                                               kmeans_assign_plain)
from repro_torch.kernels.lut_activation import (lut_sigmoid_cuda,
                                                lut_sigmoid_plain)
from repro_torch.configs.base import get_config
from repro_torch.kernels.flash_attention import mha_cuda, mha_plain
from repro_torch.kernels.quant_matmul import (fx_matvec_cuda, fx_matvec_plain,
                                              int_matmul_cuda,
                                              int_matmul_plain,
                                              int_matmul_plan, quant_dense)
from repro_torch.models.api import Model
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.kernels.sparse_gather import (IDX_PAD, ROW_PAD_ID,
                                               emb_gather_cuda,
                                               emb_gather_plain,
                                               emb_scatter_add_cuda,
                                               emb_scatter_add_plain,
                                               gather_index)

pytestmark = pytest.mark.cuda

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ints(rng, shape, lo=INT32_MIN, hi=INT32_MAX):
    return torch.from_numpy(rng.randint(lo, hi, size=shape, dtype=np.int64)
                            .astype(np.int32))


@pytest.mark.parametrize("shape,f", [((2048, 3072), 16), ((7, 143), 13),
                                     ((1025,), 4), ((3,), 1), ((5, 9), 33)])
@pytest.mark.parametrize("frac_bits", [10, 0])
def test_fx_matvec_kernel_equals_plain(cuda, shape, f, frac_bits):
    rng = np.random.RandomState(f)
    x, w = _ints(rng, (*shape, f)), _ints(rng, f)   # products wrap int32
    out = fx_matvec_cuda(x.to(cuda), w.to(cuda), frac_bits)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), fx_matvec_plain(x, w, frac_bits))


def test_fx_matvec_unaligned_rows_take_the_scalar_path(cuda):
    rng = np.random.RandomState(1)
    flat, w = _ints(rng, 1000 * 16 + 1), _ints(rng, 16)
    x = flat[1:].reshape(1000, 16)            # starts 4 B past an alignment
    xs = flat.to(cuda)[1:].reshape(1000, 16)
    assert xs.is_contiguous() and xs.data_ptr() % 16
    out = fx_matvec_cuda(xs, w.to(cuda), 10)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), fx_matvec_plain(x, w, 10))


@pytest.mark.parametrize("placement", ["wram", "mram"])
@pytest.mark.parametrize("shape", [(2048, 3072), (257, 129), (1,)])
def test_lut_sigmoid_kernel_equals_plain(cuda, placement, shape):
    rng = np.random.RandomState(5)
    edges = np.array([0, 1, -1, 20479, -20479, 20480, -20480, INT32_MAX,
                      INT32_MIN, INT32_MIN + 1], np.int32)
    q = np.concatenate([edges, rng.randint(-30000, 30000, int(np.prod(shape)))
                        .astype(np.int32)])[:int(np.prod(shape))]
    q = torch.from_numpy(q.reshape(shape))
    out = lut_sigmoid_cuda(q.to(cuda), build_sigmoid_lut(device=cuda),
                           placement)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), lut_sigmoid_plain(q, build_sigmoid_lut()))


def _lut(n_table, device="cpu"):
    """The paper's table, or its first n_table entries as a SigmoidLut of
    their own (an odd length leaves a scalar tail after the 16-byte
    copies of the shared placement)."""
    lut = build_sigmoid_lut()
    return SigmoidLut(lut.table[:n_table].clone().to(device), lut.frac_bits,
                      lut.boundary, lut.value_frac)


def _lut_edges(n_table):
    return [0, 1, -1, n_table - 1, -(n_table - 1), n_table, -n_table,
            INT32_MAX, INT32_MIN, INT32_MIN + 1]


@pytest.mark.parametrize("placement", ["wram", "mram"])
@pytest.mark.parametrize("n_table", [20 * 1024, 1001])
@pytest.mark.parametrize("offset", [4, 8, 12])
@pytest.mark.parametrize("rem", [1, 2, 3])
def test_lut_sigmoid_misaligned_ragged_edges(cuda, placement, n_table,
                                             offset, rem):
    """x starts ``offset`` bytes past a 16-byte boundary and holds 4k +
    ``rem`` elements: a scalar head, vectors and a scalar tail.  Each
    edge value in turn fills the head, the first and last vectors and the
    tail; bit-identical to the plain version."""
    rng = np.random.RandomState(offset * 4 + rem)
    n = 40_000 + rem
    head = (16 - offset) // 4
    tail = (n - head) % 4
    lut, dev_lut = _lut(n_table), _lut(n_table, cuda)
    for e in _lut_edges(n_table):
        q = rng.randint(-30000, 30000, n).astype(np.int32)
        q[:head + 4] = e
        q[n - tail - 4:] = e
        pad = np.zeros(offset // 4, np.int32)
        x = torch.from_numpy(np.concatenate([pad, q])).to(cuda)[pad.size:]
        assert x.data_ptr() % 16 == offset
        out = lut_sigmoid_cuda(x, dev_lut, placement)
        torch.cuda.synchronize()
        assert out.data_ptr() % 16 == offset       # the vector path
        assert torch.equal(out.cpu(),
                           lut_sigmoid_plain(torch.from_numpy(q), lut))


@pytest.mark.parametrize("placement", ["wram", "mram"])
def test_lut_sigmoid_unaligned_table(cuda, placement):
    """A table that starts 2 bytes past a boundary (a view): WRAM stages
    an aligned copy, MRAM gathers from it as it lies."""
    lut = build_sigmoid_lut()
    big = torch.cat([lut.table[:1], lut.table]).to(cuda)
    view = SigmoidLut(big[1:], lut.frac_bits, lut.boundary, lut.value_frac)
    assert view.table.data_ptr() % 16 == 2
    q = torch.from_numpy(np.random.RandomState(3).randint(
        -30000, 30000, 99_999).astype(np.int32))
    out = lut_sigmoid_cuda(q.to(cuda), view, placement)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), lut_sigmoid_plain(q, lut))


def test_lut_sigmoid_refuses_a_wram_table_over_shared_memory(cuda):
    big = SigmoidLut(torch.zeros(48 * 1024 // 2 + 1, dtype=torch.int16,
                                 device=cuda), 10, 24, 15)
    x = torch.zeros(16, dtype=torch.int32, device=cuda)
    dispatch.reset_launch_counts()
    with pytest.raises(ValueError, match="does not fit"):
        lut_sigmoid_cuda(x, big, "wram")
    assert torch.equal(lut_sigmoid_cuda(x, big, "mram").cpu(),
                       torch.zeros(16, dtype=torch.int32))
    assert dispatch.launch_counts == {"lut_sigmoid": 1}


@pytest.mark.parametrize("workload,version", [("linreg", "int32"),
                                              ("logreg", "int32_lut_mram"),
                                              ("logreg", "int32_lut_wram"),
                                              ("logreg", "bui_lut")])
def test_fit_on_the_card_equals_the_cpu_fit(cuda, workload, version):
    X, y, _ = make_linear_dataset(4096, 16, seed=0)
    fits = {}
    dispatch.reset_launch_counts()
    for device in ("cuda", "cpu"):
        system = make_system("pim", n_cores=16, device=device)
        est = make_estimator(workload, version=version, n_iters=5,
                             system=system).fit(X, y)
        fits[device] = (est.coef_, est.intercept_, system.stats)
    np.testing.assert_array_equal(fits["cuda"][0], fits["cpu"][0])
    assert fits["cuda"][1:] == fits["cpu"][1:]
    expected = {"fx_matvec": 5 * ("int32" in version),
                "lut_sigmoid": 5 * ("lut" in version)}
    assert dispatch.launch_counts == {k: v for k, v in expected.items() if v}


def _int16(gen, shape, lo, hi, dev):
    return torch.randint(lo, hi, shape, generator=gen, device=dev,
                         dtype=torch.int32).to(torch.int16)


@pytest.mark.parametrize("case", ["main", "ragged_full_range", "ties",
                                  "unaligned", "k1", "k9", "k33", "f1",
                                  "f40", "n1", "main_full_range"])
def test_kmeans_assign_kernel_equals_plain(cuda, case):
    """The KME main shape [2048, 12500, 16] x K=16 (quantized and
    full-range), a ragged shape with full-range int16 (products and norms
    wrap), duplicated centroids (ties: the first wins), rows that are not
    16-byte aligned (2-byte copies), one cluster, K = 9 (a padded tile),
    K = 33 (three tiles), one feature, F = 40 (three feature steps) and
    one row a core."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    lo, hi = -32768, 32768
    shapes = {"k1": ((4, 3001, 16), 1), "k9": ((4, 3001, 16), 9),
              "k33": ((5, 2999, 16), 33), "f1": ((6, 3001, 1), 7),
              "f40": ((3, 4001, 40), 33), "n1": ((5, 1, 16), 16),
              "main_full_range": ((2048, 12500, 16), 16)}
    if case == "main":
        x = _int16(gen, (2048, 12500, 16), -2047, 2048, cuda)
        c = _int16(gen, (16, 16), -2047, 2048, cuda)
    elif case == "ragged_full_range":
        x = _int16(gen, (7, 1027, 13), lo, hi, cuda)
        c = _int16(gen, (5, 13), lo, hi, cuda)
        x[0, 0], c[0] = 32767, -32768
    elif case == "ties":
        x = _int16(gen, (3, 4097, 16), -3, 4, cuda)
        c = _int16(gen, (9, 16), -1, 2, cuda)
        c[4], c[8] = c[2], c[0]
    elif case == "unaligned":
        flat = _int16(gen, (5 * 999 * 16 + 1,), lo, hi, cuda)
        x = flat[1:].view(5, 999, 16)
        c = _int16(gen, (16, 16), lo, hi, cuda)
        assert x.data_ptr() % 16
    else:
        (shape, k) = shapes[case]
        x = _int16(gen, shape, lo, hi, cuda)
        c = _int16(gen, (k, shape[2]), lo, hi, cuda)
        x[0, 0], c[0] = 32767, -32768
    out = kmeans_assign_cuda(x, c)
    torch.cuda.synchronize()
    ref = kmeans_assign_plain(x, c)
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    if case == "ties":
        assert not torch.isin(out[0], torch.tensor([4, 8], device=cuda)).any()


def test_kmeans_assign_chained_calls(cuda):
    """Two calls on other inputs at the main shape, where one block owns a
    core and stores its partial into memory allocated empty: the second
    call's partial may reuse the first's memory, so an entry left unwritten
    would show."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    for lo, hi in ((-2047, 2048), (-3, 4)):
        x = _int16(gen, (2048, 12500, 16), lo, hi, cuda)
        c = _int16(gen, (16, 16), lo, hi, cuda)
        out = kmeans_assign_cuda(x, c)
        torch.cuda.synchronize()
        for o, r in zip(out, kmeans_assign_plain(x, c)):
            assert torch.equal(o, r)
        del out


GINI_CASES = {        # C, n_pc, F, L, classes, leaves [lo, hi)
    "root": (2048, 37500, 16, 4096, 2, 0, 1),
    "spread": (2048, 37500, 16, 4096, 2, 0, 1024),
    "ragged": (5, 1027, 13, 37, 3, 0, 37),
    "spread_4096": (2048, 37500, 16, 4096, 2, 0, 4096),
    "frontier": (2048, 37500, 16, 4096, 2, 1023, 2047),
    "long_core": (132, 150_001, 16, 4096, 2, 0, 1024),
    "cls3_f13": (64, 20_000, 13, 4096, 3, 0, 2047),
    "few_cores": (16, 600_000, 16, 4096, 2, 0, 1024),
    "few_cores_4096": (3, 200_001, 16, 4096, 2, 0, 4096),
}


def _gini_inputs(gen, dev, case):
    n_cores, n_pc, f, n_leaves, n_cls, lo, hi = GINI_CASES[case]
    x = torch.randn((n_cores, n_pc, f), generator=gen, device=dev)
    y = torch.randint(0, n_cls, (n_cores, n_pc), generator=gen, device=dev,
                      dtype=torch.int32)
    leaf = torch.randint(lo, hi, (n_cores, n_pc), generator=gen,
                         device=dev, dtype=torch.int32)
    if case in ("ragged", "cls3_f13"):
        leaf[0, :9], y[1, :9] = n_leaves, n_cls
        leaf[2, :5] = -1
    th = torch.randn((n_leaves, f), generator=gen, device=dev)
    th[lo, 0] = x[0, 0, 0]                # x == threshold counts as below
    leaf[0, 0] = lo
    return x, y, leaf, th, n_cls


@pytest.mark.parametrize("case", list(GINI_CASES))
def test_gini_counts_kernel_equals_plain(cuda, case):
    """The DTR main shape (2048 cores x 37,500 rows x 16, L = 4096) with
    every row at the root, with leaves spread over 2^10 values, over all
    4,096 (wider than the window: rows past it add to global memory) and
    over a depth-10 frontier's ids 1023-2046; a ragged shape and 3 classes
    at F = 13 with rows whose leaf or class is out of range; one block a
    core over more than 65,535 rows (three passes of 16-bit counters);
    too few cores to fill the card, so that several blocks a core add
    into its partial, over two passes each and past the window."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    args = _gini_inputs(gen, cuda, case)
    out = gini_split_cuda(*args)
    torch.cuda.synchronize()
    ref = gini_split_plain(*args)
    for o, r in zip(out, ref):
        assert torch.equal(o, r)


def test_gini_counts_chained_calls(cuda):
    """Calls on other inputs in turn: the kernel writes every entry of
    partials allocated empty, so a later call's, which may reuse an
    earlier one's memory, shows any entry left unwritten (and a split
    core's zeroed partial, any stale one)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    for case in ("spread", "frontier", "few_cores", "root"):
        args = _gini_inputs(gen, cuda, case)
        out = gini_split_cuda(*args)
        torch.cuda.synchronize()
        for o, r in zip(out, gini_split_plain(*args)):
            assert torch.equal(o, r)
        del out


def test_kmeans_fit_on_the_card_equals_the_cpu_fit(cuda):
    X, _, _ = make_blobs(100_000, 16, centers=16, seed=0)
    fits = {}
    dispatch.reset_launch_counts()
    for device in ("cuda", "cpu"):
        system = make_system("pim", n_cores=64, device=device)
        ds = system.put(X)
        est = {v: make_estimator("kmeans", version=v, max_iter=10, tol=0.0,
                                 system=system).fit(ds)
               for v in ("int16", "fp32")}
        fits[device] = (est, system.stats)
    (g, gs), (c, cs) = fits["cuda"], fits["cpu"]
    np.testing.assert_array_equal(g["int16"].cluster_centers_,
                                  c["int16"].cluster_centers_)
    np.testing.assert_array_equal(g["int16"].labels_, c["int16"].labels_)
    assert g["int16"].n_iter_ == c["int16"].n_iter_ == 10
    np.testing.assert_allclose(g["fp32"].cluster_centers_,
                               c["fp32"].cluster_centers_, rtol=1e-4,
                               atol=1e-3)
    assert gs == cs
    assert dispatch.launch_counts == {"kmeans_assign": 10}


def test_dtree_fit_on_the_card_equals_the_cpu_fit(cuda):
    X, y = make_classification(200_000, 16, seed=0, class_sep=1.4)
    fits = {}
    dispatch.reset_launch_counts()
    for device in ("cuda", "cpu"):
        system = make_system("pim", n_cores=64, device=device)
        est = make_estimator("dtree", max_depth=8, system=system).fit(X, y)
        fits[device] = (est.tree_, system.stats)
    (g, gs), (c, cs) = fits["cuda"], fits["cpu"]
    for name in ("feature", "threshold", "left", "right", "leaf_class",
                 "depth"):
        np.testing.assert_array_equal(getattr(g, name), getattr(c, name))
    assert g.n_nodes == c.n_nodes and gs == cs
    rounds = int(g.depth[:g.n_nodes].max()) + 1
    assert dispatch.launch_counts == {"gini_split": rounds}


def _emb_case(case, dtype, dev):
    """A table [C, R, D] with its id map (the tail slots ROW_PAD_ID), and
    lookups: the EMB main shape with Zipf ids, a ragged shape with misses
    and IDX_PAD, 64 copies of one id, a wide row (D > 32) with a batch
    over one shared-memory tile, or one shard too long for the gather to
    stage its ids (a host-target table).  int32 values are full-range,
    so the scatter's sums wrap; float32 values are finite and never 0."""
    n_cores, n_rows, dim, b = {"main": (2048, 235, 16, 64),
                               "ragged": (7, 13, 3, 37),
                               "all_same": (16, 40, 16, 64),
                               "wide": (3, 50, 40, 1500),
                               "one_shard": (1, 20000, 5, 33)}[case]
    rng = np.random.RandomState(n_rows)
    vocab = n_cores * n_rows - 5
    ids = np.full(n_cores * n_rows, ROW_PAD_ID, np.int32)
    ids[:vocab] = np.arange(vocab)
    ids = np.ascontiguousarray(ids.reshape(n_rows, n_cores).T)
    idx = np.minimum(rng.pareto(1.2, b).astype(np.int64),
                     vocab - 1).astype(np.int32)
    if case == "ragged":
        idx[::4], idx[1::4] = IDX_PAD, vocab + 3
    if case == "all_same":
        idx[:] = 7
    if dtype == torch.int32:
        tab = _ints(rng, (n_cores, n_rows, dim))
        upd = _ints(rng, (b, dim))
    else:
        tab = torch.from_numpy(rng.uniform(0.5, 2, (n_cores, n_rows, dim))
                               .astype(np.float32))
        upd = torch.from_numpy(rng.randn(b, dim).astype(np.float32))
    return [t.to(dev) for t in (tab, torch.from_numpy(ids),
                                torch.from_numpy(idx), upd)]


def _emb_equal_plain(tab, ids, idx, upd):
    """Both kernels against their plain versions, bit for bit; the input
    table is left as it was."""
    before = tab.clone()
    gathered = emb_gather_cuda(tab, ids, idx, gather_index(ids))
    scattered = emb_scatter_add_cuda(tab, ids, idx, upd)
    torch.cuda.synchronize()
    assert torch.equal(gathered, emb_gather_plain(tab, ids, idx))
    assert torch.equal(scattered, emb_scatter_add_plain(tab, ids, idx, upd))
    assert torch.equal(tab, before)           # a new table, out of place


@pytest.mark.parametrize("case", ["main", "ragged", "all_same", "wide",
                                  "one_shard"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_emb_kernels_equal_plain(cuda, dtype, case):
    _emb_equal_plain(*_emb_case(case, dtype, cuda))


def _emb_grid(rng, n_cores, n_rows, dim, b, dtype, dev, *, shared=False,
              hot=False, negzero=False):
    """A table of ``n_cores`` shards of ``n_rows`` rows, its id map and
    ``b`` lookups with update rows.  ``shared``: every core owns the same
    ids (each once, in another order); ``hot``: every lookup is one id;
    ``negzero``: float32 rows of -0.0 and zero update rows of both signs.
    Lookups mix owned ids, ids owned nowhere and IDX_PAD."""
    if shared:
        ids = np.stack([rng.permutation(n_rows) for _ in range(n_cores)])
        vocab = n_rows
    else:
        vocab = n_cores * n_rows - 3
        flat = np.full(n_cores * n_rows, ROW_PAD_ID, np.int64)
        flat[:vocab] = rng.permutation(vocab)
        ids = flat.reshape(n_cores, n_rows)
    idx = rng.randint(0, vocab + 5, b)
    idx[::7] = IDX_PAD
    if hot:
        idx[:] = ids[n_cores // 2, n_rows // 3]
    if dtype == torch.int32:
        tab, upd = _ints(rng, (n_cores, n_rows, dim)), _ints(rng, (b, dim))
    else:
        tab = torch.from_numpy(rng.randn(n_cores, n_rows, dim)
                               .astype(np.float32))
        upd = torch.from_numpy(rng.randn(b, dim).astype(np.float32))
        if negzero:
            tab[:, ::2] = -0.0
            upd[::3] = 0.0
            upd[1::3] = -0.0
    return [t.to(dev) for t in (tab, torch.from_numpy(ids.astype(np.int32)),
                                torch.from_numpy(idx.astype(np.int32)), upd)]


@pytest.mark.parametrize("b", [1, 64, 1100])
@pytest.mark.parametrize("dim", [3, 8, 16, 48])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_emb_kernels_widths_and_batches(cuda, dtype, dim, b):
    """D on the 4-byte and the 16-byte paths, one lookup, an eager batch
    and a batch over 1,024 ids; R = 37 is not a multiple of 32."""
    rng = np.random.RandomState(dim * 10_000 + b)
    _emb_equal_plain(*_emb_grid(rng, 96, 37, dim, b, dtype, cuda))


@pytest.mark.parametrize("case", ["negzero", "shared_ids", "hot_id",
                                  "long_shard", "long_batch"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_emb_kernels_edge_cases(cuda, dtype, case):
    """-0.0 rows and update rows; ids repeated across cores; 64 copies of
    one id (float32 sums in batch order); R = 13,000, past the gather's
    shared-memory staging (12,288 ids); B = 13,000, past the scatter's."""
    rng = np.random.RandomState(len(case))
    n_cores, n_rows, dim, b = {"negzero": (64, 40, 16, 64),
                               "shared_ids": (33, 50, 8, 64),
                               "hot_id": (16, 40, 16, 64),
                               "long_shard": (3, 13000, 16, 64),
                               "long_batch": (40, 400, 4, 13000)}[case]
    _emb_equal_plain(*_emb_grid(rng, n_cores, n_rows, dim, b, dtype, cuda,
                                shared=case == "shared_ids",
                                hot=case == "hot_id",
                                negzero=case == "negzero"))


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_emb_scatter_add_padded_flush(cuda, dtype):
    """A deferred flush as the trainer ships it: eight batches of Zipf ids
    deduplicated and padded with IDX_PAD (and zero rows) to a multiple of
    64."""
    tab, ids, _, _ = _emb_case("main", dtype, cuda)
    rng = np.random.RandomState(8)
    flush = np.unique(np.minimum(rng.pareto(1.2, 512).astype(np.int64),
                                 ids.numel() - 6))
    pad = -len(flush) % 64
    idx = np.concatenate([flush, np.full(pad, IDX_PAD)]).astype(np.int32)
    upd = (_ints(rng, (len(idx), 16)) if dtype == torch.int32 else
           torch.from_numpy(rng.randn(len(idx), 16).astype(np.float32)))
    upd[len(flush):] = 0
    _emb_equal_plain(tab, ids, torch.from_numpy(idx).to(cuda), upd.to(cuda))


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_emb_scatter_add_chained_calls(cuda, dtype):
    """Twenty scatters back to back, each on the last one's table, with no
    synchronisation between them, as a fit makes them: on a small table the
    pass over it may start before the batch's sums are written, and must
    wait for them (a hot id matches in every call)."""
    rng = np.random.RandomState(20)
    tab, ids, _, _ = _emb_grid(rng, 64, 20, 16, 1, dtype, cuda)
    out, ref = tab, tab.clone()
    for _ in range(20):
        idx = torch.from_numpy(np.minimum(
            rng.pareto(1.2, 64).astype(np.int64), ids.numel() - 4)
            .astype(np.int32)).to(cuda)
        upd = (_ints(rng, (64, 16)) if dtype == torch.int32 else
               torch.from_numpy(rng.randn(64, 16).astype(np.float32)))
        out = emb_scatter_add_cuda(out, ids, idx, upd.to(cuda))
        ref = emb_scatter_add_plain(ref, ids, idx, upd.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_emb_scatter_add_chained_all_miss_calls(cuda, dtype):
    """Twenty scatters back to back on a small table whose batch of 256 ids
    (a stream block sorts it itself) matches no row, so no chunk needs the
    plan's sums: each call's scratch, freed on return, is handed at once to
    a fill of the same size, which must not see the plan's writes."""
    rng = np.random.RandomState(21)
    tab, ids, _, _ = _emb_grid(rng, 4, 8, 48, 1, dtype, cuda)
    n_idx, dim = 256, 48
    out = tab
    for _ in range(20):
        idx = torch.from_numpy(rng.randint(ids.numel(), ids.numel() + 50,
                                           n_idx).astype(np.int32))
        idx[::5] = IDX_PAD
        upd = (_ints(rng, (n_idx, dim)) if dtype == torch.int32 else
               torch.from_numpy(rng.randn(n_idx, dim).astype(np.float32)))
        out = emb_scatter_add_cuda(out, ids, idx.to(cuda), upd.to(cuda))
        probe = torch.full((n_idx + 3 + n_idx * dim,), 7, dtype=torch.int32,
                           device=cuda)
        torch.cuda.synchronize()
        assert bool((probe == 7).all())
    assert torch.equal(out, emb_scatter_add_plain(tab, ids, idx.to(cuda),
                                                  upd.to(cuda)))


def test_emb_gather_requires_the_index(cuda):
    tab, ids, idx, _ = _emb_case("ragged", torch.int32, cuda)
    with pytest.raises(ValueError, match="gather index"):
        emb_gather_cuda(tab, ids, idx)
    index = gather_index(ids)
    with pytest.raises(ValueError, match="gather index"):
        emb_gather_cuda(tab, ids, idx, (index.ids[:, :-1].contiguous(),
                                        index.rows[:, :-1].contiguous()))


def test_emb_kernels_empty_batch(cuda):
    tab, ids, _, _ = _emb_case("ragged", torch.int32, cuda)
    none = torch.zeros(0, dtype=torch.int32, device=cuda)
    dispatch.reset_launch_counts()
    assert emb_gather_cuda(tab, ids, none, gather_index(ids)).shape == (
        7, 0, 3)
    out = emb_scatter_add_cuda(tab, ids, none,
                               torch.zeros((0, 3), dtype=torch.int32,
                                           device=cuda))
    assert torch.equal(out, tab) and out.data_ptr() != tab.data_ptr()
    assert dispatch.launch_counts == {}


def test_emb_fit_on_the_card_equals_the_cpu_fit(cuda):
    X, y = make_recsys(20_000, 1250, 833, dim=16, seed=0)
    fits = {}
    dispatch.reset_launch_counts()
    for device in ("cuda", "cpu"):
        system = make_system("pim", n_cores=64, device=device)
        ds = system.put(X, y)
        est = {d: make_estimator("emb", version="int32", n_iters=40,
                                 dim=16, lr=1.0, frac_bits=12,
                                 flush_every=d, record_every=10,
                                 system=system).fit(ds).result_.model
               for d in (1, 8)}
        fits[device] = (est, system.stats)
    (g, gs), (c, cs) = fits["cuda"], fits["cpu"]
    for d in (1, 8):
        np.testing.assert_array_equal(g[d].user_raw, c[d].user_raw)
        np.testing.assert_array_equal(g[d].item_raw, c[d].item_raw)
        assert g[d].history == c[d].history
    assert gs == cs
    assert dispatch.launch_counts == {"emb_gather": 160,
                                      "emb_scatter_add": 80 + 10}


# -- the LM serving path: int_matmul and flash_attention -------------------

#: the kernel and its plain version both compute attention in float32, in
#: other orders (and expf against ATen's exp): float32 outputs agree to
#: ~1e-6 of their O(1) size; in bf16 the tensor-core kernel rounds the
#: softmax weights to bf16 (2**-9 relative) before P @ V, and the output
#: may round to the neighbouring bf16 value (one ulp is 2**-6 below 4)
MHA_F32_ATOL, MHA_BF16_ATOL = 1e-5, 2e-2


def _int8(gen, shape, dev):
    return torch.randint(-128, 128, shape, generator=gen, device=dev,
                         dtype=torch.int32).to(torch.int8)


@pytest.mark.parametrize("m,k,n", [
    (1, 4096, 12288), (7, 12288, 4096), (513, 4096, 12288),   # qwen3-8b MLP
    (64, 4099, 70), (5, 64, 13), (17, 3, 1), (1, 1, 1), (130, 257, 66)])
def test_int_matmul_kernel_equals_plain(cuda, m, k, n):
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    a, b = _int8(gen, (m, k), cuda), _int8(gen, (k, n), cuda)
    a[0], b[:, 0] = -128, -128            # the extreme product, K times
    out = int_matmul_cuda(a, b)
    torch.cuda.synchronize()
    assert out.dtype == torch.int32
    assert torch.equal(out, int_matmul_plain(a, b))


@pytest.mark.parametrize("m", [16, 17, 320, 963])
@pytest.mark.parametrize("k,n", [(4096, 12288), (12288, 4096)])
def test_int_matmul_exact_at_the_path_boundary_and_prompt_lengths(
        cuda, m, k, n):
    """M = 16 is the streaming kernel's last row count, 17 the tensor
    cores' first; 320 and 963 are the serve load's shortest and longest
    prompts, at both qwen3-8b MLP shapes."""
    assert int_matmul_plan(m, n, k).path == ("stream" if m <= 16 else "tc")
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    a, b = _int8(gen, (m, k), cuda), _int8(gen, (k, n), cuda)
    a[0], b[:, 0] = -128, -128
    out = int_matmul_cuda(a, b)
    torch.cuda.synchronize()
    assert torch.equal(out, int_matmul_plain(a, b))


@pytest.mark.parametrize("m,k,n", [
    (17, 4099, 12288), (963, 61, 4096), (320, 4096, 1000), (16, 4099, 1000),
    (1, 61, 70), (300, 4099, 70), (129, 12288, 136)])
def test_int_matmul_ragged_k_and_n(cuda, m, k, n):
    """K off the 128-byte (tensor cores) and 64 (stream) steps and off 16
    (the TMA rows' rule: a zero-padded copy), N off the 128-column tile;
    (129, 12288, 136) also splits K over the CTAs."""
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    a, b = _int8(gen, (m, k), cuda), _int8(gen, (k, n), cuda)
    out = int_matmul_cuda(a, b)
    torch.cuda.synchronize()
    assert torch.equal(out, int_matmul_plain(a, b))


def test_int_matmul_unaligned_operands_stream_bytes(cuda):
    """M <= 16 with b 1 byte past an alignment: the streaming kernel's
    byte loads."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    flat = _int8(gen, (1 + 7 * 64 + 64 * 48,), cuda)
    a = flat[1:1 + 7 * 64].view(7, 64)
    b = flat[1 + 7 * 64:].view(64, 48)
    assert b.data_ptr() % 16 and int_matmul_plan(7, 48, 64).path == "stream"
    out = int_matmul_cuda(a, b)
    torch.cuda.synchronize()
    assert torch.equal(out, int_matmul_plain(a, b))


def test_int_matmul_unaligned_operands_take_the_byte_path(cuda):
    """M > 16 with a and b 1 byte past an alignment: the tensor-core path
    reads 16-byte aligned copies (tma_operands)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    flat = _int8(gen, (1 + 40 * 64 + 64 * 36,), cuda)
    a = flat[1:1 + 40 * 64].view(40, 64)           # 1 byte past alignment
    b = flat[1 + 40 * 64:].view(64, 36)
    assert a.data_ptr() % 4 and a.is_contiguous()
    out = int_matmul_cuda(a, b)
    torch.cuda.synchronize()
    assert torch.equal(out, int_matmul_plain(a, b))


def test_int_matmul_counts_and_refuses(cuda):
    dispatch.reset_launch_counts()
    a = torch.ones((2, 3), dtype=torch.int8, device=cuda)
    assert int_matmul_cuda(a, a.T.contiguous()).sum() == 12
    assert int_matmul_cuda(a[:0], a.T.contiguous()).shape == (0, 2)
    assert dispatch.launch_counts == {"int_matmul": 1}
    with pytest.raises(TypeError):
        int_matmul_cuda(a.int(), a.T.contiguous())
    with pytest.raises(ValueError):
        int_matmul_cuda(a, a.T)                     # not contiguous
    x = torch.randn((3, 5, 64), device=cuda)
    w = _int8(torch.Generator(device=cuda).manual_seed(0), (64, 32), cuda)
    s = torch.rand((1, 32), device=cuda)
    assert torch.equal(quant_dense(x, w, s),
                       quant_dense(x.cpu(), w.cpu(), s.cpu()).to(cuda))


@pytest.mark.parametrize("case", [
    dict(b=1, hq=32, hkv=16, sq=128, skv=128, d=128, dtype=torch.bfloat16),
    dict(b=1, hq=32, hkv=16, sq=1000, skv=1000, d=128,
         dtype=torch.bfloat16),
    dict(b=2, hq=8, hkv=2, sq=77, skv=77, d=64, causal=False),
    dict(b=2, hq=4, hkv=4, sq=1, skv=300, d=128, q_offset=299),  # decode
    dict(b=1, hq=4, hkv=2, sq=200, skv=200, d=32, window=37),
    dict(b=1, hq=4, hkv=4, sq=5, skv=260, d=80, q_offset=255, window=64),
    dict(b=1, hq=2, hkv=1, sq=130, skv=130, d=128, causal=False, window=50),
])
def test_flash_attention_kernel_matches_plain(cuda, case):
    case = dict(case)
    b, hq, hkv, sq, skv, d = (case.pop(n) for n in ("b", "hq", "hkv", "sq",
                                                    "skv", "d"))
    dtype = case.pop("dtype", torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(sq + skv + d)
    # [B, S, H, D] projections seen as [B, H, S, D], as _project_qkv does
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=cuda)
               .to(dtype).transpose(1, 2)
               for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
    out = mha_cuda(q, k, v, **case)
    torch.cuda.synchronize()
    ref = mha_plain(q, k, v, **case)
    assert out.dtype == dtype and out.shape == ref.shape
    tol = MHA_BF16_ATOL if dtype == torch.bfloat16 else MHA_F32_ATOL
    assert float((out.float() - ref.float()).abs().max()) <= tol


def _qkv(gen, b, hq, hkv, sq, skv, d, dtype, dev):
    # [B, S, H, D] projections seen as [B, H, S, D], as _project_qkv does
    return [torch.randn((b, s, h, d), generator=gen, device=dev)
            .to(dtype).transpose(1, 2)
            for s, h in ((sq, hq), (skv, hkv), (skv, hkv))]


def _attention_error(q, k, v, **kw):
    out = mha_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = mha_plain(q, k, v, **kw)
    assert out.dtype == q.dtype and out.shape == ref.shape
    return float((out.float() - ref.float()).abs().max())


@pytest.mark.parametrize("sq", [963, 77])
@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("hkv", [8, 4, 2])
def test_flash_attention_bf16_tensor_cores_match_plain(cuda, sq, d, hkv):
    """The wgmma kernel at prompt lengths that are not multiples of its
    128-row tile, D padded to 64 or 128 by TMA's zero fill, and GQA
    groups 1, 2 and 4 (8 query heads), causal."""
    gen = torch.Generator(device=cuda).manual_seed(sq + d + hkv)
    q, k, v = _qkv(gen, 1, 8, hkv, sq, sq, d, torch.bfloat16, cuda)
    assert _attention_error(q, k, v) <= MHA_BF16_ATOL


@pytest.mark.parametrize("case", [
    dict(sq=963, skv=963, window=256),
    dict(sq=1, skv=963, q_offset=962),                       # decode
    dict(sq=1, skv=300, q_offset=299, window=64),
    dict(sq=77, skv=500, q_offset=423),                      # chunk
    dict(sq=200, skv=200, causal=False),
    dict(sq=130, skv=130, causal=False, window=50),
])
def test_flash_attention_bf16_windows_and_offsets(cuda, case):
    case = dict(case)
    sq, skv = case.pop("sq"), case.pop("skv")
    gen = torch.Generator(device=cuda).manual_seed(sq + skv)
    q, k, v = _qkv(gen, 2, 8, 2, sq, skv, 128, torch.bfloat16, cuda)
    assert _attention_error(q, k, v, **case) <= MHA_BF16_ATOL


def test_flash_attention_bf16_copies_views_tma_cannot_read(cuda):
    """D = 36 (rows of 72 bytes: zero-padded to 40) and a view 2 bytes past
    an alignment (copied) still match the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = _qkv(gen, 1, 4, 2, 100, 100, 36, torch.bfloat16, cuda)
    assert _attention_error(q, k, v) <= MHA_BF16_ATOL
    flat = torch.randn(1 + 4 * 100 * 64, generator=gen, device=cuda).to(
        torch.bfloat16)
    q = flat[1:].view(1, 4, 100, 64)
    assert q.data_ptr() % 16
    k, v = _qkv(gen, 1, 2, 2, 100, 100, 64, torch.bfloat16, cuda)[1:]
    assert _attention_error(q, k, v) <= MHA_BF16_ATOL


def test_flash_attention_f32_stays_on_the_cuda_cores(cuda):
    """float32 keeps the CUDA-core template and its float32 tolerance at
    the serving shape."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = _qkv(gen, 1, 32, 16, 963, 963, 128, torch.float32, cuda)
    assert _attention_error(q, k, v) <= MHA_F32_ATOL


def test_serve_on_the_card_counts_launches_and_matches_the_cpu(cuda):
    """A reduced qwen3-8b in float32: the same greedy tokens on the card
    and the CPU (quantize_dense off), and exactly 3 int_matmul launches per
    layer per forward call and one flash_attention launch per layer per
    prefill (quantize_dense on)."""
    prompts = [np.random.RandomState(i).randint(0, 512, n).astype(np.int32)
               for i, n in enumerate((40, 9, 17))]
    news = (5, 3, 4)
    out = {}
    for quantize in (False, True):
        cfg = get_config("qwen3-8b").reduced(quantize_dense=quantize)
        weights = Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        for device in ("cuda", "cpu"):
            model = Model(cfg, device=device)
            params = copy.deepcopy(weights).to(device)
            reqs = [Request(prompt=p, max_new_tokens=n)
                    for p, n in zip(prompts, news)]
            dispatch.reset_launch_counts()
            ServeEngine(model, params, n_slots=2, max_seq=64).run(reqs)
            torch.cuda.synchronize()
            out[quantize, device] = ([r.output for r in reqs],
                                     dict(dispatch.launch_counts))
    assert out[False, "cuda"][0] == out[False, "cpu"][0]
    calls = len(prompts) + sum(n - 1 for n in news)     # prefills + decodes
    layers = get_config("qwen3-8b").reduced().n_layers
    assert out[False, "cuda"][1] == {"mha": layers * len(prompts)}
    assert out[True, "cuda"][1] == {"int_matmul": 3 * layers * calls,
                                    "mha": layers * len(prompts)}
    assert out[True, "cpu"][1] == {}


# -- step fusion: each fused chunk is one CUDA graph replay ------------------

def test_captured_chunk_equals_the_eager_steps(cuda):
    """A LOG int32_lut_wram chunk replayed from its graph gives the k
    eager steps' carry bit for bit; a second replay starts from the new
    carry, not from the captured one."""
    from repro_torch.core import logreg as tlog
    X, y = make_classification(5000, 16, seed=0)
    system = make_system("pim", n_cores=64, device="cuda")
    ds = system.put(X, y)
    cfg = tlog.LogRegConfig(version="int32_lut_wram", n_iters=10)
    base = dataclasses.replace(cfg, version="int32")
    prepare, update = tlog.make_gd_step_fns(base)
    program = system.step_program(tlog._grad_kernel(system, cfg), prepare,
                                  update, name="test.log.chunk")
    sharded = ds.gd_view(cfg.version, cfg.frac_bits, cfg.x8_frac)
    carry = (torch.zeros(16, device=cuda), torch.zeros((), device=cuda),
             torch.tensor(np.float32(5.0 / 5000), device=cuda))
    eager, _ = program.steps(carry, sharded, None, 5)
    eager2, _ = program.steps(eager, sharded, None, 5)
    replayed, _ = program.run(carry, sharded, 5, donate=False)
    replayed2, _ = program.run(replayed, sharded, 5, donate=False)
    torch.cuda.synchronize()
    for got, want in ((replayed, eager), (replayed2, eager2)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_replays_count_the_captured_launches(cuda):
    """Fused fits count the serial fits' launches, through replays: 10
    fx_matvec and 10 lut_sigmoid for 10 LOG iterations, one replay per
    chunk; the warm-up and the capture count nothing."""
    X, y = make_classification(5000, 16, seed=1)
    system = make_system("pim", n_cores=64, device="cuda")
    ds = system.put(X, y)
    fits = {}
    for fuse, depth in ((1, 2), (5, 1), (5, 2), (10, 2)):
        dispatch.reset_launch_counts()
        est = make_estimator("logreg", version="int32_lut_wram", n_iters=10,
                             fuse_steps=fuse, pipeline_depth=depth,
                             system=system).fit(ds)
        torch.cuda.synchronize()
        assert dispatch.launch_counts == {"fx_matvec": 10, "lut_sigmoid": 10}
        assert sum(dispatch.graph_replays.values()) == (
            0 if fuse == 1 else 10 // fuse)
        fits[fuse, depth] = (est.coef_, est.intercept_)
    for w, b in fits.values():
        np.testing.assert_array_equal(w, fits[1, 2][0])
        assert b == fits[1, 2][1]


@pytest.mark.parametrize("workload,version", [
    ("linreg", v) for v in ("fp32", "int32", "hyb", "bui")] + [
    ("logreg", v) for v in ("fp32", "int32", "int32_lut_mram",
                            "int32_lut_wram", "hyb_lut", "bui_lut")] + [
    ("kmeans", "fp32"), ("emb", "fp32")])
def test_every_version_fuses_on_the_card(cuda, workload, version):
    """Every version's step captures into a graph: fused on the card
    equals serial on the card, bit for bit for the integer versions,
    fp32 within the float32 reorderings of the serial comparisons (KME's
    fused update is float32 where the serial one is float64)."""
    if workload == "emb":
        X, y = make_recsys(20_000, 1250, 833, dim=16, seed=0)
        params = dict(n_iters=24, dim=16, flush_every=8, record_every=8)
    elif workload == "kmeans":
        X, y = make_blobs(6000, 16, centers=16, seed=3)[0], None
        params = dict(n_clusters=16, max_iter=12, tol=0.0)
    else:
        X, y = (make_linear_dataset(4000, 16, seed=2)[:2]
                if workload == "linreg" else
                make_classification(4000, 16, seed=2))
        params = dict(n_iters=12)
    system = make_system("pim", n_cores=64, device="cuda")
    ds = system.put(X, y)
    fits = [make_estimator(workload, version=version, fuse_steps=fuse,
                           system=system, **params).fit(ds)
            for fuse in (1, 4)]
    torch.cuda.synchronize()
    if workload == "emb":
        a, b = (f.result_.model.user_raw for f in fits)
    elif workload == "kmeans":
        a, b = (f.cluster_centers_ for f in fits)
    else:
        a, b = (np.append(f.coef_, f.intercept_) for f in fits)
    if version == "fp32":
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-3)
    else:
        np.testing.assert_array_equal(b, a)


def test_fused_fits_on_the_card_equal_the_cpu(cuda):
    """LIN int32 minibatch SGD, KME int16 and EMB int32 deferred windows,
    fused on the card and on the CPU: identical results and stats; every
    fit drops its chunk graphs when it ends."""
    X, y, _ = make_linear_dataset(4000, 16, seed=2)
    Xb, _, _ = make_blobs(6000, 16, centers=16, seed=3)
    Xr, yr = make_recsys(20_000, 1250, 833, dim=16, seed=0)
    out = {}
    for device in ("cuda", "cpu"):
        system = make_system("pim", n_cores=64, device=device)
        lin = make_estimator("linreg", version="int32", n_iters=12,
                             minibatch=16, fuse_steps=5,
                             system=system).fit(system.put(X, y))
        kme = make_estimator("kmeans", n_clusters=16, max_iter=12, tol=1e-4,
                             fuse_steps=4, system=system).fit(
                                 system.put(Xb))
        emb = make_estimator("emb", version="int32", n_iters=40, dim=16,
                             lr=1.0, frac_bits=12, flush_every=8,
                             fuse_steps=8, record_every=10,
                             system=system).fit(system.put(Xr, yr))
        out[device] = (lin.coef_, lin.intercept_, kme.cluster_centers_,
                       kme.n_iter_, emb.result_.model, system.stats)
        assert system._step_cache == {}
    g, c = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(g[0], c[0])
    assert g[1] == c[1]
    np.testing.assert_array_equal(g[2], c[2])
    assert g[3] == c[3]
    np.testing.assert_array_equal(g[4].user_raw, c[4].user_raw)
    np.testing.assert_array_equal(g[4].item_raw, c[4].item_raw)
    assert g[4].history == c[4].history
    assert g[5] == c[5]


def test_a_refit_on_the_card_equals_the_cpu(cuda):
    """The same fused minibatch LIN fit twice on one card system, then
    under another seed: each equals its CPU fit, so no fit replays a
    graph that reads what an earlier fit freed."""
    X, y, _ = make_linear_dataset(4000, 16, seed=2)
    systems = {d: make_system("pim", n_cores=64, device=d)
               for d in ("cuda", "cpu")}
    sets = {d: s.put(X, y) for d, s in systems.items()}
    for seed in (0, 0, 1):
        fits = {}
        for device, system in systems.items():
            est = make_estimator("linreg", version="int32", n_iters=12,
                                 minibatch=16, fuse_steps=5, seed=seed,
                                 system=system).fit(sets[device])
            assert system._step_cache == {}
            fits[device] = np.append(est.coef_, est.intercept_)
        np.testing.assert_array_equal(fits["cuda"], fits["cpu"])


def test_a_failed_capture_raises(cuda):
    """A step that reads a device value cannot be captured: the chunk
    raises, and the launch counts stay as they were."""
    system = make_system("pim", n_cores=8, device="cuda")

    def update(carry, red):
        if float(red["s"]) < 0:          # a host read inside the chunk
            return carry, None
        return carry + red["s"], None

    program = system.step_program(lambda x: {"s": x.sum(-1)},
                                  lambda carry: (), update, name="host.read")
    x = torch.ones((8, 3), device=cuda)
    dispatch.reset_launch_counts()
    dispatch.count_launch("fx_matvec")
    with pytest.raises(RuntimeError):
        program.run(torch.zeros((), device=cuda), (x,), 3)
    assert dispatch.launch_counts == {"fx_matvec": 1}
    assert dispatch.graph_replays == {}


def test_a_failed_capture_leaves_the_callers_stream_current(cuda):
    """A capture that fails hands the thread back its own stream, not
    the capture's (torch's graph context skips that restore when the
    capture's end raises), and the thread's later work runs."""
    system = make_system("pim", n_cores=8, device="cuda")

    def update(carry, red):
        if float(red["s"]) < 0:          # a host read inside the chunk
            return carry, None
        return carry + red["s"], None

    program = system.step_program(lambda x: {"s": x.sum(-1)},
                                  lambda carry: (), update,
                                  name="host.read.stream")
    before = torch.cuda.current_stream()
    with pytest.raises(RuntimeError):
        program.run(torch.zeros((), device=cuda),
                    (torch.ones((8, 3), device=cuda),), 3)
    assert torch.cuda.current_stream() == before
    x = torch.from_numpy(np.arange(4, dtype=np.float32)).to(cuda)
    assert float((x * 2).sum()) == 12.0


# ---------------------------------------------------------------------------
# Declared kernel costs and the gpu-model target on the card.
# ---------------------------------------------------------------------------

def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports nothing of the port at
    import time)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_declared_costs_are_chip_smokes_bounds(cuda):
    """The cost each of the six PIM-ML ops declares is what chip_smoke.py
    bounds the kernel with (PERF.md section 6's counts), at main-path
    shapes on the card."""
    cs = _chip_smoke()
    rng = np.random.RandomState(3)
    c, r, f, k, leaves, b, d = 64, 3072, 16, 16, 1024, 64, 16
    n = c * r
    lut = build_sigmoid_lut(device=cuda)
    x16 = _ints(rng, (c, r, f), -32768, 32768).to(torch.int16).to(cuda)
    c16 = _ints(rng, (k, f), -32768, 32768).to(torch.int16).to(cuda)
    ids = torch.arange(c * 40, dtype=torch.int32).reshape(c, 40).to(cuda)
    idx = torch.from_numpy(rng.randint(0, c * 40, b).astype(np.int32)) \
        .to(cuda)

    def floats(*shape):     # from numpy: the card's generator is not used
        return torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(cuda)
    cases = {
        "fx_matvec": ((_ints(rng, (c, r, f)).to(cuda),
                       _ints(rng, (f,)).to(cuda), 10),
                      cs.bound(n * f * 4 + f * 4 + n * 4, n * f * 4)),
        "lut_sigmoid": ((_ints(rng, (c, r), -30000, 30000).to(cuda), lut),
                        cs.bound(n * 8 + lut.table.numel() * 2, n * 5)),
        "kmeans_assign": ((x16, c16), cs.bound(
            n * f * 2 + k * f * 2 + n * 4 + c * k * (f + 1) * 4,
            4 * 2 * n * k * f, cs.PEAK_INT8_OPS_PER_S)),
        "gini_split": ((floats(c, r, f), _ints(rng, (c, r), 0, 2).to(cuda),
                        _ints(rng, (c, r), 0, leaves).to(cuda),
                        floats(leaves, f), 2),
                       cs.bound(n * (f + 2) * 4 + leaves * f * 4
                                + c * leaves * 2 * (f + 1) * 4, n * f,
                                cs.PEAK_FP32_OPS_PER_S)),
        "emb_gather": ((floats(c, 40, d), ids, idx,
                        gather_index(ids)),
                       cs.bound(c * b * d * 4 + b * d * 4 + b * 4, 0)),
        "emb_scatter_add": ((_ints(rng, (c, 40, d), -99, 99).to(cuda), ids,
                             idx, _ints(rng, (b, d), -99, 99).to(cuda)),
                            cs.bound(2 * c * 40 * d * 4 + c * 40 * 4 + b * 4
                                     + b * d * 4, c * 40 * b)),
    }
    from repro_torch.systems.gpu_model import OpCounter
    for op, (args, expected) in cases.items():
        assert cs.declared_bound(op, *args) == expected, op
        # charged that, and not what the kernel's wrapper runs
        cost = dispatch.declared_cost(op, *args)
        with OpCounter() as counter:
            dispatch.launch(op, *args)
        torch.cuda.synchronize()
        assert (counter.flops, counter.bytes) == (cost.ops, cost.bytes), op


@pytest.mark.parametrize("workload,version,params", [
    ("linreg", "fp32", {"n_iters": 12}),
    ("linreg", "fp32", {"n_iters": 12, "fuse_steps": 4}),
    ("logreg", "fp32", {"n_iters": 12, "fuse_steps": 6}),
    ("kmeans", "fp32", {"n_clusters": 4, "max_iter": 8}),
    ("dtree", "fp32", {"max_depth": 4}),
    ("emb", "fp32", {"n_iters": 20, "batch": 32, "dim": 4}),
])
def test_gpu_model_counts_the_same_on_the_card_as_on_the_cpu(
        cuda, workload, version, params):
    """Launches, flops and bytes do not depend on the device (a fused
    chunk counted at its graph's capture on the card, in its loop on the
    CPU), and the scores equal the host target's on the same device."""
    from repro_torch.api import get_workload
    n, f = (2048, 8) if workload != "emb" else (2048, 4)
    if workload == "kmeans":
        X, y = make_blobs(n, f, centers=4, seed=0)[0], None
    elif workload == "dtree":
        X, y = make_classification(n, f, seed=0, class_sep=1.4)
    elif workload == "emb":
        X, y = make_recsys(n, n_users=128, n_items=85, dim=f, seed=0)
    else:
        X, y, _ = make_linear_dataset(n, f, seed=0)
    wl = get_workload(workload)
    spec = wl.spec(version, **params)
    out = {}
    for device in ("cuda", "cpu"):
        system = make_system("gpu-model", n_cores=4, device=device)
        host = make_system("host", n_cores=4, device=device)
        res = wl.fit(system.put(X, y), spec)
        ref = wl.fit(host.put(X, y), spec)
        assert wl.score(res, X, y) == wl.score(ref, X, y)
        out[device] = dataclasses.asdict(system.gpu)
    for key in ("launches", "flops", "hbm_bytes"):
        assert out["cuda"][key] == out["cpu"][key], key
    assert out["cuda"]["modeled_seconds"] == pytest.approx(
        out["cpu"]["modeled_seconds"], rel=1e-12)


# ---------------------------------------------------------------------------
# fx_matvec with lanes, the fused gang and slices on the card.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 8, 13, 17])
@pytest.mark.parametrize("f", [13, 16])
@pytest.mark.parametrize("rows", [(2048, 33), (1_000_003,)])
def test_fx_matvec_lanes_kernel_equals_plain(cuda, k, f, rows):
    """Full-range int32 operands (the products and sums wrap); F = 13
    takes the scalar path, F = 16 the 16-byte one; K = 17 runs two full
    tiles of 8 and a tile of 1, K = 13 a tile of 8 and one of 5."""
    rng = np.random.RandomState(k * 100 + f)
    x, w = _ints(rng, (*rows, f)), _ints(rng, (k, f))
    out = fx_matvec_cuda(x.to(cuda), w.to(cuda), 10)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (*rows, k)
    assert torch.equal(out.cpu(), fx_matvec_plain(x, w, 10))


def test_fx_matvec_lanes_unaligned_rows(cuda):
    rng = np.random.RandomState(2)
    flat, w = _ints(rng, 999 * 16 + 1), _ints(rng, (8, 16))
    xs = flat.to(cuda)[1:].reshape(999, 16)
    assert xs.data_ptr() % 16
    out = fx_matvec_cuda(xs, w.to(cuda), 7)
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), fx_matvec_plain(flat[1:].reshape(999, 16),
                                                  w, 7))


def test_fx_matvec_lanes_counts_one_launch_and_refuses_wide_w(cuda):
    x = torch.zeros((64, 16), dtype=torch.int32, device=cuda)
    dispatch.reset_launch_counts()
    fx_matvec_cuda(x, torch.zeros((8, 16), dtype=torch.int32,
                                  device=cuda), 10)
    assert dispatch.launch_counts == {"fx_matvec": 1}
    with pytest.raises(ValueError, match="out of range"):
        fx_matvec_cuda(x, torch.zeros((769, 16), dtype=torch.int32,
                                      device=cuda), 10)
    with pytest.raises(ValueError, match="do not form"):
        fx_matvec_cuda(x, torch.zeros((2, 15), dtype=torch.int32,
                                      device=cuda), 10)


def _card_gang(system, workload, version, X, y, lrs, cancel_after=None,
               **params):
    from repro_torch.api import get_workload
    from repro_torch.sched import FusedGdSweep
    wl = get_workload(workload)
    gang = FusedGdSweep(wl, [wl.spec(version, lr=lr, n_iters=10, **params)
                             for lr in lrs], system.put(X, y))
    while not gang.done:
        gang.step()
        if cancel_after is not None and gang.it == cancel_after:
            gang.deactivate(1)
    torch.cuda.synchronize()
    return gang


@pytest.mark.parametrize("workload,version", [("linreg", "int32"),
                                              ("logreg", "int32_lut_wram")])
@pytest.mark.parametrize("fuse", [1, 5])
def test_gang_lanes_equal_serial_card_fits(cuda, workload, version, fuse):
    """A 4-lane gang on the card: one fx_matvec launch a step for all
    lanes, each lane bit-identical to a serial card fit; lane 1 cancelled
    after iteration 5 (between two chunk replays when fused) freezes."""
    X, y, _ = make_linear_dataset(5000, 16, seed=2)
    if workload == "logreg":
        y = (y > np.median(y)).astype(np.float32)
    lrs = (0.02, 0.05, 0.1, 0.2) if workload == "linreg" else (1, 2, 4, 8)
    system = make_system("pim", n_cores=64, device="cuda")
    dispatch.reset_launch_counts()
    gang = _card_gang(system, workload, version, X, y, lrs,
                      cancel_after=5, fuse_steps=fuse)
    assert dispatch.launch_counts["fx_matvec"] == 10
    assert sum(dispatch.graph_replays.values()) == (0 if fuse == 1 else 2)
    assert gang.result(1) is None
    frozen = make_estimator(workload, version=version, lr=lrs[1], n_iters=5,
                            system=system).fit(system.put(X, y))
    np.testing.assert_array_equal(gang.lane_state(1)["arrays"]["w"],
                                  frozen.coef_)
    for lane in (0, 2, 3):
        est = make_estimator(workload, version=version, lr=lrs[lane],
                             n_iters=10, system=system).fit(system.put(X, y))
        np.testing.assert_array_equal(gang.result(lane).model.w, est.coef_)
        assert gang.result(lane).model.b == est.intercept_


def test_two_slices_fused_fits_do_not_share_a_graph(cuda):
    """Two slices of one machine, two datasets, fused fits of the same
    program on both: each equals its standalone fit, each slice captured
    its own graphs (a graph reads the shards at its capture's addresses),
    and one slice's fit releasing its graphs leaves the other's."""
    from repro_torch.sched import BankAllocator
    X1, y1, _ = make_linear_dataset(4096, 16, seed=3)
    X2, y2, _ = make_linear_dataset(4096, 16, seed=4)
    parent = make_system("pim", n_cores=128, device="cuda")
    alloc = BankAllocator(128, rank_size=64)
    a, b = (parent.slice(alloc.allocate(64)) for _ in range(2))
    assert a._step_cache is not b._step_cache
    ds_a, ds_b = a.put(X1, y1), b.put(X2, y2)
    spec = dict(version="int32", n_iters=10, fuse_steps=5)
    from repro_torch.api import get_workload
    wl = get_workload("linreg")
    ga = wl.fit_steps(ds_a, wl.spec(**spec))
    gb = wl.fit_steps(ds_b, wl.spec(**spec))
    next(ga)
    next(gb)                       # both mid-fit, each with a graph
    graphs = [k for k in a._step_cache if k[3] == "graph"] + \
        [k for k in b._step_cache if k[3] == "graph"]
    assert len(graphs) == 2
    fits = {}
    for name, gen in (("a", ga), ("b", gb)):
        while True:
            try:
                next(gen)
            except StopIteration as stop:
                fits[name] = stop.value
                break
    torch.cuda.synchronize()
    for name, (X, y) in (("a", (X1, y1)), ("b", (X2, y2))):
        alone = make_system("pim", n_cores=64, device="cuda")
        ref = make_estimator("linreg", system=alone, **spec).fit(
            alone.put(X, y))
        np.testing.assert_array_equal(fits[name].attributes["coef_"],
                                      ref.coef_)


# ---------------------------------------------------------------------------
# The training service on the card.
# ---------------------------------------------------------------------------

SERVICE_CORES, SERVICE_RANK, SERVICE_ITERS, SERVICE_DEPTH = 64, 16, 10, 6


def _service_data():
    X, y, _ = make_linear_dataset(20_000, 16, seed=5)
    Xc, yc = make_classification(20_000, 16, seed=5)
    Xk, _, _ = make_blobs(30_000, 16, centers=16, seed=5)
    return {"lin": (X, y), "log": (Xc, yc), "kme": Xk}


def _service_scheduler(device):
    from repro_torch.sched import PimScheduler
    return PimScheduler(make_system("pim", n_cores=SERVICE_CORES,
                                    device=device),
                        rank_size=SERVICE_RANK, policy="deadline",
                        preemptive=True)


def test_scheduler_on_the_card_equals_the_cpu(cuda):
    """chip_smoke.py's phase-9 queue (four jobs, a fused 8-lane gang, a
    priority job at fuse_steps 5 that evicts one) on the card and on the
    CPU: the same turns, states and leases, integer results, per-job
    and parent TransferStats and modeled seconds; on the card exactly
    the launches the iterations imply, a synchronize at every turn's
    end, and no device memory left behind by finished jobs."""
    import gc

    from repro_torch.sched import JobState
    smoke = _chip_smoke()
    data = _service_data()
    sizes = smoke.service_sizes(SERVICE_CORES)
    runs = {}
    for device in ("cpu", "cuda"):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        sched = _service_scheduler(device)
        dispatch.reset_launch_counts()
        run = smoke.service_drain(sched, data, sizes, SERVICE_ITERS,
                                  SERVICE_DEPTH)
        torch.cuda.synchronize()
        counts = dict(dispatch.launch_counts)
        replays = sum(dispatch.graph_replays.values())
        gc.collect()
        grown = torch.cuda.memory_allocated() - base
        assert grown <= smoke.SERVICE_MEMORY_SLACK, grown
        assert all(r.slice is None for r in sched._finished)
        runs[device] = (sched, run, counts, replays)
    (cs, crun, ccounts, _), (gs, grun, gcounts, greplays) = (
        runs["cpu"], runs["cuda"])
    assert grun["log"] == crun["log"]
    for name, h in grun["handles"].items():
        c = crun["handles"][name]
        assert h.state is JobState.DONE and h.error is None, name
        assert dataclasses.asdict(h.transfer) == dataclasses.asdict(
            c.transfer), name
        assert h.modeled_seconds == c.modeled_seconds
        assert smoke.same_fit(h.result, c.result), name
    assert [dataclasses.asdict(t) for t in grun["segments"]] == [
        dataclasses.asdict(t) for t in crun["segments"]]
    assert len(grun["segments"]) == 1
    assert dataclasses.asdict(gs.system.stats) == dataclasses.asdict(
        cs.system.stats)
    rounds = smoke.tree_rounds(grun["handles"]["dtr"].result.model)
    assert ccounts == {}
    assert gcounts == {"fx_matvec": 4 * SERVICE_ITERS,
                       "lut_sigmoid": SERVICE_ITERS,
                       "kmeans_assign": SERVICE_ITERS,
                       "gini_split": rounds}
    assert greplays == 2
    assert gs.syncs > 0 and cs.syncs == 0
    for sched in (gs, cs):
        assert sched.metrics.counter("sched.retries").value == 0
        assert sched.fragmentation().used_cores == 0


def test_serve_captures_on_its_thread_while_the_caller_uses_the_card(cuda):
    """Serve mode: four jobs submitted while the loop runs, one at
    fuse_steps 5 whose chunk graph is captured on the serve thread while
    this thread keeps allocating and launching plain torch work on the
    card (a global-mode capture would refuse that).  No job is lost, each
    equals its standalone card fit, the counts are exact."""
    from repro_torch.api import get_workload
    from repro_torch.sched import JobState
    smoke = _chip_smoke()
    data = _service_data()
    sizes = smoke.service_sizes(SERVICE_CORES)
    specs = smoke.service_specs(data, SERVICE_ITERS, SERVICE_DEPTH)
    sched = _service_scheduler("cuda")
    dispatch.reset_launch_counts()
    sched.serve(poll_interval=0.002)
    busy = torch.zeros(1 << 20, device=cuda)
    handles = {}
    for name in ("priority", "lin", "log", "kme"):
        workload, d, version, params = specs[name]
        handles[name] = sched.submit(workload, d, version=version,
                                     n_cores=sizes[name], name=name,
                                     **params)
    t_end = time.monotonic() + 120.0
    while (not all(h.done for h in handles.values())
           and time.monotonic() < t_end):
        busy = busy * 0.5 + 1.0           # allocates and launches
        torch.cuda.current_stream().synchronize()
    assert sched.wait(list(handles.values()), timeout=120.0)
    sched.shutdown(wait=True, timeout=120.0)
    torch.cuda.synchronize()
    assert float(busy[0]) == pytest.approx(2.0, abs=1e-3)
    for name, h in handles.items():
        assert h.state is JobState.DONE and h.error is None, (name, h.error)
    assert sched.metrics.counter("sched.serve_errors").value == 0
    assert sched.metrics.counter("sched.retries").value == 0
    assert dispatch.launch_counts == {"fx_matvec": 3 * SERVICE_ITERS,
                                      "lut_sigmoid": SERVICE_ITERS,
                                      "kmeans_assign": SERVICE_ITERS}
    assert sum(dispatch.graph_replays.values()) == 2
    for name, h in handles.items():
        workload, (X, y), version, params = specs[name]
        system = make_system("pim", n_cores=sizes[name], device="cuda")
        wl = get_workload(workload)
        want = wl.fit(system.put(X, y), wl.spec(version, **params))
        assert smoke.same_fit(h.result, want), name
