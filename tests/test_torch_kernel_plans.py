"""Launch planning, operand staging and kernel arithmetic of the port's
CUDA kernels, on the CPU: which ``int_matmul`` kernel runs for which M,
how K is split (every k covered exactly once), the copies made when a
TMA tensor map cannot read an operand as it lies; ``kmeans_assign``'s
byte-split products and its row split; ``gini_counts``' writers of a
core partial, its window and its 16-bit passes; ``lut_sigmoid``'s scalar
head, 16-byte vectors and scalar tail, its grid and its staged table.  The staged operands and the split
products are held against the JAX package's reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kmeans_assign.ref import kmeans_assign_ref
from repro.kernels.quant_matmul.ref import int_matmul_ref
from repro_torch.kernels.gini_split import (ROWS_PER_PASS, WINDOW_BYTES,
                                            gini_plan)
from repro_torch.kernels.kmeans_assign import (CHUNK, MAX_EXACT_DEPTH,
                                               MAX_SHARED_BYTES,
                                               kmeans_assign_plan,
                                               split_cross, sq_norms,
                                               wrapped_cross)
from repro_torch.kernels.lut_activation import (BLOCKS_PER_SM,
                                                MAX_SHARED_TABLE, THREADS,
                                                UNROLL, VEC, aligned_like,
                                                lut_sigmoid_plan)
from repro_torch.kernels.flash_attention import (mha_bwd_plain, mha_plain,
                                                 tma_ready, tma_views)
from repro_torch.kernels.quant_matmul import (H100_SMS, STREAM_MAX_KSPLIT,
                                              STREAM_MAX_M, TC_BK,
                                              int_matmul_plain,
                                              int_matmul_plan, tma_operands)

#: qwen3-8b's MLP shapes (K, N) and M at decode, the path boundary and the
#: serve load's prompts; then ragged and tiny shapes
SHAPES = ([(m, k, n) for m in (1, 7, 16, 17, 320, 963)
           for k, n in ((4096, 12288), (12288, 4096))]
          + [(1, 1, 1), (5, 61, 13), (33, 4099, 1000), (129, 12288, 136),
             (16, 131072, 16), (4000, 64, 70000)])


def _int8(rng, shape):
    return torch.from_numpy(rng.randint(-128, 128, shape).astype(np.int8))


@pytest.mark.parametrize("m", [1, 2, 15, 16, 17, 64, 963])
def test_int_matmul_path_by_rows(m):
    plan = int_matmul_plan(m, 4096, 12288)
    assert plan.path == ("stream" if m <= STREAM_MAX_M else "tc")
    if plan.path == "stream":
        assert plan.mt == (1 if m == 1 else 4)


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("sms", [H100_SMS, 8])
def test_int_matmul_splits_cover_every_k_once(m, k, n, sms):
    plan = int_matmul_plan(m, n, k, sms)
    step = TC_BK if plan.path == "tc" else 64
    assert plan.k_per_split % step == 0 and plan.splits >= 1
    if plan.path == "stream":
        assert plan.k_per_split <= STREAM_MAX_KSPLIT
    covered = np.zeros(k, np.int64)
    for z in range(plan.splits):
        lo, hi = z * plan.k_per_split, min(k, (z + 1) * plan.k_per_split)
        assert lo < hi                       # no split without work
        covered[lo:hi] += 1
    assert (covered == 1).all()


def test_int_matmul_splits_only_to_fill_the_card():
    # decode streams 11 and 32 slices of K; a prefill with enough tiles
    # runs whole K per CTA; a few tiles split K to reach every SM
    assert int_matmul_plan(1, 12288, 4096).splits == 11
    assert int_matmul_plan(1, 4096, 12288).splits == 32
    assert int_matmul_plan(963, 12288, 4096).splits == 1
    assert int_matmul_plan(963, 4096, 12288).splits == 1
    plan = int_matmul_plan(129, 136, 12288)
    assert plan.path == "tc" and plan.splits * 4 >= H100_SMS // 2


@pytest.mark.parametrize("m,k,n,offset", [
    (40, 64, 36, 1), (17, 61, 13, 0), (20, 4096, 1000, 0), (18, 48, 48, 3),
    (33, 4099, 70, 0)])
def test_tma_operands_are_aligned_and_keep_the_product(m, k, n, offset):
    """Zero-padded or copied operands: 16-byte aligned, K and b's pitch
    multiples of 16, and the product over them, cut to N columns, equals
    the reference's on the originals."""
    rng = np.random.RandomState(m + k + n)
    flat = _int8(rng, offset + m * k + k * n)
    a = flat[offset:offset + m * k].view(m, k)
    b = flat[offset + m * k:].view(k, n)
    a_t, b_t = tma_operands(a, b)
    assert a_t.data_ptr() % 16 == 0 and b_t.data_ptr() % 16 == 0
    assert a_t.shape[1] % 16 == 0 and b_t.shape[1] % 16 == 0
    assert a_t.shape[1] == b_t.shape[0] and a_t.shape[0] == m
    ref = np.asarray(int_matmul_ref(jnp.asarray(a.numpy()),
                                    jnp.asarray(b.numpy())))
    np.testing.assert_array_equal(int_matmul_plain(a_t, b_t)[:, :n].numpy(),
                                  ref)


def test_tma_operands_keep_aligned_operands():
    rng = np.random.RandomState(0)
    a, b = _int8(rng, (32, 4096)), _int8(rng, (4096, 12288))
    a_t, b_t = tma_operands(a, b)
    assert a_t is a and b_t is b


def test_tma_views_read_projection_views_in_place():
    """_project_qkv's transposed [B, S, H, D] views: every stride a multiple
    of 8 elements, so the kernel reads them without a copy."""
    x = torch.randn(2, 77, 24, 128).to(torch.bfloat16)
    q = x[:, :, :16].transpose(1, 2)
    k, v = x[:, :, 16:20].transpose(1, 2), x[:, :, 20:].transpose(1, 2)
    assert all(tma_ready(t) for t in (q, k, v))
    views = tma_views(q, k, v)
    assert all(t.data_ptr() == u.data_ptr() for t, u in zip(views, (q, k, v)))


def test_tma_views_pad_d_and_copy_unaligned_views():
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, 4, 50, 36).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    assert not tma_ready(q)                   # rows of 72 bytes
    qp, kp, vp = tma_views(q, k, v)
    assert qp.shape == (1, 4, 50, 40) and all(tma_ready(t)
                                              for t in (qp, kp, vp))
    assert torch.equal(qp[..., :36], q) and not qp[..., 36:].any()
    # the zero columns leave q . k as it was
    assert torch.equal(torch.einsum("bhqd,bhkd->bhqk", qp.float(), kp.float()),
                       torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()))
    flat = torch.zeros(1 + 4 * 50 * 64, dtype=torch.bfloat16)
    u = flat[1:].view(1, 4, 50, 64)
    assert not tma_ready(u)
    w = torch.zeros(1, 4, 50, 64, dtype=torch.bfloat16)
    uc, wc, _ = tma_views(u, w, w)
    assert tma_ready(uc) and torch.equal(uc, u) and wc is w


def test_tma_views_keep_the_plain_result():
    """Attention over the staged views (D padded with zeros) equals
    attention over the originals once the scale is the original D's."""
    rng = np.random.RandomState(9)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 30, 20).astype(np.float32))
               for _ in range(3))
    qp, kp, vp = tma_views(q.to(torch.bfloat16), k.to(torch.bfloat16),
                           v.to(torch.bfloat16))
    assert qp.shape[-1] == 24
    scale = (24 / 20) ** 0.5            # mha_plain scales by the padded D
    out = mha_plain(qp.float() * scale, kp.float(), vp.float())[..., :20]
    ref = mha_plain(q.to(torch.bfloat16).float(), k.to(torch.bfloat16).float(),
                    v.to(torch.bfloat16).float())
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)


def test_tma_views_stage_the_backwards_five_operands():
    """The backward stages q, k, v, out and dout together: D = 20 pads all
    five to 24; the gradient over the padded operands, cut back to D, is
    the gradient over the originals (the scale is the original D's; the
    zero columns add nothing to delta = rowsum(dout * out))."""
    rng = np.random.RandomState(4)
    q, k, v, dout = (torch.from_numpy(rng.randn(1, 4, 30, 20)
                                      .astype(np.float32))
                     .to(torch.bfloat16).float() for _ in range(4))
    k, v = k[:, :2], v[:, :2]
    out, lse = mha_plain(q, k, v, with_lse=True)
    staged = tma_views(*(t.to(torch.bfloat16) for t in (q, k, v, out, dout)))
    assert [t.shape[-1] for t in staged] == [24] * 5
    assert all(tma_ready(t) for t in staged)
    qp, kp, vp, outp, doutp = (t.float() for t in staged)
    c = (24 / 20) ** 0.5               # mha_bwd_plain scales by the padded D
    dq, dk, dv = mha_bwd_plain(qp * c, kp, vp, outp, doutp, lse)
    want = mha_bwd_plain(q, k, v, out.to(torch.bfloat16).float(), dout, lse)
    assert not dk[..., 20:].any() and not dv[..., 20:].any()
    for got, ref in zip((dq[..., :20] * c, dk[..., :20], dv[..., :20]), want):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


# -- kmeans_assign: the byte-split products and the row split ---------------

#: (N, K, F): the main shape's K and F, then K and F off multiples of 8
SPLIT_SHAPES = [(300, 16, 16), (257, 5, 13), (100, 9, 1), (64, 33, 40),
                (40, 1, 16)]


@pytest.mark.parametrize("n,k,f", SPLIT_SHAPES)
def test_split_cross_is_the_wrapped_int32_product(n, k, f):
    """Full-range int16 (-32768 and 32767 included): the three byte-split
    accumulators composed modulo 2**32 equal the wrapping int32 x . c^T,
    the reference's int32 dot, and its labels equal the reference's."""
    rng = np.random.RandomState(n + k + f)
    x = rng.randint(-32768, 32768, (n, f)).astype(np.int16)
    c = rng.randint(-32768, 32768, (k, f)).astype(np.int16)
    x[0], x[1, :], c[0] = -32768, 32767, -32768
    cross = split_cross(torch.from_numpy(x), torch.from_numpy(c))
    assert torch.equal(cross, wrapped_cross(torch.from_numpy(x).int(),
                                            torch.from_numpy(c).int()))
    ref = jax.lax.dot_general(jnp.asarray(x, jnp.int32),
                              jnp.asarray(c, jnp.int32).T,
                              (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(cross.numpy(), np.asarray(ref))
    labels = torch.argmin(sq_norms(torch.from_numpy(c).int()) - 2 * cross,
                          dim=-1)
    np.testing.assert_array_equal(
        labels.numpy(),
        np.asarray(kmeans_assign_ref(jnp.asarray(x), jnp.asarray(c))[0]))


@pytest.mark.parametrize("n_cores,n_pc", [(2048, 12500), (64, 1563),
                                          (7, 1027), (1, 25_600_000),
                                          (5, 1), (3, 0), (1, 1_000_003)])
@pytest.mark.parametrize("k,f", [(16, 16), (5, 13), (33, 40), (1, 1)])
def test_kmeans_plan_covers_every_row_once(n_cores, n_pc, k, f):
    """The blocks of a core count every row once, in ranges of whole
    chunks; one block per core (its partial stored, not added) wherever
    the cores alone fill the card; shared memory within a block's."""
    plan = kmeans_assign_plan(n_cores, n_pc, k, f)
    assert plan.rows_per_cta % CHUNK == 0 and plan.ctas_per_core >= 1
    covered = np.zeros(n_pc, np.int64)
    for r0, r1 in plan.row_ranges(n_pc):
        assert r0 < r1 or n_pc == 0
        covered[r0:r1] += 1
    assert (covered == 1).all()
    assert plan.atomic_out == (plan.ctas_per_core > 1)
    if n_cores >= 4 * 132:
        assert not plan.atomic_out
    assert plan.fixed == (k <= 16 and f <= 16)
    assert plan.k_pad % 16 == 0 and plan.f_pad % 16 == 0
    assert plan.smem_bytes <= MAX_SHARED_BYTES


@pytest.mark.parametrize("k", [1, 16, 64, 256])
def test_kmeans_plan_depth_stays_exact(k):
    """Every F whose plan fits shared memory is far inside the depth over
    which a byte-split accumulator is exact."""
    f = 1
    while kmeans_assign_plan(2048, 12500, k, f + 1).smem_bytes \
            <= MAX_SHARED_BYTES:
        f += 1
    assert 16 <= f and kmeans_assign_plan(1, 1, k, f).f_pad \
        < MAX_EXACT_DEPTH // 8


def test_split_cross_refuses_a_depth_that_could_wrap():
    x = torch.zeros((1, MAX_EXACT_DEPTH + 1), dtype=torch.int16)
    with pytest.raises(ValueError, match="wraps"):
        split_cross(x, x)


# -- gini_counts: the writers of a core partial, 16-bit passes --------------

@pytest.mark.parametrize("n_leaves", [37, 4096, 2 ** 20])
@pytest.mark.parametrize("n_classes,f", [(2, 16), (3, 13), (2, 1)])
@pytest.mark.parametrize("n_cores,n_pc", [(2048, 37_500), (16, 4_800_000),
                                          (7, 1_000_000), (1, 65_536),
                                          (200, 1), (3, 0)])
def test_gini_plan_writes_every_leaf_once(n_leaves, n_classes, f, n_cores,
                                          n_pc):
    """Every row of a core is counted by exactly one of its blocks, and
    every leaf of the core's partial is written by one block alone (its
    stores, onto an empty partial) or added by each block into zeros.  One
    block a core wherever the cores fill the SMs; otherwise no more
    blocks than fill them once.  The window holds whole (leaf, class)
    slots in its shared memory, all L of them where they fit."""
    plan = gini_plan(n_cores, n_pc, n_leaves, n_classes, f)
    covered = np.zeros(n_pc, np.int64)
    for r0, r1 in plan.row_ranges(n_pc):
        assert r0 < r1 or n_pc == 0
        covered[r0:r1] += 1
    assert (covered == 1).all()
    assert plan.atomic_out == (plan.ctas_per_core > 1)
    if n_cores >= 132:
        assert not plan.atomic_out
    assert plan.ctas_per_core * n_cores <= max(132, n_cores)
    assert plan.window_words % plan.slot_words == 0
    assert 4 * plan.window_words <= WINDOW_BYTES
    assert plan.window_leaves == min(
        n_leaves, WINDOW_BYTES // (4 * plan.slot_words)) >= 1


def test_gini_window_holds_a_depth_10_fit():
    """Every node id of a depth-10 tree, at the fit's shapes, has a place
    in the window: rows of no round add to global memory."""
    plan = gini_plan(2048, 37_500, 4096, 2, 16)
    assert plan.window_leaves >= 2 ** 11 - 1


@pytest.mark.parametrize("n_pc", [0, 1, 37_500, 65_535, 65_536, 131_071,
                                  1_000_000])
def test_gini_passes_keep_16_bit_counters(n_pc):
    """Each block's passes cover its rows once and hold at most 65,535
    rows, so no 16-bit counter (nor two copies' sum) carries into its
    neighbour."""
    for n_cores in (2048, 4, 1):
        plan = gini_plan(n_cores, n_pc, 4096, 2, 16)
        covered = np.zeros(n_pc, np.int64)
        for r0, r1 in plan.row_ranges(n_pc):
            for p0, p1 in plan.passes(r0, r1):
                assert 0 < p1 - p0 <= ROWS_PER_PASS <= 0xFFFF
                covered[p0:p1] += 1
        assert (covered == 1).all()


# -- lut_sigmoid: the scalar head, 16-byte vectors, the scalar tail ---------

@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 257 * 129, 2048 * 3072])
@pytest.mark.parametrize("offset", [0, 4, 8, 12])
@pytest.mark.parametrize("placement", ["wram", "mram"])
def test_lut_plan_covers_every_element_once(n, offset, placement):
    """Head, vectors and tail cover the n elements once, for x (and the
    wrapper's out) at each offset past a 16-byte boundary: the vectors
    start at the first boundary.  The grid is persistent and no larger
    than n fills."""
    plan = lut_sigmoid_plan(n, offset, offset, 20 * 1024, placement)
    assert plan.head + VEC * plan.vectors + plan.tail == n
    body = plan.head + VEC * plan.vectors
    covered = np.zeros(n, np.int64)
    for i0, i1 in ((0, plan.head), (plan.head, body), (body, n)):
        covered[i0:i1] += 1
    assert (covered == 1).all()
    assert plan.head == min(n, (16 - offset) % 16 // 4)
    assert plan.vectors == 0 or (offset + 4 * plan.head) % 16 == 0
    assert plan.tail < VEC and (plan.tail == 0 or plan.head < 4)
    assert plan.block == THREADS <= 1024
    assert 1 <= plan.grid <= 132 * BLOCKS_PER_SM
    assert (plan.grid - 1) * plan.block * VEC * UNROLL < max(n, 1)


@pytest.mark.parametrize("x_offset,out_offset", [(4, 0), (0, 8), (12, 4),
                                                 (2, 2)])
def test_lut_plan_refuses_x_and_out_that_cannot_stream_together(
        x_offset, out_offset):
    with pytest.raises(ValueError, match="cannot"):
        lut_sigmoid_plan(100, x_offset, out_offset, 1001, "wram")


@pytest.mark.parametrize("placement", ["wram", "mram"])
def test_lut_plan_streams_the_main_path_as_vectors(placement):
    """The LOG step hands the kernel a fresh [2048, 3072] z (fx_matvec's
    output plus the bias, a new allocation) and the wrapper allocates the
    output: both start on a boundary, so all of it is vectors, on a grid
    of every SM."""
    n = 2048 * 3072
    plan = lut_sigmoid_plan(n, 0, 0, 20 * 1024, placement)
    assert (plan.head, plan.tail) == (0, 0)
    assert plan.vectors == n // VEC
    assert plan.grid == 132 * BLOCKS_PER_SM
    assert lut_sigmoid_plan(n, 0, 0, 20 * 1024, placement,
                            sms=114).grid == 114 * BLOCKS_PER_SM


@pytest.mark.parametrize("n_table", [1, 7, 8, 9, 1001, 20 * 1024,
                                     MAX_SHARED_TABLE])
def test_lut_plan_stages_the_whole_table(n_table):
    """WRAM's shared memory holds the whole table in whole 16-byte chunks
    within the 48 KB static limit; MRAM stages nothing."""
    wram = lut_sigmoid_plan(100, 0, 0, n_table, "wram")
    assert 2 * n_table <= wram.smem_bytes <= 48 * 1024
    assert wram.smem_bytes % 16 == 0 and wram.smem_bytes - 2 * n_table < 16
    assert lut_sigmoid_plan(100, 0, 0, n_table, "mram").smem_bytes == 0


def test_lut_plan_refuses_a_wram_table_over_shared_memory():
    with pytest.raises(ValueError, match="does not fit"):
        lut_sigmoid_plan(100, 0, 0, MAX_SHARED_TABLE + 1, "wram")
    with pytest.raises(ValueError, match="does not fit"):
        lut_sigmoid_plan(100, 0, 0, 0, "mram")
    with pytest.raises(ValueError, match="placement"):
        lut_sigmoid_plan(100, 0, 0, 1001, "vmem")
    # MRAM reads the table from global memory: any length
    assert lut_sigmoid_plan(100, 0, 0, MAX_SHARED_TABLE + 1,
                            "mram").smem_bytes == 0


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_lut_output_starts_at_the_inputs_offset(offset):
    """The wrapper's output lies as far past a 16-byte boundary as x, so
    that any int32 x streams as vectors."""
    flat = torch.zeros(64 + offset, dtype=torch.int32)
    base = (-flat.data_ptr() % 16) // 4
    x = flat[base + offset:base + offset + 60].view(6, 10)
    out = aligned_like(x)
    assert out.shape == x.shape and out.dtype == torch.int32
    assert out.is_contiguous() and out.data_ptr() % 16 == 4 * offset
    plan = lut_sigmoid_plan(60, x.data_ptr() % 16, out.data_ptr() % 16,
                            1001, "wram")
    assert plan.head == (4 - offset) % 4 and plan.vectors > 0
