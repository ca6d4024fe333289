"""EMB trainer: deferred-update embedding regression.

Port of ``repro.emb.trainer``.  Model: rating(u, i) = <U[u], I[i]>, two
row-sharded embedding tables (:class:`~repro_torch.api.table.ShardedTable`)
trained by minibatch SGD over (user, item, rating) triples, in two
precisions:

  fp32   float32 tables and arithmetic (the processor-centric baseline)
  int32  Q(frac_bits) fixed-point tables and arithmetic (the PIM
         version): every sum is exact in int32, so eager, deferred D=1
         and resumed fits are bit-identical to the reference's

One step:

  1. the minibatch's (user, item) ids and targets are broadcast;
  2. every core answers a shard-local ``emb_gather`` against its
     placement map (zeros for rows it does not own), in ONE map_reduce
     whose reduce rebuilds the looked-up rows; a ``lead`` lane (1 on
     shard 0) relays the targets through the reduce exactly once;
  3. the update (prediction, error, per-row deltas) runs on the reduced
     rows, on the system's device;
  4. the delta rows apply at once (eager, ``flush_every=1``) through
     ``emb_scatter_add``, or accumulate in each table's host ledger and
     flush every D steps as one deduplicated batched scatter-add
     (deferred, LazyDP).

Within a deferred window the gathers read the table as of the last
flush.  A window of D=1 staged through the ledger ships the same rows
through the same scatter as eager, bit for bit.

``TransferStats.flush_bytes`` counts the sparse update payload (ids +
delta rows) each apply ships, also charged as cross-rank traffic on PIM
targets; ``compressed_bytes`` the int8 payload of a compressed flush.

Deferred windows fuse (``fuse_steps > 1``): each chunk's k batches are
drawn up front and its gathers and updates run as one
:class:`~repro_torch.systems.base.StepProgram` chunk (one CUDA graph
replay on a card) whose emits are the delta rows and the errors;
staging, recording (the loss of a chunk's last step) and the window's
flush stay on the host, so chunks are clipped to flush boundaries and
record points.  Eager mode (a table write every step)
always runs the serial loop.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from ..core.fixed_point import _shift_round, from_fixed, to_fixed
from ..elastic.state import pack_rng, unpack_rng
from ..kernels import dispatch
from ..kernels.sparse_gather import IDX_PAD, GatherIndex
from ..systems import ChunkTick, host_array, run_steps
from ..systems.base import _tree_bytes
from ..systems.compress import quantize_rows

VERSIONS = ("fp32", "int32")


@dataclasses.dataclass
class EmbConfig:
    version: str = "fp32"
    n_iters: int = 200       # minibatch SGD steps
    batch: int = 64
    dim: int = 8             # embedding width
    lr: float = 0.05
    frac_bits: int = 10      # Q format of the int32 tables/arithmetic
    #: D, the deferred-update window in batches.  1 = eager (apply every
    #: step); D > 1 stages D batches in the table ledger and flushes
    #: once, deduplicated, per window.
    flush_every: int = 1
    #: force the staging-ledger path even at flush_every=1 (None = auto:
    #: deferred iff flush_every > 1)
    deferred: Optional[bool] = None
    #: int8 + error-feedback compression of the flush payload
    #: (systems.compress.quantize_rows; the residual rows re-stage into
    #: the next window, exactly on the int32 version)
    compress_flush: bool = False
    placement: str = "mod"   # ShardedTable placement map ("mod"|"hash")
    n_users: Optional[int] = None   # None = infer from the index pairs
    n_items: Optional[int] = None
    record_every: int = 0    # record batch MSE every this many steps
    seed: int = 0
    #: step fusion within a deferred window: chunks of this many steps,
    #: clipped to flush boundaries; eager mode ignores it
    fuse_steps: int = 1
    #: accepted for interface parity with the other trainers: a deferred
    #: window serializes on its flush, so chunks run one at a time
    pipeline_depth: int = 2


@dataclasses.dataclass
class EmbResult:
    user_emb: np.ndarray     # (n_users, dim) float32
    item_emb: np.ndarray     # (n_items, dim) float32
    user_raw: np.ndarray     # storage dtype (int32 Q(f) | float32)
    item_raw: np.ndarray
    history: list            # [(iter, batch MSE)] if record_every
    n_iters: int = 0
    n_flushes: int = 0

    def predict(self, pairs: np.ndarray) -> np.ndarray:
        p = np.asarray(pairs, np.int64)
        return np.sum(self.user_emb[p[:, 0]] * self.item_emb[p[:, 1]],
                      axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Per-core kernels, batched over the leading cores axis.
# ---------------------------------------------------------------------------

def build_emb_fwd(uindex: GatherIndex, iindex: GatherIndex) -> Callable:
    """Forward leg: both tables' shard-local gathers ([C, B, D] partials),
    through the tables' gather indexes, and the target relay: ``lead``
    [C, 1] is 1 on shard 0 only, so the replicated targets ride the reduce
    exactly once ([C, B])."""
    def _fwd(Utab, Uids, Itab, Iids, lead, iu, ii, yb):
        return {"u": dispatch.launch("emb_gather", Utab, Uids, iu, uindex),
                "i": dispatch.launch("emb_gather", Itab, Iids, ii, iindex),
                "y": lead * yb}
    return _fwd


def build_emb_apply() -> Callable:
    """Update leg: duplicate-safe scatter-add of sparse delta rows into
    both tables, into new tables that stay resident (map_elementwise)."""
    def _apply(Utab, Uids, Itab, Iids, iu, du, ii, di):
        return {"u": dispatch.launch("emb_scatter_add", Utab, Uids, iu, du),
                "i": dispatch.launch("emb_scatter_add", Itab, Iids, ii, di)}
    return _apply


def make_emb_update(cfg: EmbConfig, device: torch.device) -> Callable:
    """The update of one step (the reference's ``make_emb_step_fns``
    update): reduced {"u", "i", "y"} rows -> the signed per-sample delta
    rows (lr folded in, rounding applied) and the per-sample error.

    Host-strategy reduces arrive as numpy int64 / float64; they are cast
    to the table's type (int32 wraps, as ``jnp.asarray`` demotes) and
    moved to ``device``."""
    f = cfg.frac_bits
    dtype = torch.int32 if cfg.version == "int32" else torch.float32
    np_dtype = np.int32 if cfg.version == "int32" else np.float32

    def _rows(v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.to(dtype)
        return torch.from_numpy(np.asarray(v).astype(np_dtype)).to(device)

    if cfg.version == "int32":
        lr_q = int(to_fixed(cfg.lr / cfg.batch, f))      # Q(f) scalar

        def update(red):
            u, i, y = _rows(red["u"]), _rows(red["i"]), _rows(red["y"])
            pred = torch.sum(_shift_round(u * i, f), dim=1,
                             dtype=torch.int32)          # Q(f)
            err = pred - y                               # Q(f)
            du = -_shift_round(lr_q * _shift_round(err[:, None] * i, f), f)
            di = -_shift_round(lr_q * _shift_round(err[:, None] * u, f), f)
            return du, di, err
    else:
        s = torch.tensor(np.float32(cfg.lr / cfg.batch), device=device)

        def update(red):
            u, i, y = _rows(red["u"]), _rows(red["i"]), _rows(red["y"])
            err = torch.sum(u * i, dim=1) - y
            du = -(s * err[:, None] * i)
            di = -(s * err[:, None] * u)
            return du, di, err
    return update


# ---------------------------------------------------------------------------
# The batch loss, summed as the reference's float32 reduce sums it.
# ---------------------------------------------------------------------------

def _fma_f32(a: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``a * a + acc`` of 0-d float32 tensors, rounded once to float32.
    The float64 product of two float32 values is exact; the float64 sum
    may round, and TwoSum gives its error, which decides the one case
    where rounding twice differs: a float64 sum that falls exactly on a
    float32 midpoint."""
    p = a.double() * a.double()
    c = acc.double()
    hi = p + c
    z = hi - p
    lo = (p - (hi - z)) + (c - z)
    r = hi.float()
    other = torch.nextafter(r, torch.where(hi > r.double(), math.inf,
                                           -math.inf).float())
    fix = ((lo != 0) & (r.double() != hi)
           & (hi == (r.double() + other.double()) / 2)
           & ((lo > 0) == (other > r)))
    return torch.where(fix, other, r)


def batch_sq_error(err) -> torch.Tensor:
    """float32 ``sum(err * err)`` of a 1-D float32 ``err``, as a 0-d
    tensor on its device, in the order of the reference's CPU compile of
    ``jnp.sum`` (serial steps and fused chunks alike), so the int32
    history is bit-identical: up to 32 elements, one fused multiply-add
    per element in order; above, the squares (each rounded) are summed
    in windows of 32, the padding split before and after the data, and
    the window sums added in order (windows of windows past 32 of
    them).  Elementwise tensor ops only, so a chunk graph can hold it."""
    e = torch.as_tensor(err, dtype=torch.float32)
    s = e.new_zeros(())
    if e.shape[0] <= 32:
        for j in range(e.shape[0]):
            s = _fma_f32(e[j], s)
        return s
    v = e * e
    while v.shape[0] > 32:
        pad = -v.shape[0] % 32
        v = torch.cat([v.new_zeros(pad // 2), v,
                       v.new_zeros(pad - pad // 2)]).reshape(-1, 32)
        acc = v.new_zeros(v.shape[0])
        for j in range(32):
            acc = acc + v[:, j]
        v = acc
    for j in range(v.shape[0]):
        s = s + v[j]
    return s


# ---------------------------------------------------------------------------
# Host-orchestrated training loop.
# ---------------------------------------------------------------------------

def fit_steps(dataset, cfg: Optional[EmbConfig] = None, *,
              state: Optional[dict] = None):
    """Generator form of EMB training; the EmbResult travels on
    StopIteration.  Yields one :class:`ChunkTick` per step, each with a
    lazy snapshot: the tables as size-independent (V, D) host rows plus
    the staging ledgers and the packed rng, the reference's schema, so a
    snapshot from either package resumes bit-identically here on any
    core count."""
    cfg = cfg or EmbConfig()
    if cfg.version not in VERSIONS:
        raise ValueError(f"unknown EMB version {cfg.version!r}; known: "
                         f"{VERSIONS}")
    pim = dataset.system
    dev = pim.device
    pairs, y_f = dataset.emb_view()
    n = pairs.shape[0]
    n_users = int(cfg.n_users or pairs[:, 0].max() + 1)
    n_items = int(cfg.n_items or pairs[:, 1].max() + 1)
    f = cfg.frac_bits
    int_ver = cfg.version == "int32"
    D = max(1, int(cfg.flush_every))
    deferred = D > 1 if cfg.deferred is None else bool(cfg.deferred)
    y_host = (to_fixed(torch.from_numpy(y_f), f).numpy() if int_ver
              else y_f)

    history: list = []
    rng = np.random.RandomState(cfg.seed)
    it_done = 0
    # the table init draws come FIRST on the rng stream; a resumed fit
    # restores the packed rng (already past them) and replaces the init
    # values with the snapshot's rows
    scale = np.float32(1.0 / np.sqrt(cfg.dim))
    Wu = (rng.rand(n_users, cfg.dim).astype(np.float32) - 0.5) * scale
    Wi = (rng.rand(n_items, cfg.dim).astype(np.float32) - 0.5) * scale
    utable = pim.put_table(Wu, placement=cfg.placement, seed=cfg.seed)
    itable = pim.put_table(Wi, placement=cfg.placement, seed=cfg.seed + 1)

    if state is not None:
        arrays, meta = state["arrays"], state["meta"]
        it_done = int(meta["iters"])
        history = [tuple(h) for h in meta.get("history", [])]
        rng = unpack_rng(arrays, meta) or rng
        Ut = utable.place_rows(arrays["u_tab"])
        It = itable.place_rows(arrays["i_tab"])
        Uids = utable.ids_device()
        Iids = itable.ids_device()
        utable.restore_pending(arrays["pend_u_idx"], arrays["pend_u_upd"],
                               int(meta.get("pend_u_batches", 0)))
        itable.restore_pending(arrays["pend_i_idx"], arrays["pend_i_upd"],
                               int(meta.get("pend_i_batches", 0)))
    else:
        Ut, Uids = utable.view(cfg.version, f)
        It, Iids = itable.view(cfg.version, f)

    lead_host = np.zeros(pim.n_shards, np.int32 if int_ver else np.float32)
    lead_host[0] = 1
    lead = pim.shard_rows(lead_host)

    fused = deferred and cfg.fuse_steps > 1
    if fused:
        # a flush writes the new rows back into these buffers: the chunk
        # graphs read the tables at one address for the whole fit
        Ut, It = Ut.clone(), It.clone()
    update = make_emb_update(cfg, dev)
    # the gather indexes are this fit's tables' own, so the forward kernel
    # is bound to them and passed to the map as a callable, under no shared
    # name (they are not operands of the map, whose operand bytes the host
    # target charges)
    fwd_k = build_emb_fwd(utable.gather_index(), itable.gather_index())
    apply_k = pim.named_kernel(f"emb.apply/{cfg.version}", build_emb_apply)
    n_flushes = 0

    def to_dev(v) -> torch.Tensor:
        return torch.from_numpy(np.asarray(v)).to(dev)

    def draw():
        rows = rng.randint(0, n, size=cfg.batch)
        return (pairs[rows, 0].copy(), pairs[rows, 1].copy(),
                y_host[rows].copy())

    def batch_loss(err) -> torch.Tensor:
        e = err.to(torch.float32)
        return batch_sq_error(e * 2.0 ** -f if int_ver else e)

    def record(it, loss: Callable):
        if cfg.record_every and (it % cfg.record_every == 0
                                 or it == cfg.n_iters):
            history.append((it, float(loss()) / cfg.batch))

    def _pad_flush(idx, upd):
        """Pad a flush batch up to a multiple of cfg.batch (sentinel ids,
        zero rows: exact no-ops in the scatter), as the reference does."""
        m = int(idx.shape[0])
        bucket = max(cfg.batch, -(-m // cfg.batch) * cfg.batch)
        if bucket == m:
            return idx, upd
        upd = host_array(upd)
        pad_i = np.full(bucket - m, IDX_PAD, np.int32)
        pad_u = np.zeros((bucket - m, upd.shape[1]), upd.dtype)
        return (np.concatenate([host_array(idx), pad_i]),
                np.concatenate([upd, pad_u]))

    def _apply_rows(iu, du, ii, di):
        """One batched scatter-add of sparse delta rows into both tables
        (the eager apply AND the deferred flush)."""
        nonlocal Ut, It, n_flushes
        payload = _tree_bytes((iu, du, ii, di))
        pim.stats.flush_bytes += payload
        # the sparse update leg crosses rank boundaries on its way to
        # the owning banks (no charge on host targets)
        pim._charge_topology(0, payload)
        iu, du = _pad_flush(iu, du)
        ii, di = _pad_flush(ii, di)
        out = pim.map_elementwise(
            apply_k, (Ut, Uids, It, Iids),
            tuple(torch.as_tensor(v, device=dev) for v in (iu, du, ii, di)))
        if fused:
            # the chunk graphs read the tables where they lie
            Ut.copy_(out["u"])
            It.copy_(out["i"])
        else:
            Ut, It = out["u"], out["i"]
        n_flushes += 1

    def _compressed(table, idx, upd):
        """int8 the flush rows; the residual re-stages as sparse error
        feedback for the next window (exact on int32)."""
        q, scales, deq, residual = quantize_rows(upd)
        pim.stats.compressed_bytes += q.nbytes + scales.nbytes + idx.nbytes
        if residual.any():
            table.stage(idx, residual)
        return deq

    def _flush_window():
        """Drain both ledgers into one batched scatter-add.  A single
        staged batch (the D=1 identity) skips dedup: it ships verbatim
        through the same kernel call eager would make."""
        dedup = max(utable.pending_batches, itable.pending_batches) > 1
        iu, du = utable.drain(dedup=dedup)
        ii, di = itable.drain(dedup=dedup)
        if iu.size == 0 and ii.size == 0:
            return
        if cfg.compress_flush:
            du = _compressed(utable, iu, du)
            di = _compressed(itable, ii, di)
        _apply_rows(iu, du, ii, di)

    def _snapshot():
        ra, rm = pack_rng(rng)
        pu_idx, pu_upd = utable.pending_arrays()
        pi_idx, pi_upd = itable.pending_arrays()
        arrays = {"u_tab": utable.unshard(Ut),
                  "i_tab": itable.unshard(It),
                  "pend_u_idx": pu_idx, "pend_u_upd": pu_upd,
                  "pend_i_idx": pi_idx, "pend_i_upd": pi_upd}
        arrays.update(ra)
        meta = {"iters": int(it_done),
                "history": [[int(i), None if m is None else float(m)]
                            for i, m in history],
                "pend_u_batches": int(utable.pending_batches),
                "pend_i_batches": int(itable.pending_batches)}
        meta.update(rm)
        return {"arrays": arrays, "meta": meta}

    if fused:
        # each chunk's k batches are drawn up front and ride in as
        # per-step inputs; the delta rows and errors come out as stacked
        # emits, the rows staged on the host.  Chunks end at record
        # points, so only a chunk's last loss is ever read: it is reduced
        # from that step's errors after the replay, and the boundary is
        # charged one float32 loss a step, the reference's emit
        def step(carry, red):
            du, di, err = update(red)
            return carry + 1, (du, di, err)

        def shipped(outs):
            du, di, err = outs
            return du, di, torch.empty(err.shape[:1], dtype=torch.float32,
                                       device="meta")

        program = pim.step_program(
            fwd_k, lambda carry: (), step,
            name=(f"emb.step/{cfg.version}/f{f}/lr{cfg.lr}/b{cfg.batch}"
                  f"/D{D}"),
            select=lambda shards, x: (*shards, *x), shipped=shipped)
        carry = torch.tensor(it_done, dtype=torch.int32, device=dev)
        it = it_done
        try:
            while it < cfg.n_iters:
                # chunks end at window flushes and record points
                k = min(cfg.fuse_steps, cfg.n_iters - it, D - it % D)
                if cfg.record_every:
                    k = min(k, cfg.record_every - it % cfg.record_every)
                batches = [draw() for _ in range(k)]
                xs = tuple(to_dev(np.stack([bt[j] for bt in batches]))
                           for j in range(3))
                if pim.kind == "pim":
                    # the per-step minibatch legs cross host->bank as
                    # the serial loop's broadcast does
                    pim.stats.cpu_to_pim += (_tree_bytes(xs)
                                             * pim.config.n_cores)
                carry, outs = program.run(
                    carry, (Ut, Uids, It, Iids, lead), k, xs=xs)
                du_k, di_k = (host_array(o) for o in outs[:2])
                for j in range(k):
                    utable.stage(batches[j][0], du_k[j])
                    itable.stage(batches[j][1], di_k[j])
                record(it + k, lambda: batch_loss(outs[2][k - 1]))
                it = it_done = it + k
                if it % D == 0 or it == cfg.n_iters:
                    _flush_window()
                yield ChunkTick(k, _snapshot)
        finally:
            # the chunk graphs read this fit's tables and gather indexes
            program.release()
    else:
        for it in range(it_done, cfg.n_iters):
            iu, ii, yb = draw()
            rep = pim.broadcast((to_dev(iu), to_dev(ii), to_dev(yb)))
            red = pim.map_reduce(fwd_k, (Ut, Uids, It, Iids, lead),
                                 tuple(rep))
            du, di, err = update(red)
            if deferred:
                utable.stage(iu, host_array(du))
                itable.stage(ii, host_array(di))
                if (it + 1) % D == 0 or it + 1 == cfg.n_iters:
                    _flush_window()
            else:
                _apply_rows(rep[0], du, rep[1], di)
            it_done = it + 1
            record(it_done, lambda: batch_loss(err))
            yield ChunkTick(1, _snapshot)

    u_raw = utable.unshard(Ut)
    i_raw = itable.unshard(It)
    if int_ver:
        u_emb = from_fixed(torch.from_numpy(u_raw), f).numpy()
        i_emb = from_fixed(torch.from_numpy(i_raw), f).numpy()
    else:
        u_emb, i_emb = u_raw, i_raw
    return EmbResult(user_emb=u_emb, item_emb=i_emb, user_raw=u_raw,
                     item_raw=i_raw, history=history,
                     n_iters=cfg.n_iters, n_flushes=n_flushes)


def fit(dataset, cfg: Optional[EmbConfig] = None) -> EmbResult:
    """Train EMB over a resident dataset and sharded tables: the table
    placements are paid once and the per-step traffic is sparse ids and
    rows only."""
    return run_steps(fit_steps(dataset, cfg))
