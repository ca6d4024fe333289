"""Recurrent sequence mixers (port of ``repro.models.ssm``): xLSTM's mLSTM
and sLSTM, and the Mamba-style selective SSM of the Hymba blocks.

Training and prefill use the parallel forms (chunkwise for the mLSTM, a
scan for the selective SSM; the sLSTM is sequential by nature), decode
the O(1)-per-token recurrent updates.  The mLSTM tracks its exponential
gates in log space with a running max ``m``, so the chunkwise and
recurrent forms compute the same function.

Where the reference's prefill replays the recurrence for the final state
(the mLSTM, ``transformer.py:517-534``) or recomputes a second scan (the
SSM), the port takes it from the parallel form's own carry: the chunkwise
scan's last ``(c, n, m)`` and the scan's last ``h``.

:func:`linear_scan` stands in for ``jax.lax.associative_scan`` over
``h_t = a_t h_{t-1} + b_t``: a log-depth (Hillis-Steele) scan, the same
recurrence in another product order.

On sharded parameters (inside ``use_mesh``, the block's input a DTensor
``[B, S, d]``, rows over the data axes, whole over "model") each mixer
runs on its rank's shards (:class:`_Shards`; the one-process path reads
the same code through :class:`_Whole`, whose collectives are nothing).
Each rank does its own share of the work, so every gradient inside is a
partial sum over "model" (``tp.Gather``, ``tp.Scatter``, ``tp.Reduce``):

* mLSTM: ``w_up``, ``w_gate`` and ``conv_w`` split ``d_inner``
  (column-parallel; the depthwise conv on the local channels); ``u`` is
  gathered once and feeds ``wq``, ``wk``, ``wv`` (column-parallel: q, k and
  v split by heads) and the replicated ``w_if`` (the gates whole, no
  reduction; a rank keeps its heads').  The chunkwise scan runs on the
  rank's heads, whose hidden columns are ``g``'s; ``w_down`` is
  row-parallel, one sum.  Where "model" does not divide the heads (xlstm's
  4 over 16 ranks: a rank would hold a quarter of a head), q, k and v are
  gathered to whole heads, the cell runs whole on every rank, and its
  hidden is cut to ``g``'s columns;
* sLSTM: ``w_x`` splits the gate blocks, not the heads, so ``xp`` is
  gathered once, before the loop (once a step in decode); the cell runs
  whole on every rank with no collective inside; ``w_out`` is
  row-parallel on the hidden's local rows, one sum;
* selective SSM: ``w_in`` and ``conv_w`` split ``d_inner``, ``a_log`` and
  ``d_skip`` with it (``dt_bias`` is replicated and cut locally);
  ``w_bc`` and ``w_dt`` are row-parallel: ``bc`` (2N wide) is summed,
  ``dt`` summed and scattered to the rank's channels, so the scan runs
  on ``[B, S, Di / model, N]``; ``w_out`` is row-parallel, one sum.

The decode states are laid out as these computations read them
(``sharding.state_spec``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..distributed.act_sharding import constrain
from ..distributed.sharding import state_tensor
from ..distributed.tp import Gather, Reduce, Scatter
from ..kernels.dispatch import is_dtensor
from .layers import Params, dense_init, normal_init, rms_norm

#: the mLSTM's chunk length (``mlstm_chunkwise``'s default)
MLSTM_CHUNK = 64


# ---------------------------------------------------------------------------
# A mixer's parameters on one process, or on a rank's shards.
# ---------------------------------------------------------------------------

class _Whole:
    """The one-process view of a mixer call: ``x`` and the parameters as
    they are, no collective (each of :class:`_Shards`' moves the
    identity)."""

    n, index = 1, 0

    def __init__(self, params, x):
        self.params, self.x = params, x

    def __getitem__(self, name: str):
        return self.params[name]

    def gather(self, t):
        return t

    reduce = scatter = block = gather

    def out(self, t):
        return t

    def state(self, t, dim=None):
        return t

    @staticmethod
    def local(t):
        return t


class _Shards:
    """A mixer call on a rank: ``x`` (a DTensor ``[B, S, d]``, rows over the
    data axes, whole over "model") as its local rows, each parameter as its
    local shard, and the moves between the rank's shares of the work.

    ``splits`` names the weights split over "model" with the tensor dim
    each splits; they must split over the same mesh dims (``mdims``, whose
    ``n`` ranks this one is ``index`` of), or none.  A parameter's
    gradient keeps its layout and is a partial sum over the mesh dims
    where the rank's use of it is its share: x's row split, and ``mdims``
    where the parameter is whole (every rank's work downstream is its
    own channels' or heads')."""

    def __init__(self, params, x, splits: dict):
        from torch.distributed.tensor import Partial
        mesh = x.device_mesh
        dims = {tuple(i for i, p in enumerate(params[name].placements)
                      if p.is_shard(d)) if is_dtensor(params[name]) else ()
                for name, d in splits.items()}
        if len(dims) > 1:
            raise ValueError(f"the mixer's weights split over different mesh "
                             f"dims {sorted(dims)}")
        self.params, self.mesh, self.memo = params, mesh, {}
        self.mdims = list(dims.pop())
        self.rows = [i for i, p in enumerate(x.placements) if p.is_shard(0)]
        if any(p.is_partial() or (p.is_shard() and i not in self.rows)
               for i, p in enumerate(x.placements)):
            raise ValueError(f"mixer input placed {x.placements}: rows over "
                             f"the data axes, whole over 'model' expected")
        coord = mesh.get_coordinate()
        self.n, self.index = 1, 0
        for i in self.mdims:
            self.n = self.n * mesh.size(i)
            self.index = self.index * mesh.size(i) + coord[i]
        # gathers take the innermost mesh dim first, scatters the outermost
        self.inner = [mesh.get_group(i) for i in reversed(self.mdims)]
        self.outer = self.inner[::-1]
        self.x = x.to_local(grad_placements=[
            Partial() if i in self.mdims else p
            for i, p in enumerate(x.placements)])
        self.shape = x.shape

    def __getitem__(self, name: str):
        if name not in self.memo:
            from torch.distributed.tensor import Partial, Replicate
            w = self.params[name]
            self.memo[name] = w.to_local(grad_placements=[
                p if p.is_shard() else Partial()
                if i in self.rows or i in self.mdims else Replicate()
                for i, p in enumerate(w.placements)]) if is_dtensor(w) else w
        return self.memo[name]

    def gather(self, t):
        """Every rank's ``t`` concatenated along its last dim."""
        return Gather.apply(t, -1, self.inner)

    def reduce(self, t):
        """The sum over "model" of the partial sums ``t``."""
        return Reduce.apply(t, self.outer)

    def scatter(self, t):
        """The sum over "model" of the partial sums ``t``, this rank's
        block of its last dim."""
        return Scatter.apply(t, -1, self.outer)

    def block(self, t):
        """This rank's block of a whole ``t``'s last dim (the columns a
        column-parallel weight gives it)."""
        return t.chunk(self.n, dim=-1)[self.index] if self.n > 1 else t

    def out(self, t):
        """The row-parallel product's partial sums ``t [B_local, S, d]``,
        summed over "model" (the residual stream's cut point)."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard
        pl = [Partial() if i in self.mdims else Shard(0) if i in self.rows
              else Replicate() for i in range(self.mesh.ndim)]
        shape = torch.Size((self.shape[0], *t.shape[1:]))
        return constrain(DTensor.from_local(
            t, self.mesh, pl, run_check=False, shape=shape,
            stride=torch.empty(shape, device="meta").stride()), "btd")

    def state(self, t, dim=None):
        """A decode state's local shard ``t`` as a DTensor: rows as x's,
        dim ``dim`` over "model" (None: whole on every rank)."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        pl = [Shard(dim) if dim is not None and i in self.mdims else
              Shard(0) if i in self.rows else Replicate()
              for i in range(self.mesh.ndim)]
        return DTensor.from_local(t, self.mesh, pl, run_check=False)

    @staticmethod
    def local(t):
        return t.to_local() if is_dtensor(t) else t


def _view(params, x, splits: dict):
    """:class:`_Shards` for a DTensor ``x``, else :class:`_Whole`."""
    return _Shards(params, x, splits) if is_dtensor(x) else _Whole(params, x)


# ---------------------------------------------------------------------------
# Causal depthwise conv (the mLSTM and SSM branches).
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x ``[B, S, C]``, w ``[K, C]``: depthwise causal conv, ``out[t] =
    sum_j x[t - K + 1 + j] w[j]`` (zeros before the start), summed in
    float32 and returned in x's dtype."""
    k = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0)).to(torch.float32)
    wf = w.to(torch.float32)
    out = xp[:, :s] * wf[0]
    for j in range(1, k):
        out = out + xp[:, j:j + s] * wf[j]
    return out.to(x.dtype)


def conv_state_init(batch: int, width: int, channels: int,
                    dtype: torch.dtype, device) -> torch.Tensor:
    return torch.zeros((batch, width - 1, channels), dtype=dtype,
                       device=device)


def conv_state_of(x: torch.Tensor, width: int) -> torch.Tensor:
    """The conv's state after the sequence x ``[B, S, C]``: its last
    ``width - 1`` inputs, zeros before the start."""
    return F.pad(x, (0, 0, width - 1, 0))[:, -(width - 1):]


def causal_conv1d_step(x_t: torch.Tensor, state: torch.Tensor,
                       w: torch.Tensor):
    """Single-token conv: x_t ``[B, 1, C]``, state ``[B, K-1, C]`` ->
    ``(out [B, 1, C], new state)``."""
    window = torch.cat([state, x_t], dim=1)                  # [B, K, C]
    out = torch.sum(window.to(torch.float32) * w.to(torch.float32)[None],
                    dim=1, keepdim=True)
    return out.to(x_t.dtype), window[:, 1:]


# ---------------------------------------------------------------------------
# mLSTM (matrix memory): xLSTM's parallelizable block.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MlstmSpec:
    d_model: int
    n_heads: int
    proj_factor: float = 2.0
    conv_width: int = 4

    @property
    def d_inner(self) -> int:
        return int(self.d_model * self.proj_factor)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


class MlstmState(NamedTuple):
    c: torch.Tensor     # [B, H, Dh, Dh] stabilized matrix memory
    n: torch.Tensor     # [B, H, Dh]
    m: torch.Tensor     # [B, H] log-space stabilizer
    conv: torch.Tensor  # [B, K-1, Di]


def init_mlstm(gen: torch.Generator, spec: MlstmSpec,
               dtype: torch.dtype) -> Params:
    d, di, h = spec.d_model, spec.d_inner, spec.n_heads
    f32 = torch.float32
    return Params(
        w_up=dense_init(gen, d, di, dtype),
        w_gate=dense_init(gen, d, di, dtype),
        conv_w=normal_init(gen, (spec.conv_width, di), 0.1, dtype),
        wq=dense_init(gen, di, di, dtype),
        wk=dense_init(gen, di, di, dtype),
        wv=dense_init(gen, di, di, dtype),
        w_if=dense_init(gen, di, 2 * h, f32),
        b_if=torch.cat([torch.zeros((h,), dtype=f32, device=gen.device),
                        torch.full((h,), 3.0, dtype=f32,
                                   device=gen.device)]),
        w_down=dense_init(gen, di, d, dtype))


#: the mLSTM's weights split over "model" and the dim each splits
_MLSTM_SPLITS = {"w_up": 1, "w_gate": 1, "conv_w": 1, "wq": 1, "wk": 1,
                 "wv": 1, "w_down": 0}


def _mlstm_qkv_gates(p, spec: MlstmSpec, u: torch.Tensor):
    """u ``[B, S, Di]`` (the post-conv branch; a rank's channels) -> q, k,
    v ``[B, S, H, Dh]`` and the log gates ``[B, S, H]`` of the heads the
    view ``p`` runs (a rank's, or every head where "model" does not divide
    them), and whether the rank runs its own heads."""
    h, dh = spec.n_heads, spec.head_dim
    own = h % p.n == 0                 # whole heads a rank
    hn = h // p.n if own else h
    h0 = p.index * hn if own else 0
    u = p.gather(u)                    # once: wq, wk, wv and w_if read it
    b, s, _ = u.shape
    qkv = [u @ p[n].to(u.dtype) for n in ("wq", "wk", "wv")]
    if not own:                        # a rank holds part of a head
        qkv = [p.gather(t) for t in qkv]
    q, k, v = (t.reshape(b, s, hn, dh) for t in qkv)
    k = k / torch.sqrt(torch.tensor(float(dh))).to(k.dtype)   # f32 sqrt
    gates = u.to(torch.float32) @ p["w_if"] + p["b_if"]
    logi = gates[..., h0:h0 + hn]                  # exponential input gate
    logf = F.logsigmoid(gates[..., h + h0:h + h0 + hn])   # sigmoid forget
    return q, k, v, logi, logf, own


def _mlstm_chunks(q, k, v, logi, logf, chunk: int):
    """The chunkwise scan from the zero state: (hidden ``[B, S, H*Dh]``
    float32, the final ``(c, n, m)``)."""
    b, s, h, dh = q.shape
    f32 = torch.float32
    c_st = torch.zeros((b, h, dh, dh), dtype=f32, device=q.device)
    n_st = torch.zeros((b, h, dh), dtype=f32, device=q.device)
    m_st = torch.full((b, h), -1e30, dtype=f32, device=q.device)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=q.device))
    outs = []
    for i in range(0, s, chunk):
        # [B, H, L, dh] and gates [B, H, L]
        qb, kb, vb = (t[:, i:i + chunk].to(f32).transpose(1, 2)
                      for t in (q, k, v))
        li = logi[:, i:i + chunk].transpose(1, 2)
        lf = logf[:, i:i + chunk].transpose(1, 2)
        bcum = torch.cumsum(lf, dim=-1)          # decay from chunk start
        a = li - bcum                            # log i_j - b_j
        big_a = torch.maximum(m_st[..., None], torch.cummax(a, dim=-1)[0])
        sc = torch.einsum("bhid,bhjd->bhij", qb, kb)
        # (q_i k_j) exp(a_j - A_i) for j <= i; masked before the exp, so
        # no j > i overflows into the gradient
        w = torch.exp((a[:, :, None, :] - big_a[:, :, :, None])
                      .masked_fill(~causal, float("-inf")))
        num = torch.einsum("bhij,bhjd->bhid", sc * w, vb)
        ninc = torch.einsum("bhij,bhjd->bhid", w, kb)
        inter = torch.exp(m_st[..., None] - big_a)           # [B, H, L]
        num = num + inter[..., None] * torch.einsum("bhie,bhde->bhid", qb,
                                                    c_st)
        nvec = ninc + inter[..., None] * n_st[:, :, None, :]
        qn = torch.abs(torch.einsum("bhid,bhid->bhi", qb, nvec))
        m_abs = bcum + big_a
        denom = torch.maximum(qn, torch.exp(-torch.clamp(m_abs, -30.0,
                                                         30.0)))
        outs.append((num / denom[..., None]).transpose(1, 2)
                    .reshape(b, -1, h * dh))
        # end-of-chunk state
        a_last = big_a[..., -1]
        wl = torch.exp(a - a_last[..., None])                # [B, H, L]
        decay = torch.exp(m_st - a_last)
        c_st = decay[..., None, None] * c_st + torch.einsum(
            "bhj,bhjd,bhje->bhde", wl, vb, kb)
        n_st = decay[..., None] * n_st + torch.einsum("bhj,bhjd->bhd", wl,
                                                      kb)
        m_st = bcum[..., -1] + a_last
    return torch.cat(outs, dim=1), (c_st, n_st, m_st)


def _mlstm_forward(params, spec: MlstmSpec, x: torch.Tensor,
                   chunk: int = MLSTM_CHUNK):
    """(out ``[B, S, d]``, the state after the sequence)."""
    s = x.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"mlstm_chunkwise: sequence length {s} is not a "
                         f"multiple of the chunk {chunk} (the reference's "
                         f"contract)")
    p = _view(params, x, _MLSTM_SPLITS)
    x = p.x
    u0 = x @ p["w_up"].to(x.dtype)
    g = x @ p["w_gate"].to(x.dtype)
    u = F.silu(causal_conv1d(u0, p["conv_w"]))
    q, k, v, logi, logf, own = _mlstm_qkv_gates(p, spec, u)
    hseq, (c, n, m) = _mlstm_chunks(q, k, v, logi, logf, chunk)
    if not own:                        # g's columns of the whole heads
        hseq = p.block(hseq)
    out = (hseq.to(x.dtype) * F.silu(g)) @ p["w_down"].to(x.dtype)
    hd = 1 if own else None
    return p.out(out), MlstmState(
        p.state(c, hd), p.state(n, hd), p.state(m, hd),
        p.state(conv_state_of(u0, spec.conv_width), 2))


def mlstm_chunkwise(params, spec: MlstmSpec, x: torch.Tensor,
                    chunk: int = MLSTM_CHUNK) -> torch.Tensor:
    """Parallel training form: chunks in sequence, quadratic within one.
    S must be at most ``chunk`` or a multiple of it (ValueError
    otherwise, as the reference asserts)."""
    return _mlstm_forward(params, spec, x, chunk)[0]


def mlstm_state_init(batch: int, spec: MlstmSpec, dtype: torch.dtype,
                     device, mesh=None) -> MlstmState:
    """The zero state; on ``mesh`` DTensors (``sharding.state_spec``)."""
    h, dh = spec.n_heads, spec.head_dim
    f32 = torch.float32

    def make(field, shape, fill, dt=f32):
        return state_tensor("mlstm", field, shape, fill, dt, device, mesh)
    return MlstmState(
        c=make("c", (batch, h, dh, dh), 0.0),
        n=make("n", (batch, h, dh), 0.0),
        m=make("m", (batch, h), -1e30),
        conv=make("conv", (batch, spec.conv_width - 1, spec.d_inner), 0.0,
                  dtype))


def _mlstm_step(q, k, v, li, lf, c, n, m):
    """The recurrent update of one token: q, k, v ``[B, H, dh]`` float32,
    the log gates ``[B, H]``, the state -> (hidden ``[B, H, dh]``, new c,
    n, m)."""
    m_new = torch.maximum(lf + m, li)
    fp = torch.exp(lf + m - m_new)
    ip = torch.exp(li - m_new)
    c_new = fp[..., None, None] * c + ip[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", v, k)
    n_new = fp[..., None] * n + ip[..., None] * k
    num = torch.einsum("bhde,bhe->bhd", c_new, q)
    qn = torch.abs(torch.einsum("bhd,bhd->bh", q, n_new))
    denom = torch.maximum(qn, torch.exp(-torch.clamp(m_new, -30.0, 30.0)))
    return num / denom[..., None], c_new, n_new, m_new


def mlstm_decode_step(params, spec: MlstmSpec, x: torch.Tensor,
                      state: MlstmState) -> tuple[torch.Tensor, MlstmState]:
    """x ``[B, 1, d]`` -> ``([B, 1, d], new state)``: the recurrent
    update."""
    p = _view(params, x, _MLSTM_SPLITS)
    x = p.x
    b = x.shape[0]
    f32 = torch.float32
    c, n, m, conv = (p.local(t) for t in state)
    u0 = x @ p["w_up"].to(x.dtype)
    g = x @ p["w_gate"].to(x.dtype)
    conv_out, conv_new = causal_conv1d_step(u0, conv, p["conv_w"])
    q, k, v, logi, logf, own = _mlstm_qkv_gates(p, spec, F.silu(conv_out))
    q, k, v = (t[:, 0].to(f32) for t in (q, k, v))          # [B, H, dh]
    hid, c_new, n_new, m_new = _mlstm_step(q, k, v, logi[:, 0], logf[:, 0],
                                           c, n, m)
    hid = hid.reshape(b, 1, -1)
    if not own:                        # g's columns of the whole heads
        hid = p.block(hid)
    out = (hid.to(x.dtype) * F.silu(g)) @ p["w_down"].to(x.dtype)
    hd = 1 if own else None
    return p.out(out), MlstmState(p.state(c_new, hd), p.state(n_new, hd),
                                  p.state(m_new, hd), p.state(conv_new, 2))


# ---------------------------------------------------------------------------
# sLSTM: xLSTM's scalar-memory block (sequential over time).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SlstmSpec:
    d_model: int
    n_heads: int
    conv_width: int = 4

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


class SlstmState(NamedTuple):
    c: torch.Tensor   # [B, D]
    n: torch.Tensor   # [B, D]
    h: torch.Tensor   # [B, D]
    m: torch.Tensor   # [B, D]


def init_slstm(gen: torch.Generator, spec: SlstmSpec,
               dtype: torch.dtype) -> Params:
    d, hds, dh = spec.d_model, spec.n_heads, spec.head_dim
    f32 = torch.float32
    return Params(
        w_x=dense_init(gen, d, 4 * d, f32),
        # block-diagonal recurrent weights, one block per head
        r=normal_init(gen, (hds, dh, 4 * dh), 1.0 / math.sqrt(dh), f32),
        b=torch.zeros((4 * d,), dtype=f32, device=gen.device),
        w_out=dense_init(gen, d, d, dtype),
        norm=torch.ones((d,), dtype=f32, device=gen.device))


def slstm_state_init(batch: int, spec: SlstmSpec, device,
                     mesh=None) -> SlstmState:
    """The zero state; on ``mesh`` DTensors (``sharding.state_spec``: whole
    over "model")."""
    shape = (batch, spec.d_model)

    def make(field, fill):
        return state_tensor("slstm", field, shape, fill, torch.float32,
                            device, mesh)
    if mesh is None:
        z = make("c", 0.0)
        return SlstmState(z, z, z, make("m", -1e30))
    return SlstmState(make("c", 0.0), make("n", 0.0), make("h", 0.0),
                      make("m", -1e30))


#: the sLSTM's weights split over "model" and the dim each splits (``w_x``
#: its four gate blocks' columns, not its heads)
_SLSTM_SPLITS = {"w_x": 1, "w_out": 0}


def _slstm_cell(params, spec: SlstmSpec, xt: torch.Tensor,
                st: SlstmState) -> tuple[torch.Tensor, SlstmState]:
    """xt ``[B, 4D]``: the input side's pre-activations."""
    b, d = st.h.shape
    hprev = st.h.reshape(b, spec.n_heads, spec.head_dim)
    rec = torch.einsum("bhd,hde->bhe", hprev, params["r"]).reshape(b, 4 * d)
    zt, it, ft, ot = torch.chunk(xt + rec + params["b"], 4, dim=-1)
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + st.m, it)
    ip = torch.exp(it - m_new)
    fp = torch.exp(logf + st.m - m_new)
    c_new = fp * st.c + ip * torch.tanh(zt)
    n_new = fp * st.n + ip
    h_new = torch.sigmoid(ot) * c_new / torch.clamp_min(n_new, 1.0)
    return h_new, SlstmState(c_new, n_new, h_new, m_new)


def _slstm_forward(params, spec: SlstmSpec, x: torch.Tensor):
    """(out ``[B, S, d]``, the state after the sequence): a loop over
    time."""
    p = _view(params, x, _SLSTM_SPLITS)
    x = p.x
    b, s, _ = x.shape
    xp = p.gather(x.to(torch.float32) @ p["w_x"])      # once, before the loop
    st = slstm_state_init(b, spec, x.device)
    hs = []
    for i in range(s):
        h, st = _slstm_cell(p, spec, xp[:, i], st)
        hs.append(h)
    hs = p.block(rms_norm(torch.stack(hs, dim=1), p["norm"]))
    return (p.out(hs.to(x.dtype) @ p["w_out"].to(x.dtype)),
            SlstmState(*(p.state(t) for t in st)))


def slstm_apply(params, spec: SlstmSpec, x: torch.Tensor) -> torch.Tensor:
    """Training form: sequential over time."""
    return _slstm_forward(params, spec, x)[0]


def slstm_decode_step(params, spec: SlstmSpec, x: torch.Tensor,
                      state: SlstmState):
    p = _view(params, x, _SLSTM_SPLITS)
    x = p.x
    xt = p.gather(x[:, 0].to(torch.float32) @ p["w_x"])
    h, st = _slstm_cell(p, spec, xt, SlstmState(*(p.local(t)
                                                  for t in state)))
    h = p.block(rms_norm(h[:, None, :], p["norm"]))
    return (p.out(h.to(x.dtype) @ p["w_out"].to(x.dtype)),
            SlstmState(*(p.state(t) for t in st)))


# ---------------------------------------------------------------------------
# Mamba-style selective SSM (Hymba's SSM heads).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SsmSpec:
    d_model: int
    d_inner: int
    d_state: int = 16
    conv_width: int = 4


class SsmState(NamedTuple):
    h: torch.Tensor      # [B, Di, N]
    conv: torch.Tensor   # [B, K-1, Di]


def init_ssm(gen: torch.Generator, spec: SsmSpec,
             dtype: torch.dtype) -> Params:
    d, di, n = spec.d_model, spec.d_inner, spec.d_state
    f32, dev = torch.float32, gen.device
    return Params(
        w_in=dense_init(gen, d, di, dtype),
        conv_w=normal_init(gen, (spec.conv_width, di), 0.1, dtype),
        w_bc=dense_init(gen, di, 2 * n, f32),
        w_dt=dense_init(gen, di, di, f32),
        dt_bias=torch.full((di,), -2.0, dtype=f32, device=dev),
        a_log=torch.log(torch.arange(1, n + 1, dtype=f32, device=dev)
                        ).expand(di, n).contiguous(),
        d_skip=torch.ones((di,), dtype=f32, device=dev),
        w_out=dense_init(gen, di, d, dtype))


#: the selective SSM's weights split over "model" and the dim each splits
_SSM_SPLITS = {"w_in": 1, "conv_w": 1, "w_bc": 0, "w_dt": 0, "a_log": 0,
               "d_skip": 0, "w_out": 0}


def _ssm_inputs(p, spec: SsmSpec, u: torch.Tensor):
    """u ``[B, S, Di]`` post-conv (a rank's channels) -> (dA ``[B, S, Di,
    N]``, dBu ``[B, S, Di, N]``, C ``[B, S, N]``), float32, on the view
    ``p``'s channels: ``bc`` and ``dt`` are row-parallel partial sums over
    "model", ``bc`` summed, ``dt`` summed and scattered to the channels."""
    uf = u.to(torch.float32)
    bc = p.reduce(uf @ p["w_bc"])
    bmat, cmat = torch.chunk(bc, 2, dim=-1)
    dt = F.softplus(p.scatter(uf @ p["w_dt"]) + p.block(p["dt_bias"]))
    a = -torch.exp(p["a_log"])                                   # [Di, N]
    da = torch.exp(dt[..., None] * a)
    dbu = dt[..., None] * bmat[:, :, None, :] * uf[..., None]
    return da, dbu, cmat


def linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1
                ) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` from ``h_{-1} = 0`` along ``dim``, for
    every t: Hillis-Steele doubling, log2(S) passes, each combining
    ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)`` as the reference's
    associative scan does, in another product order."""
    s = a.shape[dim]
    step = 1
    while step < s:
        a_hi, b_hi = a.narrow(dim, step, s - step), b.narrow(dim, step,
                                                             s - step)
        a_lo, b_lo = a.narrow(dim, 0, s - step), b.narrow(dim, 0, s - step)
        b = torch.cat([b.narrow(dim, 0, step), a_hi * b_lo + b_hi], dim=dim)
        if step * 2 < s:
            a = torch.cat([a.narrow(dim, 0, step), a_hi * a_lo], dim=dim)
        step *= 2
    return b


def _ssm_forward(params, spec: SsmSpec, x: torch.Tensor):
    """(out ``[B, S, d]``, the state after the sequence)."""
    p = _view(params, x, _SSM_SPLITS)
    x = p.x
    u0 = x @ p["w_in"].to(x.dtype)
    u = F.silu(causal_conv1d(u0, p["conv_w"]))
    da, dbu, cmat = _ssm_inputs(p, spec, u)
    hh = linear_scan(da, dbu, dim=1)                          # [B, S, Di, N]
    y = torch.einsum("bsdn,bsn->bsd", hh, cmat)
    y = y + p["d_skip"] * u.to(torch.float32)
    out = y.to(x.dtype) @ p["w_out"].to(x.dtype)
    return p.out(out), SsmState(
        p.state(hh[:, -1], 1), p.state(conv_state_of(u0, spec.conv_width),
                                       2))


def ssm_apply(params, spec: SsmSpec, x: torch.Tensor) -> torch.Tensor:
    """Training form: a scan over time."""
    return _ssm_forward(params, spec, x)[0]


def ssm_state_init(batch: int, spec: SsmSpec, dtype: torch.dtype,
                   device, mesh=None) -> SsmState:
    """The zero state; on ``mesh`` DTensors (``sharding.state_spec``)."""
    return SsmState(
        h=state_tensor("ssm", "h", (batch, spec.d_inner, spec.d_state), 0.0,
                       torch.float32, device, mesh),
        conv=state_tensor("ssm", "conv",
                          (batch, spec.conv_width - 1, spec.d_inner), 0.0,
                          dtype, device, mesh))


def ssm_decode_step(params, spec: SsmSpec, x: torch.Tensor,
                    state: SsmState) -> tuple[torch.Tensor, SsmState]:
    p = _view(params, x, _SSM_SPLITS)
    x = p.x
    h, conv = (p.local(t) for t in state)
    u0 = x @ p["w_in"].to(x.dtype)
    conv_out, conv_new = causal_conv1d_step(u0, conv, p["conv_w"])
    u = F.silu(conv_out)                                      # [B, 1, Di]
    da, dbu, cmat = _ssm_inputs(p, spec, u)
    h_new = da[:, 0] * h + dbu[:, 0]                          # [B, Di, N]
    y = torch.einsum("bdn,bn->bd", h_new, cmat[:, 0])
    y = y + p["d_skip"] * u[:, 0].to(torch.float32)
    out = y[:, None].to(x.dtype) @ p["w_out"].to(x.dtype)
    return p.out(out), SsmState(p.state(h_new, 1), p.state(conv_new, 2))
