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
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import Params, dense_init, normal_init, rms_norm

#: the mLSTM's chunk length (``mlstm_chunkwise``'s default)
MLSTM_CHUNK = 64


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


def _mlstm_qkv_gates(params, spec: MlstmSpec, u: torch.Tensor):
    """u ``[B, S, Di]`` (the post-conv branch) -> per-head q, k, v
    ``[B, S, H, Dh]`` and the log gates ``[B, S, H]``."""
    b, s, _ = u.shape
    h, dh = spec.n_heads, spec.head_dim
    q = (u @ params["wq"].to(u.dtype)).reshape(b, s, h, dh)
    k = (u @ params["wk"].to(u.dtype)).reshape(b, s, h, dh)
    v = (u @ params["wv"].to(u.dtype)).reshape(b, s, h, dh)
    k = k / torch.sqrt(torch.tensor(float(dh))).to(k.dtype)   # f32 sqrt
    gates = u.to(torch.float32) @ params["w_if"] + params["b_if"]
    logi = gates[..., :h]                          # exponential input gate
    logf = F.logsigmoid(gates[..., h:])            # sigmoid forget gate
    return q, k, v, logi, logf


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
    u0 = x @ params["w_up"].to(x.dtype)
    g = x @ params["w_gate"].to(x.dtype)
    u = F.silu(causal_conv1d(u0, params["conv_w"]))
    hseq, (c, n, m) = _mlstm_chunks(*_mlstm_qkv_gates(params, spec, u),
                                    chunk)
    out = (hseq.to(x.dtype) * F.silu(g)) @ params["w_down"].to(x.dtype)
    return out, MlstmState(c, n, m, conv_state_of(u0, spec.conv_width))


def mlstm_chunkwise(params, spec: MlstmSpec, x: torch.Tensor,
                    chunk: int = MLSTM_CHUNK) -> torch.Tensor:
    """Parallel training form: chunks in sequence, quadratic within one.
    S must be at most ``chunk`` or a multiple of it (ValueError
    otherwise, as the reference asserts)."""
    return _mlstm_forward(params, spec, x, chunk)[0]


def mlstm_state_init(batch: int, spec: MlstmSpec, dtype: torch.dtype,
                     device) -> MlstmState:
    h, dh = spec.n_heads, spec.head_dim
    f32 = torch.float32
    return MlstmState(
        c=torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
        n=torch.zeros((batch, h, dh), dtype=f32, device=device),
        m=torch.full((batch, h), -1e30, dtype=f32, device=device),
        conv=conv_state_init(batch, spec.conv_width, spec.d_inner, dtype,
                             device))


def mlstm_decode_step(params, spec: MlstmSpec, x: torch.Tensor,
                      state: MlstmState) -> tuple[torch.Tensor, MlstmState]:
    """x ``[B, 1, d]`` -> ``([B, 1, d], new state)``: the recurrent
    update."""
    b = x.shape[0]
    h, dh = spec.n_heads, spec.head_dim
    f32 = torch.float32
    u0 = x @ params["w_up"].to(x.dtype)
    g = x @ params["w_gate"].to(x.dtype)
    conv_out, conv_new = causal_conv1d_step(u0, state.conv,
                                            params["conv_w"])
    q, k, v, logi, logf = _mlstm_qkv_gates(params, spec, F.silu(conv_out))
    q, k, v = (t[:, 0].to(f32) for t in (q, k, v))          # [B, H, dh]
    li, lf = logi[:, 0], logf[:, 0]                          # [B, H]
    m_new = torch.maximum(lf + state.m, li)
    fp = torch.exp(lf + state.m - m_new)
    ip = torch.exp(li - m_new)
    c_new = fp[..., None, None] * state.c + ip[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", v, k)
    n_new = fp[..., None] * state.n + ip[..., None] * k
    num = torch.einsum("bhde,bhe->bhd", c_new, q)
    qn = torch.abs(torch.einsum("bhd,bhd->bh", q, n_new))
    denom = torch.maximum(qn, torch.exp(-torch.clamp(m_new, -30.0, 30.0)))
    hid = (num / denom[..., None]).reshape(b, 1, h * dh).to(x.dtype)
    out = (hid * F.silu(g)) @ params["w_down"].to(x.dtype)
    return out, MlstmState(c_new, n_new, m_new, conv_new)


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


def slstm_state_init(batch: int, spec: SlstmSpec, device) -> SlstmState:
    d = spec.d_model
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return SlstmState(z, z, z, torch.full((batch, d), -1e30,
                                          dtype=torch.float32,
                                          device=device))


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
    b, s, _ = x.shape
    xp = x.to(torch.float32) @ params["w_x"]
    st = slstm_state_init(b, spec, x.device)
    hs = []
    for i in range(s):
        h, st = _slstm_cell(params, spec, xp[:, i], st)
        hs.append(h)
    hs = rms_norm(torch.stack(hs, dim=1), params["norm"])
    return hs.to(x.dtype) @ params["w_out"].to(x.dtype), st


def slstm_apply(params, spec: SlstmSpec, x: torch.Tensor) -> torch.Tensor:
    """Training form: sequential over time."""
    return _slstm_forward(params, spec, x)[0]


def slstm_decode_step(params, spec: SlstmSpec, x: torch.Tensor,
                      state: SlstmState):
    xt = x[:, 0].to(torch.float32) @ params["w_x"]
    h, st = _slstm_cell(params, spec, xt, state)
    h = rms_norm(h[:, None, :], params["norm"])
    return h.to(x.dtype) @ params["w_out"].to(x.dtype), st


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


def _ssm_inputs(params, spec: SsmSpec, u: torch.Tensor):
    """u ``[B, S, Di]`` post-conv -> (dA ``[B, S, Di, N]``, dBu ``[B, S,
    Di, N]``, C ``[B, S, N]``), float32."""
    uf = u.to(torch.float32)
    bc = uf @ params["w_bc"]
    bmat, cmat = torch.chunk(bc, 2, dim=-1)
    dt = F.softplus(uf @ params["w_dt"] + params["dt_bias"])    # [B, S, Di]
    a = -torch.exp(params["a_log"])                              # [Di, N]
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
    u0 = x @ params["w_in"].to(x.dtype)
    u = F.silu(causal_conv1d(u0, params["conv_w"]))
    da, dbu, cmat = _ssm_inputs(params, spec, u)
    hh = linear_scan(da, dbu, dim=1)                          # [B, S, Di, N]
    y = torch.einsum("bsdn,bsn->bsd", hh, cmat)
    y = y + params["d_skip"] * u.to(torch.float32)
    out = y.to(x.dtype) @ params["w_out"].to(x.dtype)
    return out, SsmState(hh[:, -1], conv_state_of(u0, spec.conv_width))


def ssm_apply(params, spec: SsmSpec, x: torch.Tensor) -> torch.Tensor:
    """Training form: a scan over time."""
    return _ssm_forward(params, spec, x)[0]


def ssm_state_init(batch: int, spec: SsmSpec, dtype: torch.dtype,
                   device) -> SsmState:
    return SsmState(
        h=torch.zeros((batch, spec.d_inner, spec.d_state),
                      dtype=torch.float32, device=device),
        conv=conv_state_init(batch, spec.conv_width, spec.d_inner, dtype,
                             device))


def ssm_decode_step(params, spec: SsmSpec, x: torch.Tensor,
                    state: SsmState) -> tuple[torch.Tensor, SsmState]:
    u0 = x @ params["w_in"].to(x.dtype)
    conv_out, conv_new = causal_conv1d_step(u0, state.conv,
                                            params["conv_w"])
    u = F.silu(conv_out)                                      # [B, 1, Di]
    da, dbu, cmat = _ssm_inputs(params, spec, u)
    h_new = da[:, 0] * state.h + dbu[:, 0]                    # [B, Di, N]
    y = torch.einsum("bdn,bn->bd", h_new, cmat[:, 0])
    y = y + params["d_skip"] * u[:, 0].to(torch.float32)
    out = y[:, None].to(x.dtype) @ params["w_out"].to(x.dtype)
    return out, SsmState(h_new, conv_new)
