"""Analytic MODEL_FLOPS per (arch x shape) — the "useful compute" term
(port of ``repro.launch.analytic``: the same arithmetic over the port's
``count_params``, ``plan_heads`` and ``pad_experts``).

Standard accounting: 6*N_active*T for training (fwd 2 + bwd 4), 2*N_active*T
forward-only, plus explicit attention terms (causal-halved, window-capped)
that the 6N rule does not cover.  The MODEL_FLOPS / HLO_FLOPs ratio in
§Roofline measures padding + remat + dispatch waste.
"""
from __future__ import annotations

from ..configs.base import ArchConfig
from ..configs.shapes import InputShape


def _param_counts(cfg: ArchConfig) -> dict:
    """Analytic parameter counts (cross-checked against eval_shape in
    tests): total, embedding, active (MoE top-k)."""
    d = cfg.d_model
    v = cfg.padded_vocab
    emb = 2 * v * d                                  # tok_emb + lm_head
    from ..models.transformer import count_params
    total = count_params(cfg)
    if cfg.n_experts:
        # replace total expert weights with the top-k active slice
        from ..models.moe import pad_experts
        e_pad = pad_experts(cfg.n_experts, 16)
        per_expert = 3 * d * cfg.moe_d_ff
        all_experts = e_pad * per_expert * cfg.n_layers
        active_experts = cfg.n_experts_per_tok * per_expert * cfg.n_layers
        active = total - all_experts + active_experts
    else:
        active = total
    return {"total": total, "embedding": emb, "active": active}


def _attn_flops_fwd(cfg: ArchConfig, batch: int, seq: int,
                    kv_len: int | None = None) -> float:
    """Score+value matmul flops across layers (padded heads = real cost)."""
    from ..models.attention import plan_heads
    plan = plan_heads(cfg.n_heads, cfg.n_kv_heads, 16)
    hd = cfg.resolved_head_dim
    total = 0.0
    wins = cfg.layer_windows()
    pattern = cfg.layer_pattern()
    for bt, w in zip(pattern, wins):
        if bt in ("mlstm", "slstm"):
            # mLSTM state math: ~6*B*S*H*dh^2 (intra-chunk + state update)
            if bt == "mlstm":
                di = int(cfg.d_model * cfg.ssm_proj_factor)
                dh = di // cfg.n_heads
                total += 6.0 * batch * seq * cfg.n_heads * dh * dh
            continue
        kv = kv_len if kv_len is not None else seq
        if w:
            kv = min(kv, w)
        elif kv_len is None:
            kv = seq / 2.0  # causal triangle
        total += 4.0 * batch * plan.n_q * seq * kv * hd
    if cfg.family == "vlm":
        # cross-attn layers attend vision tokens
        n_cross = cfg.n_layers // cfg.cross_attn_every
        total += 4.0 * batch * plan.n_q * seq * cfg.vision_tokens * hd \
            * n_cross / max(cfg.n_layers, 1)
    return total


def memory_bytes(cfg: ArchConfig, shape: InputShape, n_chips: int) -> dict:
    """Analytic per-chip HBM traffic per step (the roofline memory term).

    The HLO-text traffic proxy over-counts (CPU fusion != TPU fusion), and
    cost_analysis counts loop bodies once — so the memory term is modeled
    from first principles (documented in EXPERIMENTS.md §Roofline):
      weights   read per pass (fwd / bwd / remat-fwd)
      optimizer m/v read+write + f32 param update   (ZeRO -> /n_chips)
      activations layer-boundary stores + reads (+remat rewrite)
      attention scores materialized by the XLA path (flash removes this
                term on TPU — tracked as a §Perf lever)
      KV cache  full read per decoded token
    """
    from ..models.attention import plan_heads
    from ..models.transformer import count_params
    tp = 16
    dp = max(n_chips // tp, 1)
    bytes_w = 2  # bf16
    N = count_params(cfg)
    w_chip = N * bytes_w / tp / (dp if cfg.fsdp else 1)
    b, s = shape.global_batch, shape.seq_len
    L = cfg.n_layers
    d = cfg.d_model
    plan = plan_heads(cfg.n_heads, cfg.n_kv_heads, tp)
    hd = cfg.resolved_head_dim
    toks_chip = (b * s) / min(dp, b) if shape.kind != "decode" else \
        b / min(dp, b)
    out = {}
    if shape.kind == "train":
        k = max(shape.microbatches, 1)
        # weights: fwd+bwd+remat reads per microbatch + grad write/read
        out["weights"] = w_chip * (3 * k + 2)
        out["optimizer"] = 20.0 * N / n_chips
        out["activations"] = L * toks_chip * d * bytes_w * 8
        scores = 0.0
        for w in cfg.layer_windows():
            if cfg.family in ("ssm",):
                continue
            kv = min(s, w) if w else s / 2
            scores += (plan.n_q / tp) * (toks_chip) * kv * 4 * 3  # f32 fwd+bwd
        out["scores"] = scores
    elif shape.kind == "prefill":
        out["weights"] = w_chip
        out["activations"] = L * toks_chip * d * bytes_w * 3
        scores = 0.0
        for w in cfg.layer_windows():
            if cfg.family in ("ssm",):
                continue
            kv = min(s, w) if w else s / 2
            scores += (plan.n_q / tp) * toks_chip * kv * 4
        out["scores"] = scores
        out["kv_write"] = L * toks_chip * (plan.n_kv / tp) * hd * bytes_w * 2
    else:  # decode
        out["weights"] = w_chip
        batch_chip = max(b / min(dp, b), 1)
        kv_layers = sum(1 for bt in cfg.layer_pattern()
                        if bt in ("attn", "moe", "hymba", "cross"))
        wins = cfg.layer_windows()
        # int8 KV cache (paper technique): 1 byte + f32 scale per vector
        kv_elem = (1.0 + 4.0 / hd) if cfg.kv_cache_bits == 8 else bytes_w
        kv_read = 0.0
        for bt, w in zip(cfg.layer_pattern(), wins):
            if bt not in ("attn", "moe", "hymba"):
                continue
            kv = min(s, w) if w else s
            kv_read += batch_chip * (plan.n_kv / tp) * kv * hd * kv_elem * 2
        out["kv_read"] = kv_read
        out["activations"] = kv_layers * batch_chip * d * bytes_w * 4
    out["total"] = float(sum(out.values()))
    return out


def model_flops(cfg: ArchConfig, shape: InputShape) -> dict:
    counts = _param_counts(cfg)
    n_active = counts["active"] - counts["embedding"] \
        + counts["embedding"] // 2     # lm_head matmul counts, tok_emb not
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = b * s
        flops = 6.0 * n_active * tokens + 3.0 * _attn_flops_fwd(cfg, b, s)
    elif shape.kind == "prefill":
        tokens = b * s
        flops = 2.0 * n_active * tokens + _attn_flops_fwd(cfg, b, s)
    else:  # decode: one token against a seq_len cache
        tokens = b
        flops = 2.0 * n_active * b + _attn_flops_fwd(cfg, b, 1, kv_len=s)
    return {"model_flops": flops, "tokens": tokens, **counts}
