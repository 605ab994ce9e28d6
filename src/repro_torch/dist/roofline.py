"""MODEL_FLOPS accounting + per-step roofline terms on the H100.

``model_flops(cfg, shape)`` — analytic flops the *model* requires for one
execution of a (arch, shape) cell: dense/MoE-active parameter flops at
2 flops/param/token (x3 with backward), plus the attention score/value
matmuls (causal average for self-attention, full cache length for decode,
encoder/cross terms for enc-dec).  Padding-vocab flops are excluded by
construction (``param_count`` uses the raw vocab) so the ratio against the
counted flops of the step exposes the step's own overhead.  A copy of the
reference's (`repro.dist.roofline`), in the same arithmetic order, so the
two give equal numbers.

``analyze(cost, memory_stats=None)`` — compute / memory / wire time terms
of one step from its counted cost (`hlo_analysis.StepCounter.analyze`, or
`analyze_hlo_text` of HLO text) against the card's ceilings.  The absolute
ceilings matter less than the fact that every PR regresses against the
same ones.
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ArchConfig, ShapeConfig

# one NVIDIA H100 SXM (80GB HBM3, 700 W), from NVIDIA's data sheet: dense
# bf16 tensor-core peak (without sparsity), HBM3 bandwidth, and NVLink's
# 900 GB/s total as 450 GB/s each way
PEAK_FLOPS = 989e12      # flop/s
HBM_BW = 3.35e12         # byte/s
LINK_BW = 450e9          # byte/s


# ---------------------------------------------------------------------------
# MODEL_FLOPS
# ---------------------------------------------------------------------------


def _param_split(cfg: ArchConfig) -> tuple:
    """(encoder_params, rest) — decode runs only the decoder stack."""
    if cfg.family != "encdec":
        return 0, cfg.active_param_count()
    D, dh = cfg.d_model, cfg.head_dim
    attn = D * cfg.n_heads * dh + 2 * D * cfg.n_kv_heads * dh \
        + cfg.n_heads * dh * D
    mlp = (3 if cfg.mlp_kind == "swiglu" else 2) * D * cfg.d_ff
    enc = cfg.enc_layers * (attn + mlp + 2 * D) + D
    return enc, cfg.active_param_count() - enc


def _n_attn_layers(cfg: ArchConfig) -> int:
    if cfg.family == "ssm":
        return 0  # linear-attention (mLSTM/sLSTM) — no quadratic term
    if cfg.family == "hybrid":
        return cfg.n_layers // max(1, cfg.attn_every)
    return cfg.n_layers


def _attn_fwd_flops(cfg: ArchConfig, batch: int, q_len: int, kv_len: int,
                    n_layers: int, causal: bool) -> float:
    """QK^T + AV matmuls: 2 matmuls x 2 flops/MAC per (q, kv) pair."""
    if cfg.window:
        kv_len = min(kv_len, cfg.window)
        causal = False  # window already bounds the averaged kv length
    avg_kv = kv_len / 2 if causal else kv_len
    return 4.0 * batch * cfg.n_heads * cfg.head_dim * q_len * avg_kv * n_layers


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Analytic model flops for one step of the (arch, shape) cell."""
    B, S = shape.global_batch, shape.seq_len
    enc_params, dec_params = _param_split(cfg)
    n_attn = _n_attn_layers(cfg)
    Se = S // cfg.enc_seq_div if cfg.family == "encdec" else 0

    if shape.kind == "train":
        flops = 6.0 * dec_params * B * S + 6.0 * enc_params * B * Se
        flops += 3.0 * _attn_fwd_flops(cfg, B, S, S, n_attn, causal=True)
        if cfg.family == "encdec":
            flops += 3.0 * _attn_fwd_flops(cfg, B, Se, Se, cfg.enc_layers,
                                           causal=False)      # encoder self
            flops += 3.0 * _attn_fwd_flops(cfg, B, S, Se, cfg.n_layers,
                                           causal=False)      # cross
        return flops

    if shape.kind == "prefill":
        flops = 2.0 * dec_params * B * S + 2.0 * enc_params * B * Se
        flops += _attn_fwd_flops(cfg, B, S, S, n_attn, causal=True)
        if cfg.family == "encdec":
            flops += _attn_fwd_flops(cfg, B, Se, Se, cfg.enc_layers,
                                     causal=False)
            flops += _attn_fwd_flops(cfg, B, S, Se, cfg.n_layers,
                                     causal=False)
        return flops

    # decode: one token per sequence against a seq_len-sized cache
    flops = 2.0 * dec_params * B
    flops += _attn_fwd_flops(cfg, B, 1, S, n_attn, causal=False)
    if cfg.family == "encdec":
        flops += _attn_fwd_flops(cfg, B, 1, Se, cfg.n_layers, causal=False)
    return flops


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str                  # compute | memory | collective
    collectives: dict
    memory_stats: dict

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def analyze(cost: dict, memory_stats: dict = None) -> Roofline:
    """Roofline terms of one counted step (per device).  `cost` is the
    dict `StepCounter.analyze` (or `analyze_hlo_text`) returns;
    `memory_stats` carries ``argument_size_in_bytes`` (params, optimizer
    state, batch, decode state), ``output_size_in_bytes`` and
    ``temp_size_in_bytes`` (the step's peak of live storage less its
    arguments)."""
    flops = float(cost["flops"])
    nbytes = float(cost["bytes"])
    wire = float(cost["wire_bytes"])
    terms = {"compute": flops / PEAK_FLOPS,
             "memory": nbytes / HBM_BW,
             "collective": wire / LINK_BW}
    stats = dict(memory_stats or {})
    stats["bytes_unfused_upper_bound"] = float(cost["bytes_unfused"])
    return Roofline(
        flops_per_device=flops,
        bytes_per_device=nbytes,
        wire_bytes_per_device=wire,
        compute_s=terms["compute"],
        memory_s=terms["memory"],
        collective_s=terms["collective"],
        dominant=max(terms, key=terms.get),
        collectives=cost["collectives"],
        memory_stats=stats,
    )
