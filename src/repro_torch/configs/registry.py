"""Architecture registry: --arch <id> resolution + reduced smoke configs."""
from __future__ import annotations

import dataclasses

from .base import ArchConfig
from .granite_34b import CONFIG as granite_34b
from .granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from .minitron_8b import CONFIG as minitron_8b
from .mixtral_8x22b import CONFIG as mixtral_8x22b
from .qwen2_vl_72b import CONFIG as qwen2_vl_72b
from .qwen3_4b import CONFIG as qwen3_4b
from .seamless_m4t_medium import CONFIG as seamless_m4t_medium
from .xlstm_125m import CONFIG as xlstm_125m
from .yi_6b import CONFIG as yi_6b
from .zamba2_1_2b import CONFIG as zamba2_1_2b

ARCHS = {c.name: c for c in [
    xlstm_125m, qwen3_4b, granite_34b, minitron_8b, yi_6b, mixtral_8x22b,
    granite_moe_3b_a800m, zamba2_1_2b, seamless_m4t_medium, qwen2_vl_72b,
]}


def get_arch(name: str) -> ArchConfig:
    return ARCHS[name]


def reduced_config(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    r = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family != "hybrid" else 5),
        d_model=128, d_ff=256 if cfg.d_ff else 0, vocab=512,
        n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads > 1 else 1,
        d_head=32, attn_chunk=64, fsdp=False, microbatch=1, remat="none",
        window=min(cfg.window, 48) if cfg.window else 0,
    )
    if cfg.family == "moe":
        r.update(n_experts=min(cfg.n_experts, 8),
                 moe_top_k=min(cfg.moe_top_k, 2), moe_d_ff=128)
    if cfg.family in ("ssm", "hybrid"):
        r.update(ssm_state=16, ssm_headdim=32)
    if cfg.family == "ssm":
        r.update(slstm_layers=(1,), d_head=None)
    if cfg.family == "hybrid":
        r.update(attn_every=2)
    if cfg.family == "encdec":
        r.update(enc_layers=2)
    if cfg.family == "vlm":
        r.update(n_image_tokens=8)
    return dataclasses.replace(cfg, **r)
