"""mixtral-8x22b [moe] — 8 experts top-2, SWA (arXiv:2401.04088).

56L d_model=6144 48H (GQA kv=8) d_ff=16384/expert vocab=32768, MoE 8e top-2.
Sliding window 4096 per the assignment spec.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144,
    n_heads=48, n_kv_heads=8, d_head=128, d_ff=16384, vocab=32768,
    n_experts=8, moe_top_k=2, moe_d_ff=16384, window=4096,
    mlp_kind="swiglu", rope_theta=1e6, fsdp=True, remat="full",
    microbatch=16)
