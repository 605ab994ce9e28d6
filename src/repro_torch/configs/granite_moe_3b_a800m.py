"""granite-moe-3b-a800m [moe] (hf:ibm-granite/granite-3.0-*-base family).

32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 40e top-8.
The assignment lists both '40e top-8' and '32 experts top-8'; we implement
the structured field (40 experts).  vocab 49155 padded to 49408 for the
16-way model axis (padding excluded from MODEL_FLOPS).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, d_head=64, d_ff=512, vocab=49155,
    n_experts=40, moe_top_k=8, moe_d_ff=512,
    mlp_kind="swiglu", fsdp=True, remat="full", microbatch=2)
