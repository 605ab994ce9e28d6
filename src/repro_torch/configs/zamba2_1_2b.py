"""zamba2-1.2b [hybrid] — Mamba2 + shared attention blocks (arXiv:2411.15242).

38L d_model=2048; shared attn block (32H MHA kv=32, d_ff=8192) applied every
6 mamba2 layers (6 applications, shared weights); ssm_state=64 vocab=32000.
Sub-quadratic: runs long_500k (decode cost linear in cached length; mamba
state O(1)).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, d_head=64, d_ff=8192, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_conv=4, attn_every=6,
    mlp_kind="swiglu", sub_quadratic=True, fsdp=True, remat="full",
    microbatch=4)
