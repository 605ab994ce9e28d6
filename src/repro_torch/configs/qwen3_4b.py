"""qwen3-4b [dense] — qk_norm, GQA (hf:Qwen/Qwen3-8B family).

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b", family="dense", n_layers=36, d_model=2560,
    n_heads=32, n_kv_heads=8, d_head=128, d_ff=9728, vocab=151936,
    mlp_kind="swiglu", qk_norm=True, rope_theta=1e6,
    tie_embeddings=True, fsdp=True, remat="full", microbatch=8)
