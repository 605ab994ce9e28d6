"""seamless-m4t-medium [audio] — enc-dec multimodal (arXiv:2308.11596).

12L encoder + 12L decoder, d_model=1024 16H (MHA kv=16) d_ff=4096
vocab=256206 (padded to 256256).  The audio frontend is a STUB:
input_specs() supplies precomputed frame embeddings (B, S/4, D).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec", n_layers=12, d_model=1024,
    n_heads=16, n_kv_heads=16, d_head=64, d_ff=4096, vocab=256206,
    enc_layers=12, enc_seq_div=4, mlp_kind="gelu",
    fsdp=False, remat="full", microbatch=2)
