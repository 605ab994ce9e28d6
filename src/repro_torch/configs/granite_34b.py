"""granite-34b [dense] — code model, MQA (arXiv:2405.04324).

88L d_model=6144 48H (GQA kv=1 = MQA) d_ff=24576 (4x, non-GLU GELU MLP)
vocab=49152.  Listed as llama-arch; we use RoPE + RMSNorm + GELU MLP (the
4x d_ff implies a non-gated MLP — noted).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense", n_layers=88, d_model=6144,
    n_heads=48, n_kv_heads=1, d_head=128, d_ff=24576, vocab=49152,
    mlp_kind="gelu", fsdp=True, remat="full", microbatch=16)
