"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution (arXiv:2409.12191).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.  Backbone only:
the vision frontend is a STUB (input_specs() provides 1024 precomputed
patch embeddings merged into the prefix) with M-RoPE (t,h,w) position ids
supplied as input; sections (16, 24, 24) of the 64 rotary frequencies.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_head=128, d_ff=29568, vocab=152064,
    mrope_sections=(16, 24, 24), n_image_tokens=1024,
    mlp_kind="swiglu", rope_theta=1e6, fsdp=True, remat="full",
    microbatch=16)
