"""minitron-8b [dense] — pruned nemotron (arXiv:2407.14679).

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
Nemotron-style squared-ReLU non-gated MLP.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_head=128, d_ff=16384, vocab=256000,
    mlp_kind="relu2", fsdp=True, remat="full", microbatch=4)
