"""xlstm-125m [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517).

12L d_model=768 4H d_ff=0 (the mLSTM block carries its own 2x up-projection,
so there is no separate FFN) vocab=50304.  sLSTM at layers {1, 7} (the paper
uses a small sLSTM fraction; exact placement unspecified — noted).
Sub-quadratic: runs long_500k with O(1) recurrent state.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm", n_layers=12, d_model=768,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304,
    use_rope=False, slstm_layers=(1, 7), sub_quadratic=True,
    fsdp=False, remat="full", microbatch=2,
    notes="mLSTM chunked (TFLA-style) train path; per-step decode.")
