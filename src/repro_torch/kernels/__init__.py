"""Hand-written CUDA kernels (sources in `repro_torch/csrc/`), each with a
plain-torch twin in its package's `ref.py` and a wrapper in `ops.py`."""
