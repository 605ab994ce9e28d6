"""PyTorch/CUDA port of the LMSFC index (`repro`), module for module.

Layout mirrors `repro`: `core/` (curves, index build, CPU engine, device
serving), `kernels/<name>/` (`ref.py` plain torch, `ops.py` the wrapper that
launches the hand-written CUDA kernel from `csrc/`), and `data/`.  The index
build stays numpy on the host; device entry points run on CUDA unless the
caller passes ``device="cpu"`` or hands in CPU tensors.
"""
