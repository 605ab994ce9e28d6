"""The benchmark of `repro_torch`, the PyTorch and CUDA port of LMSFC:
`Database.query` Count and Range cells on one card (`run.py`), with the
frozen generators (`gen/`), the plain reference (`ref/`), the per-layer
metric readers (`metrics/`) and the kernels' yardstick (`roofline.py`).
It imports neither JAX nor the JAX package."""
