"""Hand-written CUDA kernels of the port, one package per kernel family:
`csrc/*.cu` (sources, built by `kernels.build`), `ops.py` (the wrappers),
`ref.py` (the plain PyTorch versions)."""
