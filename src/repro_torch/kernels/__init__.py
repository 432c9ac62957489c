"""Hand-written CUDA kernels for Hopper, one package per TPU kernel of
``repro.kernels``: ``ops.py`` (the wrapper: launches the kernel on a CUDA
tensor, runs the plain version on a CPU tensor), ``ref.py`` (the plain
PyTorch version) and the source in ``repro_torch/csrc/``."""
