"""ECORE in PyTorch for one NVIDIA H100: the port of ``src/repro``.

The package mirrors ``repro``'s layout and names.  It imports neither JAX
nor ``repro``.  Every entry point takes ``device=``: the default is
``"cuda"``, and without a GPU the caller must pass ``device="cpu"``, which
runs each kernel's plain PyTorch version instead of the CUDA kernel.
"""
from .device import resolve_device  # noqa: F401
