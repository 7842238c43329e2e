"""repro_torch: the PyTorch and CUDA port of ``repro`` for one NVIDIA H100.

The package keeps ``repro``'s module names and public layouts so that each
ported function can be held against its JAX counterpart. It imports torch
and numpy only, never JAX and nothing of ``repro``."""
__version__ = "0.1.0"
