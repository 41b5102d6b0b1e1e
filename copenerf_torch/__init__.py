"""copenerf_torch — the PyTorch/CUDA port of copenerf_tpu for NVIDIA Hopper.

The JAX package ``copenerf_tpu`` is the reference this package is held
against; nothing here imports it (or JAX). Entry points run on the CUDA
device unless the caller passes ``device="cpu"``. Hand-written CUDA kernels
live in ``csrc/`` and are built with ``nvcc`` at first use
(``ops/kernels/build.py``); a CUDA tensor reaches its kernel or raises, a CPU
tensor takes the kernel's plain PyTorch version.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
