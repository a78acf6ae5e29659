"""PyTorch and CUDA port of ``image_restoration_sde_tpu`` for NVIDIA Hopper.

Imports torch and numpy only.  The hand-written CUDA kernels build at their
first launch (``kernels``), never at import.
"""

from . import models, ops, sampling, sde, tiling, training

__all__ = ["models", "ops", "sampling", "sde", "tiling", "training"]
