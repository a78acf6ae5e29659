"""PyTorch and CUDA port of ``image_restoration_sde_tpu`` for NVIDIA Hopper.

Imports torch, numpy, scipy and PyYAML, never JAX.  The hand-written CUDA
kernels build at their first launch (``kernels``), never at import.  The
train entry point (pixel, compressor and latent tasks) is
``python -m image_restoration_sde_tpu_torch.train``.
"""

from . import models, ops, sampling, sde, tiling, training

__all__ = ["models", "ops", "sampling", "sde", "tiling", "training"]
