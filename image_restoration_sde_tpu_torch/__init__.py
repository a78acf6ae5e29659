"""PyTorch and CUDA port of ``image_restoration_sde_tpu`` for NVIDIA Hopper.

Imports torch, numpy, scipy and PyYAML, never JAX.  The hand-written CUDA
kernels build at their first launch (``kernels``), never at import.  The
entry points run a YAML's task: ``python -m image_restoration_sde_tpu_torch.
train`` (pixel, compressor and latent tasks), ``.test`` (metrics over the
test sets), ``.inference`` (outputs only) and ``.restore`` (one image).
"""

from . import models, ops, sampling, sde, tiling, training

__all__ = ["models", "ops", "sampling", "sde", "tiling", "training"]
