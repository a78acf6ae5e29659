"""On-the-fly degradation synthesis used by the task runners.

Counterpart of ``image_restoration_sde_tpu/utils/degradations.py``.  Parity:
ref ``utils/deg_utils.py`` —

- ``add_noise`` (denoising task, deg_utils.py:13-15), drawn from a
  ``torch.Generator``
- ``mask_to``   (inpainting: random or fixed mask from a mask bank,
  masked area filled with 1.0, deg_utils.py:19-34), numpy
- ``upscale``   (SR bicubic pre-upsampling so the SDE runs at GT
  resolution, deg_utils.py:38-40; torch-bicubic kernel parity), numpy

All functions are NHWC.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from ..data.imresize import torch_bicubic_resize
from ..sde.rng import draw_rows


def add_noise(x: torch.Tensor, gen: torch.Generator, sigma: float) -> torch.Tensor:
    """``x`` plus Gaussian noise of std ``sigma`` (> 1: on the 0..255 scale)."""
    sigma = sigma / 255.0 if sigma > 1 else sigma
    return x + torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device) * sigma


@lru_cache(maxsize=8)
def _load_mask_bank(mask_root: str, n: int = 100) -> np.ndarray:
    """Load the 100-PNG mask bank as float (n, H, W, 1)."""
    from ..data.io_utils import read_img

    masks = []
    for i in range(n):
        path = os.path.join(mask_root, f"{i:06d}.png")
        if not os.path.exists(path):
            break
        m = read_img(path)
        masks.append(m[:, :, :1])
    if not masks:
        raise FileNotFoundError(f"no masks found under {mask_root}")
    return np.stack(masks)


def _nearest_resize(mask: np.ndarray, hw) -> np.ndarray:
    H, W = hw
    h, w = mask.shape[:2]
    ri = (np.arange(H) * h // H).clip(0, h - 1)
    ci = (np.arange(W) * w // W).clip(0, w - 1)
    return mask[np.ix_(ri, ci)]


def mask_to(
    x: np.ndarray,
    mask_root: str,
    mask_id: int = -1,
    n: int = 100,
    rng: Optional[np.random.Generator] = None,
    shard: Optional[tuple] = None,
) -> np.ndarray:
    """Apply inpainting masks: keep masked-in pixels, fill the rest with 1.0.

    ``mask_id < 0`` draws a random mask per batch element; with ``shard =
    (rank, world)`` (``x`` rank's rows of a global batch) the draws are the
    global batch's, of which these rows' are kept.
    """
    x = np.asarray(x)
    batch = x.shape[0]
    bank = _load_mask_bank(mask_root, n)
    avail = len(bank)
    if mask_id < 0:
        rng = rng or np.random.default_rng()
        rows, drawn = draw_rows(batch, shard)
        ids = rng.integers(0, min(n, avail), size=drawn)[rows]
    else:
        ids = np.full(batch, mask_id % avail)
    out = np.empty_like(x)
    for i in range(batch):
        m = _nearest_resize(bank[ids[i]], x.shape[1:3])
        out[i] = m * x[i] + (1.0 - m)
    return out


def upscale(x: np.ndarray, scale: int = 4) -> np.ndarray:
    """Bicubic pre-upsample, NHWC batch (torch F.interpolate parity)."""
    return np.stack([torch_bicubic_resize(im, float(scale)) for im in np.asarray(x)])
