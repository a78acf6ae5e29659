"""Array <-> image conversions for NHWC arrays.

A copy of ``image_restoration_sde_tpu/utils/img_utils.py`` (numpy only);
``tensor2img`` also takes a torch tensor, moved to the host.

Parity: ref ``utils/img_utils.py:136-179`` (tensor2img/img2tensor/save_img),
reworked for NHWC RGB: clamp to [0,1], scale to uint8; 4-D batches render as
a square grid like torchvision.make_grid.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def split_eyes(img: np.ndarray):
    """Stereo image handling: an HWC array with 6 channels (left|right eyes
    concatenated, ref stereo-sr test.py:119 ``SR_img.chunk(2)``) splits into
    ``[("_L", left), ("_R", right)]``; anything else passes through as
    ``[("", img)]``.  Lets metric/save loops be stereo-agnostic."""
    if img.ndim == 3 and img.shape[-1] == 6:
        return [("_L", img[..., :3]), ("_R", img[..., 3:])]
    return [("", img)]


def tensor2img(arr, min_max: Tuple[float, float] = (0.0, 1.0)) -> np.ndarray:
    """NHWC/HWC/HW float array (RGB) -> uint8 HWC (or HW) numpy image."""
    if hasattr(arr, "detach"):  # a torch tensor
        arr = arr.detach().float().cpu().numpy()
    img = np.asarray(arr, dtype=np.float32)
    img = np.clip(img, *min_max)
    img = (img - min_max[0]) / (min_max[1] - min_max[0])
    img = np.squeeze(img)
    if img.ndim == 4:  # batch -> grid
        n, h, w, c = img.shape
        nrow = int(math.sqrt(n))
        ncol = int(math.ceil(n / nrow))
        grid = np.zeros((nrow * h, ncol * w, c), dtype=np.float32)
        for i in range(n):
            r, col = divmod(i, ncol)
            grid[r * h : (r + 1) * h, col * w : (col + 1) * w] = img[i]
        img = grid
    return (img * 255.0).round().astype(np.uint8)


def img2array(img: np.ndarray) -> np.ndarray:
    """uint8 HWC RGB image -> float32 HWC in [0,1]."""
    return img.astype(np.float32) / 255.0
