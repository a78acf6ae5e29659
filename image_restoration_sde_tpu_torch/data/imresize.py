"""Separable cubic resampling with matlab-imresize and torch-interpolate
semantics (numpy, host-side data pipeline).

A copy of ``image_restoration_sde_tpu/data/imresize.py``: the native C++
resampler (``data/native.py``) wherever ``g++`` is found, which raises if
it cannot build or run; the numpy weights only where no ``g++`` exists.

One weight machinery covers both resamplers the reference relies on:

- matlab ``imresize`` (ref data/util.py:240-387): Keys cubic a=-0.5,
  antialiasing when downscaling, symmetric boundary.  Used for on-the-fly
  LR synthesis in LQGTDataset (data/LQGT_dataset.py:128).
- torch ``F.interpolate(mode='bicubic')`` (ref utils/deg_utils.py:38-40):
  Keys cubic a=-0.75, no antialias, replicate boundary,
  align_corners=False.  Used for SR pre-upsampling in the sisr/stereo-sr
  drivers.

Both use the same source mapping u = (x + 0.5)/scale - 0.5 (0-based).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from . import native


def _cubic(x: np.ndarray, a: float) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w = np.where(
        ax <= 1,
        (a + 2) * ax3 - (a + 3) * ax2 + 1,
        np.where(ax < 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0),
    )
    return w


def _contributions(
    in_len: int, out_len: int, scale: float, a: float, antialias: bool, boundary: str
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-pixel (weights, source indices)."""
    kernel_width = 4.0
    use_aa = antialias and scale < 1
    kw = kernel_width / scale if use_aa else kernel_width

    x = np.arange(out_len, dtype=np.float64)
    u = (x + 0.5) / scale - 0.5
    left = np.floor(u - kw / 2).astype(np.int64)
    P = int(math.ceil(kw)) + 2
    indices = left[:, None] + np.arange(P)[None, :]
    dist = u[:, None] - indices
    if use_aa:
        weights = scale * _cubic(dist * scale, a)
    else:
        weights = _cubic(dist, a)
    weights /= weights.sum(axis=1, keepdims=True)

    if boundary == "symmetric":
        # matlab's mirror: aux = [0..n-1, n-1..0], idx -> aux[mod(idx, 2n)]
        aux = np.concatenate([np.arange(in_len), np.arange(in_len - 1, -1, -1)])
        indices = aux[np.mod(indices, 2 * in_len)]
    elif boundary == "replicate":
        indices = np.clip(indices, 0, in_len - 1)
    else:
        raise ValueError(boundary)

    # drop all-zero columns (matlab parity)
    nz = ~np.all(weights == 0, axis=0)
    return weights[:, nz], indices[:, nz]


def _resize_axis(img: np.ndarray, out_len: int, scale: float, axis: int,
                 a: float, antialias: bool, boundary: str) -> np.ndarray:
    weights, indices = _contributions(img.shape[axis], out_len, scale, a, antialias, boundary)
    moved = np.moveaxis(img, axis, 0).astype(np.float64)
    gathered = moved[indices]  # (out_len, P, ...)
    out = np.einsum("op,op...->o...", weights, gathered)
    return np.moveaxis(out, 0, axis)


def _resize(img: np.ndarray, scale_or_shape, a: float, antialias: bool, boundary: str) -> np.ndarray:
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    H, W = img.shape[:2]
    if isinstance(scale_or_shape, (tuple, list)):
        out_h, out_w = scale_or_shape
        sh, sw = out_h / H, out_w / W
    else:
        s = float(scale_or_shape)
        out_h, out_w = int(math.ceil(H * s)), int(math.ceil(W * s))
        sh = sw = s
    if native.available():
        out = native.resize_cubic_native(img, (out_h, out_w), (sh, sw), a, antialias, boundary)
        return out[:, :, 0] if squeeze else out
    out = _resize_axis(img, out_h, sh, 0, a, antialias, boundary)
    out = _resize_axis(out, out_w, sw, 1, a, antialias, boundary)
    out = out.astype(np.float32)
    return out[:, :, 0] if squeeze else out


def imresize(img: np.ndarray, scale_or_shape, antialias: bool = True) -> np.ndarray:
    """matlab-faithful bicubic imresize on HWC (or HW) float arrays."""
    return _resize(img, scale_or_shape, a=-0.5, antialias=antialias, boundary="symmetric")


def torch_bicubic_resize(img: np.ndarray, scale_or_shape) -> np.ndarray:
    """torch ``F.interpolate(mode='bicubic', align_corners=False)`` parity."""
    return _resize(img, scale_or_shape, a=-0.75, antialias=False, boundary="replicate")
