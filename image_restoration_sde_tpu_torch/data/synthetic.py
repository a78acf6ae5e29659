"""Synthetic paired image folders, made from a seed: for smoke runs and
tests of the training path where no dataset is at hand.

:func:`write_pairs` writes ``<root>/GT/*.png`` (smooth random colour fields
with edges) and ``<root>/LQ/*.png`` (the same images with bright rain-like
streaks and noise), uint8 RGB, sizes drawn between ``min_size`` and
``max_size``.
"""

from __future__ import annotations

import os

import numpy as np

from .io_utils import save_img


def _clean(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        fy, fx, ph = rng.uniform(0.01, 0.08), rng.uniform(0.01, 0.08), rng.uniform(0, 2 * np.pi)
        img[..., c] = 0.5 + 0.3 * np.sin(fy * yy + ph) * np.cos(fx * xx)
    for _ in range(3):  # a few flat rectangles: edges
        y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
        dy, dx = rng.integers(h // 8, h // 2), rng.integers(w // 8, w // 2)
        img[y0 : y0 + dy, x0 : x0 + dx] = rng.uniform(0, 1, 3)
    return img


def _rain(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    h, w, _ = img.shape
    streaks = np.zeros((h, w), np.float32)
    for _ in range(max(1, h * w // 400)):
        y, x, length = rng.integers(0, h), rng.integers(0, w), rng.integers(4, 16)
        ys = np.clip(y + np.arange(length), 0, h - 1)
        xs = np.clip(x + np.arange(length) // 3, 0, w - 1)
        streaks[ys, xs] = rng.uniform(0.3, 0.8)
    noisy = img + streaks[..., None] + rng.normal(0, 0.02, img.shape).astype(np.float32)
    return np.clip(noisy, 0, 1)


def write_pairs(root: str, n: int, seed: int, min_size: int = 128, max_size: int = 256) -> str:
    """Write ``n`` GT/LQ pairs under ``root``; returns ``root``."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = (int(v) for v in rng.integers(min_size, max_size + 1, 2))
        gt = _clean(rng, h, w)
        lq = _rain(rng, gt)
        for sub, img in (("GT", gt), ("LQ", lq)):
            save_img((img * 255).round().astype(np.uint8), os.path.join(root, sub, f"{i:04d}.png"))
    return root
