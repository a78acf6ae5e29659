"""Synthetic image folders, made from a seed: for smoke runs and tests of
the training paths where no dataset is at hand.  uint8 RGB PNGs, sizes
drawn between ``min_size`` and ``max_size``; the clean images are smooth
random colour fields with edges.

- :func:`write_pairs`: ``<root>/GT/*.png`` and ``<root>/LQ/*.png`` (the same
  images with bright rain-like streaks and noise), what the LQGT and GT
  datasets read; 1024-1280 px pairs feed the latent tasks' 1024 px crops.
- :func:`write_bokeh`: ``<root>/{src,tgt,alpha}/*.png`` and
  ``<root>/meta.txt`` (``id, src lens, tgt lens, disparity`` in the
  reference's lens grammar), what the Bokeh datasets read.
- :func:`write_stereo`: ``<root>/HR/*.png`` (files 2i and 2i+1: the left
  and right views of pair i, the right one shifted by a random disparity)
  and ``<root>/LR_x{scale}/*.png`` (their matlab-bicubic downscales), what
  the stereo datasets read.
- :func:`write_masks`: ``<root>/{i:06d}.png``, an inpainting mask bank
  (white keeps a pixel, black strokes are the holes), what
  ``degradation.mask_root`` names.
"""

from __future__ import annotations

import os

import numpy as np

from .imresize import imresize
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


def write_pairs(root: str, n: int, seed: int, min_size: int = 128, max_size: int = 256, shape=None) -> str:
    """Write ``n`` GT/LQ pairs under ``root``, each side drawn between
    ``min_size`` and ``max_size`` unless ``shape`` (H, W) fixes both;
    returns ``root``."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = (int(v) for v in rng.integers(min_size, max_size + 1, 2))
        if shape is not None:
            h, w = shape
        gt = _clean(rng, h, w)
        lq = _rain(rng, gt)
        for sub, img in (("GT", gt), ("LQ", lq)):
            save_img((img * 255).round().astype(np.uint8), os.path.join(root, sub, f"{i:04d}.png"))
    return root


def _u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)


def _box_blur(img: np.ndarray, r: int) -> np.ndarray:
    """Separable (2r+1)-tap box blur of HWC, edges replicated."""
    for axis in (0, 1):
        pad = [(r + 1, r) if a == axis else (0, 0) for a in range(img.ndim)]
        c = np.cumsum(np.pad(img, pad, mode="edge"), axis=axis, dtype=np.float64)
        hi = np.take(c, np.arange(2 * r + 1, c.shape[axis]), axis=axis)
        lo = np.take(c, np.arange(0, c.shape[axis] - 2 * r - 1), axis=axis)
        img = ((hi - lo) / (2 * r + 1)).astype(np.float32)
    return img


def write_bokeh(root: str, n: int, seed: int, min_size: int = 256, max_size: int = 320) -> str:
    """Write ``n`` bokeh triplets and their ``meta.txt`` under ``root``:
    ``src`` sharp (f/16), ``tgt`` its background blurred through a soft
    foreground matte (``alpha``, a union of Gaussian blobs) with a radius
    that grows as the target f-number falls; returns ``root``."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(min_size, max_size + 1, 2))
        src = _clean(rng, h, w)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        alpha = np.zeros((h, w), np.float32)
        for _ in range(int(rng.integers(1, 4))):
            cy, cx, sd = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w, rng.uniform(0.08, 0.2) * min(h, w)
            alpha = np.maximum(alpha, np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sd * sd)))
        alpha = np.clip(alpha * 1.4, 0, 1)
        f_number = float(rng.choice([1.8, 2.8, 4.0]))
        tgt = alpha[..., None] * src + (1 - alpha[..., None]) * _box_blur(src, int(round(16 / f_number)))
        name = f"{i:04d}"
        for sub, img in (("src", src), ("tgt", tgt), ("alpha", alpha)):
            save_img(_u8(img), os.path.join(root, sub, f"{name}.png"))
        lines.append(f"{name}, Sony50mmf16BS, Sony50mmf{f_number}BS, {rng.uniform(0, 1):.2f}")
    with open(os.path.join(root, "meta.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return root


def write_stereo(root: str, n: int, seed: int, min_size: int = 128, max_size: int = 160, scale: int = 4) -> str:
    """Write ``n`` stereo pairs under ``root``: ``HR/{2i,2i+1}.png`` the
    left view and the right one (the same scene shifted by 4-16 px), sides
    multiples of ``scale``, and ``LR_x{scale}/`` their 1/scale matlab
    bicubic downscales; returns ``root``."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = (scale * int(v) for v in rng.integers(min_size // scale, max_size // scale + 1, 2))
        disp = int(rng.integers(4, 17))
        scene = _clean(rng, h, w + disp)
        for eye, view in enumerate((scene[:, :w], scene[:, disp : disp + w])):
            hr = _u8(view)
            name = f"{2 * i + eye:04d}.png"
            save_img(hr, os.path.join(root, "HR", name))
            save_img(_u8(imresize(hr.astype(np.float64) / 255, 1 / scale)), os.path.join(root, f"LR_x{scale}", name))
    return root


def write_masks(root: str, n: int, seed: int, size: int = 256) -> str:
    """Write ``n`` square inpainting masks of side ``size`` under ``root``:
    white, with 4-8 random black strokes 2-8% of the side wide; returns
    ``root``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for i in range(n):
        keep = np.ones((size, size), bool)
        for _ in range(int(rng.integers(4, 9))):
            (y0, x0), (y1, x1) = rng.uniform(0, size, (2, 2))
            width = rng.uniform(0.02, 0.08) * size
            # distance of each pixel to the segment (y0, x0)-(y1, x1)
            dy, dx = y1 - y0, x1 - x0
            t = np.clip(((yy - y0) * dy + (xx - x0) * dx) / max(dy * dy + dx * dx, 1e-6), 0, 1)
            keep &= np.hypot(yy - y0 - t * dy, xx - x0 - t * dx) > width / 2
        save_img(np.repeat(keep[..., None], 3, axis=2).astype(np.uint8) * 255, os.path.join(root, f"{i:06d}.png"))
    return root
