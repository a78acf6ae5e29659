"""Procedural inpainting mask bank, made from a seed:

    python -m image_restoration_sde_tpu_torch.gen_masks [--out datasets/gt_keep_masks] [--seed 0] [-n 100]

Counterpart of ``tools/gen_masks.py``: the same seven families, file names
and, for the same arguments, the same PNG bytes.  The reference ships 708
mask PNGs under ``gt_keep_masks/{thin,thick,ex64,genhalf,face,ev2li,nn2}/``
(white = keep, black = inpaint), which every inpainting YAML names as
``degradation.mask_root``; here they are generated:

- ``ev2li``   keep every 2nd (odd) row                -- n identical masks
- ``nn2``     keep odd rows AND odd cols (1/4 pixels) -- n identical masks
- ``genhalf`` keep the left half                      -- n identical masks
- ``ex64``    keep the centred 64x64 block            -- n identical masks
- ``thin``    random narrow brush strokes removed     -- n random masks
- ``thick``   random wide brush strokes removed       -- n random masks
- ``face``    one irregular blob over the lower-centre (face) region -- 8 masks

All are SIZE x SIZE RGB.  ``data/synthetic.write_masks`` writes another,
smaller bank for smoke runs.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
from PIL import Image, ImageDraw

SIZE = 256


def _save(mask: np.ndarray, path: str) -> None:
    """mask: bool (H, W), True = keep -> white RGB png (matches the bank)."""
    img = np.repeat((mask.astype(np.uint8) * 255)[:, :, None], 3, axis=2)
    Image.fromarray(img).save(path)


def ev2li_mask() -> np.ndarray:
    m = np.zeros((SIZE, SIZE), bool)
    m[1::2, :] = True
    return m


def nn2_mask() -> np.ndarray:
    m = np.zeros((SIZE, SIZE), bool)
    m[1::2, 1::2] = True
    return m


def genhalf_mask() -> np.ndarray:
    m = np.zeros((SIZE, SIZE), bool)
    m[:, : SIZE // 2] = True
    return m


def ex64_mask() -> np.ndarray:
    m = np.zeros((SIZE, SIZE), bool)
    lo, hi = (SIZE - 64) // 2, (SIZE + 64) // 2
    m[lo:hi, lo:hi] = True
    return m


def _brush_strokes(rng: np.random.Generator, width_lo: int, width_hi: int,
                   n_strokes_hi: int) -> np.ndarray:
    """DeepFill-v2-style random brush strokes; returns the REMOVED region."""
    img = Image.new("L", (SIZE, SIZE), 0)
    draw = ImageDraw.Draw(img)
    for _ in range(rng.integers(1, n_strokes_hi + 1)):
        w = int(rng.integers(width_lo, width_hi + 1))
        x, y = rng.uniform(0, SIZE, 2)
        n_vertex = int(rng.integers(8, 25))
        angle = rng.uniform(0, 2 * np.pi)
        for _ in range(n_vertex):
            angle += rng.uniform(-0.8, 0.8)
            step = rng.uniform(10, 40)
            nx = float(np.clip(x + step * np.cos(angle), 0, SIZE - 1))
            ny = float(np.clip(y + step * np.sin(angle), 0, SIZE - 1))
            draw.line([(x, y), (nx, ny)], fill=255, width=w)
            draw.ellipse([nx - w / 2, ny - w / 2, nx + w / 2, ny + w / 2], fill=255)
            x, y = nx, ny
    return np.asarray(img) > 127


def stroke_mask(rng: np.random.Generator, kind: str) -> np.ndarray:
    if kind == "thin":
        removed = _brush_strokes(rng, width_lo=6, width_hi=16, n_strokes_hi=12)
    else:  # thick
        removed = _brush_strokes(rng, width_lo=20, width_hi=48, n_strokes_hi=4)
    return ~removed


def face_mask(rng: np.random.Generator) -> np.ndarray:
    """Irregular keep-out blob over the lower-center region (the reference's
    8 face masks remove roughly rows 92-252, cols 19-196)."""
    img = Image.new("L", (SIZE, SIZE), 0)
    draw = ImageDraw.Draw(img)
    cx = 108 + rng.uniform(-15, 15)
    cy = 172 + rng.uniform(-15, 15)
    # wobbly polygon approximating an ellipse
    n = 24
    pts = []
    for i in range(n):
        a = 2 * np.pi * i / n
        rx = 88 * (1 + rng.uniform(-0.18, 0.18))
        ry = 80 * (1 + rng.uniform(-0.18, 0.18))
        pts.append((cx + rx * np.cos(a), cy + ry * np.sin(a)))
    draw.polygon(pts, fill=255)
    return ~(np.asarray(img) > 127)


def generate(out_root: str, seed: int = 0, n: int = 100) -> None:
    fixed = {
        "ev2li": ev2li_mask,
        "nn2": nn2_mask,
        "genhalf": genhalf_mask,
        "ex64": ex64_mask,
    }
    for kind, fn in fixed.items():
        d = os.path.join(out_root, kind)
        os.makedirs(d, exist_ok=True)
        m = fn()
        for i in range(n):
            _save(m, os.path.join(d, f"{i:06d}.png"))
    for kind in ("thin", "thick"):
        d = os.path.join(out_root, kind)
        os.makedirs(d, exist_ok=True)
        rng = np.random.default_rng(seed + (1 if kind == "thin" else 2))
        for i in range(n):
            _save(stroke_mask(rng, kind), os.path.join(d, f"{i:06d}.png"))
    d = os.path.join(out_root, "face")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed + 3)
    for i in range(8):
        _save(face_mask(rng), os.path.join(d, f"{i:06d}.png"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="datasets/gt_keep_masks")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-n", type=int, default=100)
    args = p.parse_args(argv)
    generate(args.out, args.seed, args.n)
    print(f"wrote mask bank under {os.path.abspath(args.out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
