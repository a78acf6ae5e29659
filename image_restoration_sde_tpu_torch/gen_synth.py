"""Synthetic data for the demo YAMLs (``configs/demo/``), made from a seed:

    python -m image_restoration_sde_tpu_torch.gen_synth dehaze --out D [--n-train 32 --n-val 4 --size 512 --seed 0]
    python -m image_restoration_sde_tpu_torch.gen_synth bokeh --out D [--n-train 24 --n-val 4 --size 256 --seed 0]
    python -m image_restoration_sde_tpu_torch.gen_synth stereo --out D [--n-train 24 --n-val 4
        --train-size 256 --val-size 128 --seed 11]

Counterpart of ``tools/gen_synth_dehaze.py``, ``gen_synth_bokeh.py`` and
``gen_synth_stereo.py``: the same arguments, defaults and trees, and for
the same arguments the same PNG and ``meta.txt`` bytes.

- ``dehaze``: ``{train,val}/{GT,LQ}/im{i:04d}.png``.  GT is structured
  content (coloured gradients, Gaussian blobs, sinusoidal texture), LQ the
  atmospheric-scattering haze ``GT * t + A * (1 - t)`` with a per-image
  transmission t (a mild vertical ramp) and airlight A; the two-stage
  Refusion demo reads it.
- ``bokeh``: ``{train,val}/{src,tgt,alpha}/{i:04d}.png`` and ``meta.txt``
  (``id, src lens, tgt lens, disparity`` in the reference's lens grammar):
  ``src`` sharp, ``tgt`` its background Gaussian-blurred (sigma 8 / the
  target f-number) through a soft foreground matte ``alpha``; the bokeh
  two-stage demo reads it.
- ``stereo``: ``{train,val}/HR/{2i,2i+1}.png``, the left view and the
  right one shifted by 4-16 px, and ``LR_x4/`` their matlab-bicubic 1/4
  downscales (``data.imresize``); the stereo SR demo reads it.

``data/synthetic.py`` writes other, smaller sets for smoke runs and tests.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np

from .data.imresize import imresize


def make_gt(rng: np.random.Generator, size: int) -> np.ndarray:
    """A ``size`` x ``size`` float32 RGB image in [0, 1]: a coloured linear
    gradient, 6-13 Gaussian blobs and three sinusoidal textures."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.zeros((size, size, 3), np.float32)
    for c in range(3):
        a, b, d = rng.uniform(-0.5, 0.5, 3)
        img[..., c] = 0.5 + a * xx + b * yy + d * xx * yy
    for _ in range(rng.integers(6, 14)):
        cx, cy = rng.uniform(0, 1, 2)
        s = rng.uniform(0.03, 0.18)
        amp = rng.uniform(-0.6, 0.6, 3)
        g = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s)))
        img += g[..., None] * amp[None, None]
    for _ in range(3):  # high-frequency content for the compressor's skips
        fx, fy = rng.uniform(4, 40, 2)
        ph = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.02, 0.1)
        img += amp * np.sin(2 * np.pi * (fx * xx + fy * yy) + ph)[..., None]
    return np.clip(img, 0.0, 1.0)


def hazify(rng: np.random.Generator, gt: np.ndarray) -> np.ndarray:
    """``gt`` through the scattering model, transmission t in [0.45, 0.75]
    plus a vertical ramp of +-0.1 (clipped to [0.3, 0.95]), airlight in
    [0.8, 1] a channel."""
    t = rng.uniform(0.45, 0.75)
    airlight = rng.uniform(0.8, 1.0, 3).astype(np.float32)
    size = gt.shape[0]
    ramp = np.linspace(-0.1, 0.1, size, dtype=np.float32)[:, None, None]
    tmap = np.clip(t + ramp, 0.3, 0.95)
    return np.clip(gt * tmap + airlight[None, None] * (1 - tmap), 0.0, 1.0)


def smooth_alpha(rng: np.random.Generator, size: int) -> np.ndarray:
    """A foreground matte in [0, 1]: the union of 1-3 soft blobs."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    a = np.zeros((size, size), np.float32)
    for _ in range(rng.integers(1, 4)):
        cx, cy = rng.uniform(0.2, 0.8, 2)
        s = rng.uniform(0.08, 0.2)
        a = np.maximum(a, np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))))
    return np.clip(a * 1.4, 0.0, 1.0)


def render_bokeh(src: np.ndarray, alpha: np.ndarray, f_number: float) -> np.ndarray:
    """The wide-aperture render: the background blurred with sigma 8 /
    ``f_number``, the foreground kept through ``alpha``."""
    from scipy.ndimage import gaussian_filter

    sigma = 8.0 / max(f_number, 1.0)
    blurred = np.stack([gaussian_filter(src[..., c], sigma) for c in range(3)], -1)
    return alpha[..., None] * src + (1 - alpha[..., None]) * blurred


def _u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)


def _save(img: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray(img).save(path)


def write_dehaze_split(root: str, split: str, n: int, size: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for sub in ("GT", "LQ"):
        os.makedirs(os.path.join(root, split, sub), exist_ok=True)
    for i in range(n):
        gt = make_gt(rng, size)
        lq = hazify(rng, gt)
        for sub, img in (("GT", gt), ("LQ", lq)):
            _save((img * 255).round().astype(np.uint8), os.path.join(root, split, sub, f"im{i:04d}.png"))


def write_dehaze(out: str, n_train: int = 32, n_val: int = 4, size: int = 512, seed: int = 0) -> str:
    """The dehazing tree under ``out`` (train from ``seed``, val from
    ``seed + 1``); returns ``out``."""
    write_dehaze_split(out, "train", n_train, size, seed)
    write_dehaze_split(out, "val", n_val, size, seed + 1)
    return out


def write_bokeh(out: str, n_train: int = 24, n_val: int = 4, size: int = 256, seed: int = 0) -> str:
    """The bokeh tree under ``out``, both splits from one generator;
    returns ``out``."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("val", n_val)):
        root = os.path.join(out, split)
        for d in ("src", "tgt", "alpha"):
            os.makedirs(os.path.join(root, d), exist_ok=True)
        lines = []
        for i in range(n):
            gt = make_gt(rng, size)
            alpha = smooth_alpha(rng, size)
            tgt_f = float(rng.choice([1.8, 2.8, 4.0]))
            tgt = render_bokeh(gt, alpha, tgt_f)
            name = f"{i:04d}"
            for d, img in (("src", gt), ("tgt", tgt)):
                _save(_u8(img), os.path.join(root, d, name + ".png"))
            _save((alpha * 255).round().astype(np.uint8), os.path.join(root, "alpha", name + ".png"))
            lines.append(f"{name}, Sony50mmf16BS, Sony50mmf{tgt_f}BS, 1.0")
        with open(os.path.join(root, "meta.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return out


def write_stereo(out: str, n_train: int = 24, n_val: int = 4, train_size: int = 256, val_size: int = 128,
                 seed: int = 11) -> str:
    """The stereo SR tree under ``out``, both splits from one generator;
    returns ``out``."""
    rng = np.random.default_rng(seed)
    for split, n, size in (("train", n_train, train_size), ("val", n_val, val_size)):
        for d in ("HR", "LR_x4"):
            os.makedirs(os.path.join(out, split, d), exist_ok=True)
        for i in range(n):
            big = make_gt(rng, size + 32)  # extra width for the disparity crop
            disp = int(rng.integers(4, 17))
            for eye, img in enumerate((big[:size, :size], big[:size, disp : disp + size])):
                u8 = _u8(img)
                name = f"{2 * i + eye:04d}.png"
                _save(u8, os.path.join(out, split, "HR", name))
                _save(_u8(imresize(u8.astype(np.float64) / 255, 0.25)), os.path.join(out, split, "LR_x4", name))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="kind", required=True)
    for kind, n_train, size, seed in (("dehaze", 32, 512, 0), ("bokeh", 24, 256, 0), ("stereo", 24, None, 11)):
        p = sub.add_parser(kind)
        p.add_argument("--out", required=True)
        p.add_argument("--n-train", type=int, default=n_train)
        p.add_argument("--n-val", type=int, default=4)
        if size is None:
            p.add_argument("--train-size", type=int, default=256)
            p.add_argument("--val-size", type=int, default=128)
        else:
            p.add_argument("--size", type=int, default=size)
        p.add_argument("--seed", type=int, default=seed)
    args = parser.parse_args(argv)
    if args.kind == "dehaze":
        write_dehaze(args.out, args.n_train, args.n_val, args.size, args.seed)
    elif args.kind == "bokeh":
        write_bokeh(args.out, args.n_train, args.n_val, args.size, args.seed)
    else:
        write_stereo(args.out, args.n_train, args.n_val, args.train_size, args.val_size, args.seed)
    print(f"{args.kind}: wrote {args.n_train} train + {args.n_val} val under {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
