"""Image interpolation demo of the PyTorch port: morph a source image into
a target by the forward mean-reverting SDE with the target as its mean.

    python -m image_restoration_sde_tpu_torch.interpolation -s src.png -t tgt.png
        [--save DIR] [--sigma 1.0] [-T 100] [--schedule cosine] [--seed 0] [--device cuda|cpu]

Counterpart of ``tools/interpolation.py`` (ref
``codes/demos/interpolation.py:9-49``): ``sde.samplers.forward_sde`` from
the source, t = 1..T, its noise from a generator seeded with ``--seed``
(or an injected ``noise_seq``), every state written as
``state_<t>.png``.  It runs on the card unless ``--device cpu`` is given;
without a card it raises.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .data.io_utils import read_img, save_img
from .runners import resolve_device
from .sde import IRSDE, rng, samplers
from .utils.img_utils import tensor2img


def interpolate(src: np.ndarray, tgt: np.ndarray, sigma: float = 1.0, T: int = 100, schedule: str = "cosine",
                seed: int = 0, device="cuda", noise_seq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The T states (T, H, W, C) of the forward SDE from ``src`` towards
    ``tgt`` (HWC float32 in [0, 1], the same shape), on ``device``."""
    if src.shape != tgt.shape:
        raise ValueError(f"source {src.shape} and target {tgt.shape} must match")
    device = resolve_device(str(device))
    sde = IRSDE.create(max_sigma=sigma, T=T, schedule=schedule, eps=0.01, device=device)
    x0, mu = (torch.as_tensor(np.asarray(a, np.float32), device=device)[None] for a in (src, tgt))
    gen = None if noise_seq is not None else rng.generator(seed, device)
    _, states = samplers.forward_sde(sde, x0, mu, gen, return_all=True, noise_seq=noise_seq)
    return states[:, 0]


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-s", "--source", required=True)
    parser.add_argument("-t", "--target", required=True)
    parser.add_argument("--save", default="interpolation_states")
    parser.add_argument("--sigma", type=float, default=1.0)
    parser.add_argument("-T", type=int, default=100)
    parser.add_argument("--schedule", default="cosine")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    states = interpolate(read_img(args.source), read_img(args.target), args.sigma, args.T, args.schedule,
                         args.seed, args.device).cpu().numpy()
    os.makedirs(args.save, exist_ok=True)
    for t, state in enumerate(states, 1):
        save_img(tensor2img(state), os.path.join(args.save, f"state_{t}.png"))
    print(f"saved {len(states)} states to {args.save}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
