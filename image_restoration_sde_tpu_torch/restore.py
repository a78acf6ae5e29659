"""Single-image restoration entry point of the PyTorch port:

    python -m image_restoration_sde_tpu_torch.restore -opt=<test yml> -i in.png -o out.png
        [--tile N --tile-overlap M] [--seed S] [--device cuda|cpu]

Counterpart of ``tools/restore.py``: the test YAML's task runner and
weights (``path.pretrain_model_G``, a latent task's ``pretrain_model_L``),
one image restored, whole (``infer``) or, with ``--tile``, by overlapping
tiles through the task's ``sample_batch`` (``tiling.tiled_restore``), its
noise from ``--seed``, written as a PNG.

It runs on the card unless ``--device cpu`` is given; without a card it
raises.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import numpy as np

from .data.io_utils import read_img, save_img
from .runners import resolve_device
from .sde import rng
from .test import load_task
from .tiling import tiled_restore
from .utils import options
from .utils.img_utils import tensor2img


def restore_file(opt_path: str, src: str, dst: str, tile: int = 0, overlap: int = 64, seed: int = 0,
                 device="cuda") -> float:
    """Restore the image at ``src`` into ``dst``; returns the seconds the
    restoration took."""
    device = resolve_device(str(device))
    opt = options.dict_to_nonedict(options.parse(opt_path, is_train=False))
    task = load_task(opt, device, seed)
    batch, gen = {"LQ": read_img(src)[None].astype(np.float32)}, rng.generator(seed, device)
    t0 = time.perf_counter()
    sample_batch = getattr(task, "sample_batch", None)
    if tile and sample_batch:
        out = tiled_restore(sample_batch, task.prepare_lq(batch, gen), seed, tile=tile, overlap=overlap,
                            device=device)
    else:
        out, _ = task.infer(batch, gen)
    seconds = time.perf_counter() - t0
    save_img(tensor2img(out[0]), dst)
    return seconds


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-opt", type=str, required=True, help="Path to a test option YAML file.")
    parser.add_argument("-i", "--input", required=True)
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("--tile", type=int, default=0, help="tile side (0: the whole image at once)")
    parser.add_argument("--tile-overlap", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"), help="where to run (default: the card)")
    args = parser.parse_args(argv)
    seconds = restore_file(args.opt, args.input, args.output, args.tile, args.tile_overlap, args.seed, args.device)
    h, w = read_img(args.output).shape[:2]
    print(f"restored {args.input} -> {args.output} in {seconds:.2f}s ({w}x{h})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
