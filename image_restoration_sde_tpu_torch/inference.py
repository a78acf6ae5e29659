"""Inference entry point of the PyTorch port, outputs only, no metrics:

    python -m image_restoration_sde_tpu_torch.inference -opt=<yml> [--sigma S] [--device cuda|cpu]

Counterpart of ``tools/inference.py``: each test set of the YAML restored
at batch 1 through the task runner's ``infer``, one PNG an image under
``results/<task>/<name>/<set>``.  A set of GT images (Gaussian
denoising) gets GT plus noise of ``degradation.sigma``, which ``--sigma``
overrides; the reverse ODE then starts at that sigma's optimal timestep.
Image i draws from a generator seeded from (``seed``, i).

It runs on the card unless ``--device cpu`` is given; without a card it
raises.  Under ``torchrun --nproc_per_node N`` each rank restores its
share of each set (image i on rank i mod N) and rank 0 writes the PNGs and
logs.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np

from .data import create_dataloader, create_dataset
from .data.io_utils import save_img
from .parallel import dist
from .runners import resolve_device
from .sde import rng
from .test import load_task
from .utils import options
from .utils.img_utils import tensor2img
from .utils.logging_utils import mkdirs, setup_logger


def infer(opt_path: str, device="cuda", sigma: Optional[float] = None) -> dict:
    """Restore every test set of the YAML at ``opt_path``; returns, by set
    name, the seconds of each image."""
    device = resolve_device(str(device))
    joined = not dist.is_initialized() and dist.launched()
    device = dist.init(device)
    try:
        return _infer(opt_path, device, sigma)
    finally:
        if joined:
            dist.shutdown()


def _infer(opt_path: str, device, sigma: Optional[float]) -> dict:
    primary = dist.process_is_primary()
    opt = options.parse(opt_path, is_train=False)
    if sigma is not None:
        opt.setdefault("degradation", {})["sigma"] = sigma
    opt = options.dict_to_nonedict(opt)
    if primary:
        mkdirs([opt["path"]["results_root"], opt["path"]["log"]])
    setup_logger("base", opt["path"]["log"], "inference_" + opt["name"], screen=primary, tofile=primary)
    logger = logging.getLogger("base")
    seed = int(opt["seed"] or 0)
    task = load_task(opt, device, seed)
    suffix = opt["suffix"] or ""
    results = {}
    for phase, dataset_opt in opt["datasets"].items():
        test_set = create_dataset(dataset_opt)
        loader = create_dataloader(test_set, dataset_opt, opt)
        name = dataset_opt["name"]
        logger.info(f"Inference [{name}] : {len(test_set)} images")
        out_dir = os.path.join(opt["path"]["results_root"], name)
        if primary:
            mkdirs(out_dir)

        def one(i):
            batch = loader.batch(i)
            path_key = "LQ_path" if "LQ_path" in batch else "GT_path"
            t0 = time.perf_counter()
            out, _ = task.infer(batch, rng.generator(rng.fold_seed(seed, i), device))
            return (os.path.splitext(os.path.basename(batch[path_key][0]))[0], time.perf_counter() - t0,
                    tensor2img(out[0]))

        times = []
        for i, (base, seconds, out_img) in dist.gathered(range(len(loader)), one):
            times.append(seconds)
            save_img(out_img, os.path.join(out_dir, f"{base + suffix}.png"))
            logger.info(f"{i + 1:3d} - {base + suffix:20s} | {seconds:.2f}s")
        if primary:
            logger.info(f"--- [{name}] average test time: {np.mean(times):.4f}s over {len(times)}")
        results[name] = times
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-opt", type=str, required=True, help="Path to a test option YAML file.")
    parser.add_argument("--sigma", type=float, default=None,
                        help="override degradation.sigma (the noise added to GT inputs)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"), help="where to run (default: the card)")
    args = parser.parse_args(argv)
    infer(args.opt, args.device, args.sigma)
    return 0


if __name__ == "__main__":
    sys.exit(main())
