"""Test entry point of the PyTorch port:

    python -m image_restoration_sde_tpu_torch.test -opt=<test yml> [--device cuda|cpu]
        [--lpips-pth lpips_alex.pth] [--fid-pth fid_inception.pth]

Counterpart of ``tools/test.py``: the YAML's task runner (``runners.
build_task``) loads ``path.pretrain_model_G`` (and a latent task's frozen
compressor from ``path.pretrain_model_L``), then each test set is swept at
batch 1.  Per image: the output, LQ and GT PNGs (one per eye for stereo
pairs), PSNR, SSIM, PSNR-Y and SSIM-Y (averaged over the eyes, after
cropping ``crop_border`` pixels, by default the SR scale), LPIPS where
``--lpips-pth`` (or ``IRSDE_LPIPS_PTH``) names its weights, and the
seconds the restoration took; per set their means, FID where ``--fid-pth``
(or ``IRSDE_FID_PTH``) names InceptionV3 weights, and, on the card, the
set's own peak memory (``torch.cuda.max_memory_allocated`` less what was
allocated when the set began) beside what was allocated then.

Image i of a set draws its noise from a generator seeded from (``seed``,
i).  The YAML's ``tile`` (with ``tile_overlap``, ``tile_batch`` and
``tile_device``) restores each image by tiles through the task's
``sample_batch`` (``tiling.tiled_restore``, or ``tiled_restore_device``).
The nets compute as the runner's validation does (float32).

It runs on the card unless ``--device cpu`` is given; without a card it
raises.  Under ``torchrun --nproc_per_node N`` each rank restores its
share of each set (image i on rank i mod N) and rank 0 gathers the images,
writes every PNG, computes the metrics and logs, so the result equals a
one-process run's but for the seconds.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .data import create_dataloader, create_dataset
from .data.io_utils import save_img
from .data.transforms import rgb2ycbcr
from .parallel import dist
from .runners import build_task, resolve_device
from .sde import rng
from .tiling import tiled_restore, tiled_restore_device
from .utils import metrics, options
from .utils.fid import fid_metric_from_env_or_arg
from .utils.img_utils import split_eyes, tensor2img
from .utils.logging_utils import mkdirs, setup_logger
from .utils.lpips import lpips_fn_from_env_or_arg


def load_task(opt, device: torch.device, seed: int):
    """The YAML's task runner with its trained weights, in eval mode."""
    if not (opt["path"]["pretrain_model_G"] or opt["path"]["pretrain_model_L"]):
        raise ValueError("path.pretrain_model_G (or _L) is required for testing")
    task = build_task(opt, seed, device)
    task.maybe_load_pretrained(task.state)
    task.net.eval()
    return task


def restore(task, opt, batch, seed: int, device: torch.device):
    """(restored NHWC float32, LQ used) of one test batch, whole or by
    tiles where the YAML sets ``tile`` and the task restores tiles."""
    gen = rng.generator(seed, device)
    tile, sample_batch = opt["tile"], getattr(task, "sample_batch", None)
    if not (tile and sample_batch):
        return task.infer(batch, gen)
    lq = task.prepare_lq(batch, gen)
    tiler = tiled_restore_device if opt["tile_device"] else tiled_restore
    out = tiler(sample_batch, lq, seed, tile=int(tile), overlap=int(opt["tile_overlap"] or 64),
                tile_batch=int(opt["tile_batch"] or 4), device=device)
    return out, lq


def image_metrics(out_img: np.ndarray, gt_img: np.ndarray, crop: int, lpips_fn, fid_metric) -> dict:
    """PSNR, SSIM, PSNR-Y, SSIM-Y and LPIPS (None without ``lpips_fn``) of
    one uint8 image against its GT, averaged over the eyes of a stereo
    pair, after cropping ``crop`` pixels a side; the eyes join
    ``fid_metric``."""
    if crop:
        out_img, gt_img = out_img[crop:-crop, crop:-crop], gt_img[crop:-crop, crop:-crop]
    eyes = list(zip(split_eyes(out_img), split_eyes(gt_img)))
    m = dict(psnr=0.0, ssim=0.0, psnr_y=0.0, ssim_y=0.0, lpips=0.0 if lpips_fn else None)
    for (_, o), (_, g) in eyes:
        if fid_metric:
            fid_metric.update(o, g)
        oy = rgb2ycbcr(o.astype(np.float64) / 255.0, only_y=True) * 255
        gy = rgb2ycbcr(g.astype(np.float64) / 255.0, only_y=True) * 255
        m["psnr"] += metrics.calculate_psnr(o, g) / len(eyes)
        m["ssim"] += metrics.calculate_ssim(o, g) / len(eyes)
        m["psnr_y"] += metrics.calculate_psnr(oy, gy) / len(eyes)
        m["ssim_y"] += metrics.calculate_ssim(oy, gy) / len(eyes)
        if lpips_fn:
            m["lpips"] += lpips_fn(o, g) / len(eyes)
    return m


def save_eyes(img: np.ndarray, out_dir: str, name: str) -> None:
    for eye, im in split_eyes(img):
        save_img(im, os.path.join(out_dir, f"{name}{eye}.png"))


def evaluate(opt_path: str, device="cuda", lpips_pth: Optional[str] = None, fid_pth: Optional[str] = None) -> dict:
    """Sweep every test set of the YAML at ``opt_path``; returns, by set
    name, ``images`` (per image: name, seconds and, with a GT, its
    metrics), the means over the images with a GT (``psnr``, ``ssim``,
    ``psnr_y``, ``ssim_y``, ``lpips``, ``seconds``), ``fid`` and, on the
    card, ``peak_memory_bytes`` (the set's own: the peak less
    ``held_memory_bytes``, what was allocated when the set began)."""
    device = resolve_device(str(device))
    joined = not dist.is_initialized() and dist.launched()
    device = dist.init(device)
    try:
        return _evaluate(opt_path, device, lpips_pth, fid_pth)
    finally:
        if joined:
            dist.shutdown()


def restored_images(task, opt, loader, seed: int, device: torch.device):
    """``(i, record)`` for every image of ``loader``'s set, in order, on rank
    0 (nothing on the others): each rank restores its share (``dist.
    gathered``); a record holds the image's name, its seconds, the uint8
    output, LQ and GT (None without one)."""

    def one(i):
        batch = loader.batch(i)
        path_key = "LQ_path" if "LQ_path" in batch else "GT_path"
        t0 = time.perf_counter()
        out, lq = restore(task, opt, batch, rng.fold_seed(seed, i), device)
        seconds = time.perf_counter() - t0
        return {"base": os.path.splitext(os.path.basename(batch[path_key][0]))[0], "seconds": seconds,
                "out": tensor2img(out[0]), "lq": tensor2img(lq[0]),
                "gt": tensor2img(batch["GT"][0]) if "GT" in batch else None}

    return dist.gathered(range(len(loader)), one)


def _evaluate(opt_path: str, device: torch.device, lpips_pth, fid_pth) -> dict:
    primary = dist.process_is_primary()
    opt = options.dict_to_nonedict(options.parse(opt_path, is_train=False))
    if primary:
        mkdirs([opt["path"]["results_root"], opt["path"]["log"]])
    setup_logger("base", opt["path"]["log"], "test_" + opt["name"], screen=primary, tofile=primary)
    logger = logging.getLogger("base")
    logger.info(options.dict2str(opt))
    seed = int(opt["seed"] or 0)
    task = load_task(opt, device, seed)
    logger.info(f"Task {type(task).__name__}: {task.n_params():,d} parameters; device {device}"
                + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
                + f"; {dist.world_size()} process(es)")
    lpips_fn = lpips_fn_from_env_or_arg(lpips_pth, device) if primary else None
    fid_metric = fid_metric_from_env_or_arg(fid_pth, device) if primary else None
    suffix = opt["suffix"] or ""
    scale = opt["degradation"]["scale"] if opt["distortion"] == "sr" else 0
    crop = int(opt["crop_border"] or scale or 0)  # the reference's default: the SR scale

    results = {}
    for phase, dataset_opt in opt["datasets"].items():
        test_set = create_dataset(dataset_opt)
        loader = create_dataloader(test_set, dataset_opt, opt)
        name = dataset_opt["name"]
        logger.info(f"Testing [{name}] : {len(test_set)} images")
        out_dir = os.path.join(opt["path"]["results_root"], name)
        if primary:
            mkdirs(out_dir)
        if fid_metric:
            fid_metric.reset()  # FID is per test set
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
            held = torch.cuda.memory_allocated(device)
        images = []
        for i, img in restored_images(task, opt, loader, seed, device):
            base, seconds = img["base"] + suffix, img["seconds"]
            save_eyes(img["out"], out_dir, base)
            save_eyes(img["lq"], out_dir, f"{base}_LQ")
            record = {"name": base, "seconds": seconds}
            if img["gt"] is None:
                logger.info(f"{i + 1:3d} - {base:20s} | (no GT) | {seconds:.2f}s")
                images.append(record)
                continue
            save_eyes(img["gt"], out_dir, f"{base}_GT")
            record.update(image_metrics(img["out"], img["gt"], crop, lpips_fn, fid_metric))
            images.append(record)
            lp = "n/a" if record["lpips"] is None else f"{record['lpips']:.4f}"
            logger.info(f"{i + 1:3d} - {base:20s} | PSNR {record['psnr']:.4f} SSIM {record['ssim']:.4f} | "
                        f"PSNR-Y {record['psnr_y']:.4f} SSIM-Y {record['ssim_y']:.4f} | LPIPS {lp} | {seconds:.2f}s")

        scored = [r for r in images if "psnr" in r]
        summary = {"images": images, "fid": None, "peak_memory_bytes": None, "held_memory_bytes": None}
        if scored:
            for k in ("psnr", "ssim", "psnr_y", "ssim_y", "seconds"):
                summary[k] = float(np.mean([r[k] for r in scored]))
            summary["lpips"] = float(np.mean([r["lpips"] for r in scored])) if lpips_fn else None
            if fid_metric and fid_metric.count() >= 2:
                summary["fid"] = fid_metric.result()
            lp = "n/a" if summary["lpips"] is None else f"{summary['lpips']:.4f}"
            fid = "" if summary["fid"] is None else f" FID {summary['fid']:.4f}"
            logger.info(f"--- [{name}] avg over {len(scored)}: PSNR {summary['psnr']:.4f} SSIM {summary['ssim']:.4f} "
                        f"PSNR-Y {summary['psnr_y']:.4f} SSIM-Y {summary['ssim_y']:.4f} LPIPS {lp}{fid} "
                        f"time/img {summary['seconds']:.3f}s")
        if device.type == "cuda":
            summary["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device) - held
            summary["held_memory_bytes"] = held
            logger.info(f"--- [{name}] peak memory: {summary['peak_memory_bytes'] / 2**30:.2f} GiB above the "
                        f"{held / 2**30:.2f} GiB allocated when the set began")
        results[name] = summary
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-opt", type=str, required=True, help="Path to a test option YAML file.")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"), help="where to run (default: the card)")
    parser.add_argument("--lpips-pth", default=None,
                        help="full lpips.LPIPS(net='alex' or 'vgg') state_dict .pth (or .npz) for the LPIPS column; "
                             "also IRSDE_LPIPS_PTH")
    parser.add_argument("--fid-pth", default=None,
                        help="InceptionV3 state_dict .pth or .npz (pytorch-fid or torchvision names) for the "
                             "per-set FID; also IRSDE_FID_PTH")
    args = parser.parse_args(argv)
    evaluate(args.opt, args.device, args.lpips_pth, args.fid_pth)
    return 0


if __name__ == "__main__":
    sys.exit(main())
