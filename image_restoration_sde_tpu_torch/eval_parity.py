"""Quality-parity harness of the PyTorch port against the reference's
headline table:

    python -m image_restoration_sde_tpu_torch.eval_parity --data <dir with GT/ and LQ/> --pth <.pth>
        [--arch ConditionalUNet --setting JSON] [--T 100 --mode posterior --dtype bf16]
        [--lpips-pth lpips_alex.pth] [--fid-pth fid_inception.pth] [--target-psnr 31.65 ...]
        [--device cuda|cpu]

Counterpart of ``tools/eval_parity.py``, with its flags and targets
(Rain100H 31.65 dB / 0.9041 / 0.047 / FID 18.64, ref README.md:42-51):
the net's weights from a ``.pth`` (the reference's, or a train run's
``<iter>_G.pth``: both in the reference's key space), the full reverse
sampler over every pair (image i's noise from ``rng.fold_seed(seed,
i)``), PSNR / SSIM on RGB and Y (ref test.py:130-219; the test entry
point's ``image_metrics``), LPIPS through the
port's ``utils.lpips`` where ``--lpips-pth`` (or ``IRSDE_LPIPS_PTH``)
names its weights, FID through ``utils.fid`` where ``--fid-pth`` does.
Prints a row per image and the table; exits 1 when PSNR falls more than
``--tolerance`` dB short of ``--target-psnr``, 2 without images.  It runs
on the card unless ``--device cpu`` is given; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

import torch

from .data.io_utils import get_paths_from_images, read_img, save_img
from .models import build_network
from .runners import resolve_device
from .sampling import make_restoration_sampler, pad_to_bucket, unpad
from .sde import IRSDE, rng
from .test import image_metrics
from .training.checkpoint import load_params
from .utils.fid import fid_metric_from_env_or_arg
from .utils.img_utils import tensor2img
from .utils.lpips import lpips_fn_from_env_or_arg

# published reference results on Rain100H (ref README.md:42-51)
REFERENCE_TARGETS = {"psnr": 31.65, "ssim": 0.9041, "lpips": 0.047, "fid": 18.64}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data", help="dir containing GT/ and LQ/ image folders")
    p.add_argument("--gt", help="GT folder (overrides --data/GT)")
    p.add_argument("--lq", help="LQ folder (overrides --data/LQ)")
    p.add_argument("--pth", required=True, help="the net's .pth (a reference checkpoint or <iter>_G.pth)")
    p.add_argument("--arch", default="ConditionalUNet")
    p.add_argument("--setting", default='{"in_nc": 3, "out_nc": 3, "nf": 64, "depth": 4}',
                   help="network kwargs JSON (ref options/test/ir-sde.yml)")
    p.add_argument("--max-sigma", type=float, default=10.0)
    p.add_argument("--T", type=int, default=100)
    p.add_argument("--schedule", default="cosine")
    p.add_argument("--eps", type=float, default=0.005)
    p.add_argument("--mode", default="posterior", choices=["posterior", "sde", "ode"],
                   help="sampling mode (ref test config uses posterior)")
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"], help="compute dtype")
    p.add_argument("--max-images", type=int, default=0, help="0 = all")
    p.add_argument("--lpips-pth", default=None,
                   help="lpips.LPIPS(net='alex') full state_dict .pth for utils/lpips.py; also IRSDE_LPIPS_PTH")
    p.add_argument("--fid-pth", default=None,
                   help="InceptionV3 state_dict .pth (pytorch-fid naming) for utils/fid.py; also IRSDE_FID_PTH")
    p.add_argument("--crop-border", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-dir", help="also save restored PNGs here")
    p.add_argument("--target-psnr", type=float, default=REFERENCE_TARGETS["psnr"])
    p.add_argument("--target-ssim", type=float, default=REFERENCE_TARGETS["ssim"])
    p.add_argument("--target-lpips", type=float, default=REFERENCE_TARGETS["lpips"])
    p.add_argument("--target-fid", type=float, default=REFERENCE_TARGETS["fid"])
    p.add_argument("--tolerance", type=float, default=0.1,
                   help="max allowed PSNR shortfall in dB before exiting nonzero")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    gt_root = args.gt or (os.path.join(args.data, "GT") if args.data else None)
    lq_root = args.lq or (os.path.join(args.data, "LQ") if args.data else None)
    if not (gt_root and lq_root):
        print("error: need --data <dir with GT/ and LQ/> or --gt/--lq", file=sys.stderr)
        return 2
    gt_paths, lq_paths = get_paths_from_images(gt_root), get_paths_from_images(lq_root)
    if len(gt_paths) != len(lq_paths):
        print(f"error: {len(gt_paths)} GT images against {len(lq_paths)} LQ", file=sys.stderr)
        return 2
    if args.max_images:
        gt_paths, lq_paths = gt_paths[: args.max_images], lq_paths[: args.max_images]

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    net = build_network(args.arch, {**json.loads(args.setting), "dtype": dtype})
    net.load_state_dict(load_params(args.pth))
    net = net.to(device).eval()
    sde = IRSDE.create(max_sigma=args.max_sigma, T=args.T, schedule=args.schedule, eps=args.eps, device=device)
    sampler = make_restoration_sampler(sde, net, mode=args.mode, cast_params=dtype if args.dtype == "bf16" else None)
    lpips_fn = lpips_fn_from_env_or_arg(args.lpips_pth, device)
    fid_metric = fid_metric_from_env_or_arg(args.fid_pth, device)

    sums = dict(psnr=0.0, ssim=0.0, psnr_y=0.0, ssim_y=0.0, lpips=0.0, time=0.0)
    n = 0
    for i, (gp, lp) in enumerate(zip(gt_paths, lq_paths)):
        gt, lq = read_img(gp)[None], read_img(lp)[None]
        vlq, hw = pad_to_bucket(lq, 64)
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = unpad(sampler(torch.from_numpy(vlq).to(device), rng.generator(rng.fold_seed(args.seed, i), device)),
                        hw)
            o = tensor2img(out[0])
        dt = time.perf_counter() - t0
        g = tensor2img(gt[0])
        if args.save_dir:
            save_img(o, os.path.join(args.save_dir, f"{os.path.splitext(os.path.basename(lp))[0]}.png"))
        m = image_metrics(o, g, args.crop_border, lpips_fn, fid_metric)
        for k in sums:
            sums[k] += dt if k == "time" else (m[k] or 0.0)
        n += 1
        lp_str = f"{m['lpips']:.4f}" if lpips_fn else "n/a"
        print(f"{i + 1:3d} {os.path.basename(lp):24s} PSNR {m['psnr']:7.4f}  SSIM {m['ssim']:.4f}  "
              f"PSNR-Y {m['psnr_y']:7.4f}  SSIM-Y {m['ssim_y']:.4f}  LPIPS {lp_str}  {dt:.2f}s")
    if not n:
        print("error: no images evaluated", file=sys.stderr)
        return 2
    avg = {k: v / n for k, v in sums.items()}
    lp_avg = f"{avg['lpips']:.4f}" if lpips_fn else "n/a"
    fid_val = f"{fid_metric.result():.4f}" if fid_metric and fid_metric.count() >= 2 else "n/a"
    print(f"\n=== parity vs reference ({n} images, {args.mode} sampling, {args.T} steps, {args.dtype}, "
          f"{device.type}) ===")
    print(f"{'metric':8s} {'this port':>16s} {'reference':>11s}")
    print(f"{'PSNR':8s} {avg['psnr']:16.4f} {args.target_psnr:11.4f}")
    print(f"{'SSIM':8s} {avg['ssim']:16.4f} {args.target_ssim:11.4f}")
    print(f"{'LPIPS':8s} {lp_avg:>16s} {args.target_lpips:11.4f}")
    print(f"{'FID':8s} {fid_val:>16s} {args.target_fid:11.4f}")
    print(f"{'PSNR-Y':8s} {avg['psnr_y']:16.4f} {'-':>11s}")
    print(f"{'SSIM-Y':8s} {avg['ssim_y']:16.4f} {'-':>11s}")
    print(f"time/img {avg['time']:.3f}s")
    shortfall = args.target_psnr - avg["psnr"]
    if shortfall > args.tolerance:
        print(f"FAIL: PSNR {avg['psnr']:.4f} is {shortfall:.3f} dB below the target {args.target_psnr} "
              f"(tolerance {args.tolerance})")
        return 1
    print(f"PASS: PSNR within {args.tolerance} dB of the target (margin {-shortfall:+.3f} dB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
