"""Refusion latent-pipeline benchmark of the PyTorch port: whole
restorations of 1024 px images, one JSON line.

    python -m image_restoration_sde_tpu_torch.bench_refusion [--device cuda|cpu]

Counterpart of ``tools/bench_refusion.py``, with its environment keys: the
NTIRE HR-dehazing configuration, the compressor (UNet ch 8, ch_mult [4, 8,
8, 16], embed_dim 8, float32: the port's compressor has no bf16 mode)
encodes to 8-channel latents at 1/8 of the image, ``BENCH_STEPS`` (100)
reverse-SDE steps run the score net on them, and the compressor decodes
with the LQ's skips (``training.make_latent_sampler``).  ``BENCH_ARCH``:
``nafnet`` (default; ConditionalNAFNet width 64, enc [1, 1, 1, 28], bf16
compute, its 28-block level one K3 launch) or ``dit`` (DiT-L/2 of
configs/latent-dehazing/train/dit.yml, bf16 compute, attention through K4).
The score net's parameters are cast to bf16 once per call unless
``BENCH_NO_CAST`` is set.

``BENCH_BATCH`` (1) images of ``BENCH_SIZE`` (1024) px: two warm-up calls,
then ``BENCH_REPS`` (3) timed on the host clock up to a synchronisation;
the value is images/s over the median.  4K-class mode, ``BENCH_H`` x
``BENCH_W``: one image, whole (padded to the /512 bucket, so the
compressor's /8 and the score net's own padding divide) or, with
``BENCH_TILE`` px, by overlapping tiles (``tiling.tiled_restore_device``,
``BENCH_TILE_BATCH`` (8) tiles a call, ``BENCH_TILE_OVERLAP`` (64);
``BENCH_TILE_HOST`` blends on the host, ``tiling.tiled_restore``); the
value is seconds an image.  ``BENCH_TRACE``: a ``torch.profiler`` trace
of one more call.  ``peak_gib``: ``torch.cuda.max_memory_allocated`` over
the timed calls.  It runs on the card unless ``--device cpu`` is given,
where the unit says so.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .models import ConditionalNAFNet, UNet, build_network, init_params_
from .runners import resolve_device
from .sde import IRSDE, rng
from .tiling import tiled_restore, tiled_restore_device
from .training import make_latent_sampler
from .utils import profiling

SEED = 0
NAFNET = dict(img_channel=8, width=64, middle_blk_num=1, enc_blk_nums=(1, 1, 1, 28), dec_blk_nums=(1, 1, 1, 1))
COMPRESSOR = dict(in_ch=3, out_ch=3, ch=8, ch_mult=(4, 8, 8, 16), embed_dim=8)
PAD_MULTIPLE = 512


def build(arch: str, device: torch.device) -> tuple:
    """``(score net, compressor, label)``, seeded weights with flax's
    initialisers."""
    compressor = init_params_(UNet(**COMPRESSOR).to(device), rng.generator(SEED, device)).eval()
    if arch == "dit":
        score, label = build_network("DiT_L_2", {"in_channels": 8}, dtype=torch.bfloat16), "DiT-L/2"
    elif arch == "nafnet":
        score, label = ConditionalNAFNet(**NAFNET, dtype=torch.bfloat16), "NAFNet w64"
    else:
        raise ValueError(f"BENCH_ARCH {arch!r}: nafnet or dit")
    return init_params_(score.to(device), rng.generator(SEED + 1, device)).eval(), compressor, label


def make_sampler(score, compressor, steps: int, cast: bool, device: torch.device, run_steps=None):
    """The benchmarked ``sample(lq, gen)``: ``steps`` reverse-SDE steps
    (``run_steps`` of them, where given, on the same schedule)."""
    sde = IRSDE.create(max_sigma=50.0, T=steps, schedule="cosine", eps=0.005, device=device)
    return make_latent_sampler(sde, score, compressor, mode="sde", steps=run_steps,
                               cast_params=torch.bfloat16 if cast else None)


def _timed(run, reps: int, sync) -> list:
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        run(i)
        sync()
        times.append(time.perf_counter() - t0)
    return times


def bench(device: torch.device, sampler, label: str, batch: int = 1, size: int = 1024, steps: int = 100,
          reps: int = 3, full_hw: Optional[tuple] = None, tile: int = 0, trace_dir: Optional[str] = None) -> dict:
    """The benchmark's line (a dict) for ``sampler`` (``make_sampler``),
    printed."""
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    if full_hw:
        run, metric = _whole_or_tiled(sampler, full_hw, tile, steps, label, device)
    else:
        lq = torch.rand((batch, size, size, 3), generator=rng.generator(SEED + 2, device), device=device)

        def run(i):
            return sampler(lq, rng.generator(i, device))

        metric = (f"Refusion latent restoration images/sec/{'GPU' if on_card else 'CPU'} ({size}px, {steps}-step "
                  f"latent SDE, {label})")
    for seed in (1_000_001, 1_000_002):  # warm the exact timed path
        run(seed)
        sync()
    if trace_dir:
        with profiling.trace(trace_dir):
            run(1_000_003)
            sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    times = _timed(run, reps, sync)
    med = statistics.median(times)
    line = {"metric": metric}
    if full_hw:
        line.update(value=round(med, 3), unit="s/image", rep_spread=[round(t, 3) for t in times])
    else:
        line.update(value=round(batch / med, 4), unit="img/s/GPU" if on_card else "img/s/CPU",
                    sec_per_image=round(med / batch, 3),
                    rep_spread=[round(t, 3) for t in times])
    line["peak_gib"] = round(torch.cuda.max_memory_allocated(device) / 2**30, 3) if on_card else None
    line["device"] = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(json.dumps(line), flush=True)
    return line


def _whole_or_tiled(sampler, full_hw: tuple, tile: int, steps: int, label: str, device: torch.device) -> tuple:
    """``(run(i), metric)`` for one ``full_hw`` image: by tiles, or
    whole, reflect-padded to PAD_MULTIPLE and cropped back."""
    H, W = full_hw
    lq = torch.rand((1, H, W, 3), generator=rng.generator(SEED + 3, "cpu")).numpy()
    if tile:
        tile_batch = int(os.environ.get("BENCH_TILE_BATCH", "8"))
        overlap = int(os.environ.get("BENCH_TILE_OVERLAP", "64"))
        if os.environ.get("BENCH_TILE_HOST"):
            tiler, mode, img = tiled_restore, f"tiled-host {tile}px/b{tile_batch}", lq
        else:
            tiler, mode = tiled_restore_device, f"tiled-device {tile}px/b{tile_batch}"
            img = np.round(np.clip(lq, 0.0, 1.0) * 255.0).astype(np.uint8)

        def run(i):
            return tiler(sampler, img, i, tile=tile, overlap=overlap, tile_batch=tile_batch, device=device)
    else:
        ph, pw = (-H) % PAD_MULTIPLE, (-W) % PAD_MULTIPLE
        padded = torch.from_numpy(np.pad(lq, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="reflect")).to(device)
        mode = "whole-image"

        def run(i):
            return sampler(padded, rng.generator(i, device))[:, :H, :W].cpu()
    return run, f"Refusion {H}x{W} restoration ({mode}, {steps}-step latent SDE, {label})"


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"), help="where to run (default: the card)")
    args = parser.parse_args(argv)
    env = os.environ
    device = resolve_device(args.device)
    full_hw = (int(env["BENCH_H"]), int(env["BENCH_W"])) if env.get("BENCH_H") and env.get("BENCH_W") else None
    steps = int(env.get("BENCH_STEPS", "100"))
    score, compressor, label = build(env.get("BENCH_ARCH", "nafnet"), device)
    sampler = make_sampler(score, compressor, steps, not env.get("BENCH_NO_CAST"), device)
    return bench(device, sampler, label, int(env.get("BENCH_BATCH", "1")), int(env.get("BENCH_SIZE", "1024")), steps,
                 int(env.get("BENCH_REPS", "3")), full_hw, int(env.get("BENCH_TILE", "0")),
                 env.get("BENCH_TRACE") or None)


if __name__ == "__main__":
    main()
    sys.exit(0)
