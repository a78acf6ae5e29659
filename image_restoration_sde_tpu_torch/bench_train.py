"""Training-throughput benchmark of the PyTorch port: images/s per GPU and
MFU, one JSON line.

    python -m image_restoration_sde_tpu_torch.bench_train [--device cuda|cpu]
    torchrun --nproc_per_node N -m image_restoration_sde_tpu_torch.bench_train

Counterpart of ``tools/bench_train.py``, with its workloads and
environment keys:

- ``BENCH_ARCH=unet`` (default): the flagship IR-SDE train step,
  ConditionalUNet nf 64, depth 4, bf16 compute on float32 parameters, Adam
  and EMA, 128 px crops (ref options/train/ir-sde.yml);
- ``BENCH_ARCH=refusion``: the Refusion latent recipe, ConditionalNAFNet
  width 64, enc [1, 1, 1, 28] on 8-channel latents, bf16 compute, Lion and
  EMA (ref latent-dehazing nasde.yml:74-92).  ``BENCH_PIPE=latent``
  (default) steps the score net on latents of ``BENCH_SIZE / 16`` px (64 at
  1024 px crops); ``BENCH_PIPE=full`` steps ``make_latent_train_step``:
  ``BENCH_SIZE`` px crops through the frozen compressor (UNet ch 8,
  ch_mult [4, 8, 8, 16], float32: the port's compressor has no bf16 mode),
  with ``BENCH_REMAT=1`` as the memory lever.

Other keys: ``BENCH_BATCH`` (per process; default 32), ``BENCH_SIZE``
(pixel crop; 128 for unet, 1024 for refusion), ``BENCH_STEPS`` (20 timed
steps), ``BENCH_REMAT``, ``BENCH_TRACE`` (a directory: a ``torch.profiler``
trace of 3 steps of the first form).  Weights are seeded with flax's
initialisers; the batch is random.  One untimed first step (the kernels'
build, cuDNN's choices, the allocator; the captured form's warm-up and
capture), then each step timed on the host clock up to a synchronisation
(``utils.profiling.StepTimer``); ``step_ms`` is their median.  MFU: one
step's FLOPs (``FlopCounterMode``, the ``irsde::`` operators by their
formulas, each operator backward as the plain composition it runs,
counted on an eager step: a replayed graph is not seen by the counter)
over the card's bf16 peak and ``step_ms``.

On the card, in one process, the workload runs in two forms from the same
seed, one after the other: captured (each step replays one CUDA graph, as
the train entry point runs it; ``training/captured.py``), the line's
numbers, and eager, under ``eager`` beside them.

Under ``torchrun`` each rank steps its own batch of ``BENCH_BATCH`` through
DDP (``training.trainer.data_parallel``); rank 0 prints the line, with
``world`` and the global images/s.  It runs on the card unless ``--device
cpu`` is given, where the unit says so and there is no MFU.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
from typing import Optional, Sequence

import torch

from .models import ConditionalNAFNet, ConditionalUNet, UNet, init_params_
from .parallel import dist
from .runners import resolve_device
from .sde import IRSDE, rng
from .training import build_from_options, build_lr_schedule, create_train_state, make_latent_train_step, \
    make_train_step
from .training.trainer import Remat, data_parallel
from .utils import profiling

SEED = 0
NAFNET = dict(img_channel=8, width=64, enc_blk_nums=(1, 1, 1, 28), middle_blk_num=1, dec_blk_nums=(1, 1, 1, 1))
COMPRESSOR = dict(in_ch=3, out_ch=3, ch=8, ch_mult=(4, 8, 8, 16), embed_dim=8)


def _optimizer(name: str, lr: float) -> dict:
    return {"optimizer": name, "lr_G": lr, "beta1": 0.9, "beta2": 0.99, "lr_scheme": "MultiStepLR", "lr_steps": []}


def _seeded(net, device, seed: int):
    return init_params_(net.to(device), rng.generator(seed, device)).train()


def build(arch: str, pipe: str, batch: int, size: int, remat: bool, device: torch.device, capture=False) -> tuple:
    """``(step(state) -> (state, metrics), state, description)`` of the
    workload, its steps ``capture``d or eager; the batch is drawn once from
    the seed (each rank its own)."""
    gen = rng.generator(SEED + 1 + dist.rank(), device)
    if arch == "unet":
        sde = IRSDE.create(max_sigma=10.0, T=100, schedule="cosine", eps=0.005, device=device)
        net = _seeded(ConditionalUNet(in_nc=3, out_nc=3, nf=64, depth=4, dtype=torch.bfloat16), device, SEED)
        lq = torch.rand((batch, size, size, 3), generator=gen, device=device)
        gt = (lq + 0.1).clamp(0, 1)
        train_opt, raw = _optimizer("Adam", 1e-4), make_train_step(sde, remat=remat, capture=capture)
        name = f"UNet nf64d4 bf16, {size}px"
    elif arch == "refusion":
        sde = IRSDE.create(max_sigma=50.0, T=100, schedule="cosine", eps=0.005, device=device)
        net = _seeded(ConditionalNAFNet(**NAFNET, dtype=torch.bfloat16), device, SEED)
        train_opt = _optimizer("Lion", 3e-5)
        if pipe == "latent":
            lat = max(16, size // 16)
            lq = torch.randn((batch, lat, lat, 8), generator=gen, device=device) * 0.25
            gt = lq + 0.05
            raw = make_train_step(sde, remat=remat, capture=capture)
            name = f"Refusion NAFNet w64 enc[1,1,1,28] bf16, {lat}^2x8 latents"
        elif pipe == "full":
            compressor = _seeded(UNet(**COMPRESSOR), device, SEED + 2)
            lq = torch.rand((batch, size, size, 3), generator=gen, device=device)
            gt = (lq + 0.1).clamp(0, 1)
            raw = make_latent_train_step(sde, compressor, remat=remat, capture=capture)
            name = f"Refusion full pipeline (frozen float32 compressor), bf16 score net, {size}px crops"
        else:
            raise ValueError(f"BENCH_PIPE {pipe!r}: latent or full")
    else:
        raise ValueError(f"BENCH_ARCH {arch!r}: unet or refusion")
    state = create_train_state(net, build_from_options(train_opt, net.parameters(), build_lr_schedule(train_opt)))
    if dist.is_initialized():
        data_parallel(state, Remat(net) if remat else net)
    step_gen = rng.generator(SEED + 3, device)
    return lambda s: raw(s, lq, gt, step_gen), state, name


def timed(device: torch.device, step, state, steps: int, trace_dir: Optional[str]) -> tuple:
    """``(state, metrics, StepTimer summary, peak bytes)`` of one untimed
    and ``steps`` timed steps (and a trace of 3 more in ``trace_dir``)."""

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    timer = profiling.StepTimer()
    for _ in range(1 + steps):
        with timer.step():
            state, metrics = step(state)
            sync()
    if trace_dir:
        with profiling.trace(trace_dir):
            for _ in range(3):
                state, metrics = step(state)
            sync()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return state, metrics, timer.summary(), peak


def run(device: torch.device, arch: str = "unet", pipe: str = "latent", batch: int = 32, size: int = 128,
        steps: int = 20, remat: bool = False, trace_dir: Optional[str] = None) -> dict:
    """The benchmark's line (a dict) on ``device``, printed by rank 0: the
    captured form's, with the eager form's under ``eager``; the eager
    form's alone where steps do not replay (the CPU, torchrun)."""
    on_card = device.type == "cuda"
    forms = ("captured", "eager") if on_card and not dist.is_initialized() else ("eager",)
    measured = {}
    for form in forms:
        step, state, name = build(arch, pipe, batch, size, remat, device, capture=form == "captured")
        state, metrics, summary, peak = timed(device, step, state, steps, trace_dir if form == forms[0] else None)
        measured[form] = (summary, peak, float(metrics["loss"]))
        if form == "eager":  # one eager step's FLOPs: a replay is not seen by the counter
            flops, (state, metrics) = profiling.count_flops(step, state)
            if on_card:
                torch.cuda.synchronize(device)
        del step, state, metrics
        if on_card:
            gc.collect()  # a captured form's graphs and their pool
            torch.cuda.empty_cache()
    world = dist.world_size()

    def numbers(form):
        summary, peak, loss = measured[form]
        step_s = summary["p50_s"]
        return {
            "value": round(batch / step_s, 3),
            "mfu": round(profiling.estimate_mfu(flops, step_s, profiling.peak_flops("bfloat16", device)), 4)
            if on_card else None,
            "step_ms": round(1e3 * step_s, 3),
            "mean_ms": round(1e3 * summary["mean_s"], 3),
            "p95_ms": round(1e3 * summary["p95_s"], 3),
            "first_step_s": round(summary["compile_s"], 3),
            "loss": loss,
            "global_img_s": round(world * batch / step_s, 3),
            "peak_gib": round(peak / 2**30, 3) if on_card else None,
        }

    line = {
        "metric": f"train images/sec/{'GPU' if on_card else 'CPU'} ({name}, batch {batch}"
                  f"{', remat' if remat else ''}{f', {world} processes' if world > 1 else ''})",
        "unit": "img/s/GPU" if on_card else "img/s/CPU",
        "form": forms[0],
        **numbers(forms[0]),
        "flops_per_step": flops,
        "world": world,
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
    }
    if len(forms) > 1:
        line["eager"] = numbers("eager")
    if dist.process_is_primary():
        print(json.dumps(line), flush=True)
    return line


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"), help="where to run (default: the card)")
    args = parser.parse_args(argv)
    arch = os.environ.get("BENCH_ARCH", "unet")
    device = resolve_device(args.device)
    joined = not dist.is_initialized() and dist.launched()
    device = dist.init(device)
    try:
        return run(device, arch, os.environ.get("BENCH_PIPE", "latent"), int(os.environ.get("BENCH_BATCH", "32")),
                   int(os.environ.get("BENCH_SIZE", "128" if arch == "unet" else "1024")),
                   int(os.environ.get("BENCH_STEPS", "20")), os.environ.get("BENCH_REMAT", "0") == "1",
                   os.environ.get("BENCH_TRACE") or None)
    finally:
        if joined:
            dist.shutdown()


if __name__ == "__main__":
    main()
    sys.exit(0)
