#!/usr/bin/env python3
"""Benchmark of the PyTorch port: restored images/s on one GPU at 100
reverse-SDE steps.

    python3 bench_cuda.py [--eager]

``bench.py``'s configuration and metric line, run through the port
(``image_restoration_sde_tpu_torch``) on an NVIDIA GPU: the flagship IR-SDE
deraining score net (ConditionalUNet nf=64, depth=4, bf16 compute, float32
parameters, seeded random weights with flax's initialisers), IR-SDE on the
cosine schedule (max_sigma 10, eps 0.005), T = 100 steps of the reverse SDE
(``sampling.make_restoration_sampler``, mode ``sde``) on a batch of 8
random 128 px images, the chain replayed from its captured CUDA graph as
the sampler runs it on the card (``--eager``: the eager chain, one
enqueue a kernel).  The overrides are ``bench.py``'s: ``BENCH_BATCH``,
``BENCH_SIZE``, ``BENCH_STEPS``, ``BENCH_REPS`` (5) and ``BENCH_CAST`` (any
value: the parameters cast to bf16 once per call).

Two warm-up calls run the exact timed path (the first captures the
chain); then each of ``BENCH_REPS``
calls is timed on the host clock up to ``torch.cuda.synchronize()``, and
the value is the batch over the median time.  It prints ONE JSON line with
``bench.py``'s keys (``metric``, ``value``, ``unit`` = ``img/s/GPU``,
``vs_baseline``, ``baseline_kind``) and the device it ran on.  It runs on
the card; without one it raises, unless ``main(device="cpu")`` asks for the
CPU.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_IMGS_PER_SEC = 1.0  # bench.py's estimate of the reference's throughput
BASELINE_KIND = ("analytic estimate (~1 img/s on the reference's TITAN XP dev hardware; the reference publishes "
                 "no measured throughput)")
SEED = 0


def make_net(device):
    """The benchmarked score net, its weights seeded with flax's
    initialisers."""
    import torch

    from image_restoration_sde_tpu_torch.models import ConditionalUNet, init_params_
    from image_restoration_sde_tpu_torch.sde import rng

    net = ConditionalUNet(in_nc=3, out_nc=3, nf=64, depth=4, dtype=torch.bfloat16).to(device).eval()
    return init_params_(net, rng.generator(SEED, device))


def make_sampler(net, steps: int, cast: bool, device, capture=True):
    """The benchmarked sampler over ``net``: ``sample(lq, gen)``; captured
    on the card unless ``capture`` is False."""
    import torch

    from image_restoration_sde_tpu_torch.sampling import make_restoration_sampler
    from image_restoration_sde_tpu_torch.sde import IRSDE

    sde = IRSDE.create(max_sigma=10.0, T=steps, schedule="cosine", eps=0.005, device=device)
    return make_restoration_sampler(sde, net, mode="sde", cast_params=torch.bfloat16 if cast else None,
                                    capture=capture)


def run(sampler, batch: int, size: int, reps: int, device) -> list:
    """Seconds of each of ``reps`` timed calls at (batch, size), after two
    warm-up calls of the same path; each call ends in a synchronisation."""
    import torch

    from image_restoration_sde_tpu_torch.sde import rng

    lq = torch.rand((batch, size, size, 3), generator=rng.generator(SEED, "cpu")).to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for seed in (1_000_001, 1_000_002):
        sampler(lq, rng.generator(seed, device))
        sync()
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        sampler(lq, rng.generator(i, device))
        sync()
        times.append(time.perf_counter() - t0)
    return times


def main(device=None, capture=True) -> dict:
    import torch

    from image_restoration_sde_tpu_torch.runners import resolve_device

    device = resolve_device("cuda" if device is None else str(device))
    batch = int(os.environ.get("BENCH_BATCH", "8"))
    size = int(os.environ.get("BENCH_SIZE", "128"))
    steps = int(os.environ.get("BENCH_STEPS", "100"))
    reps = int(os.environ.get("BENCH_REPS", "5"))
    sampler = make_sampler(make_net(device), steps, bool(os.environ.get("BENCH_CAST")), device, capture)
    imgs_per_sec = batch / statistics.median(run(sampler, batch, size, reps, device))
    line = {
        "metric": f"restored images/sec/GPU ({steps}-step reverse SDE, {size}px, UNet nf64d4 bf16)",
        "value": round(imgs_per_sec, 4),
        "unit": "img/s/GPU",
        "vs_baseline": round(imgs_per_sec / BASELINE_IMGS_PER_SEC, 4),
        "baseline_kind": BASELINE_KIND,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main(capture="--eager" not in sys.argv[1:])
