#!/usr/bin/env python3
"""Where the time of one sampler step goes, on one NVIDIA GPU.

    python3 chip_profile.py

For each of the port's sampler paths (the configurations of
``chip_smoke.py``: IR-SDE deraining, ConditionalUNet at batch 8, 128 px;
Refusion latent dehazing, ConditionalNAFNet on the 64x64x8 latents of
batch 4 at 512 px; Refusion DiT, DiT-L/2 on the 128x128x8 latents of batch
2 at 1024 px, its parameters cast to bf16 as the sampler casts them;
Gaussian denoising, the unconditional ConditionalUNet's reverse ODE at
batch 8, 128 px and on one 512x512 image; stereo super-resolution, the
stereo NAFNet on 4 pairs at 128 px; latent bokeh, the bokeh NAFNet with
lens values on the 128x128x4 latents of batch 4 at 512 px), with random
weights made from a seed, bf16 score net:

- wall time per step: host clock around ``STEPS`` reverse steps that end
  in ``torch.cuda.synchronize()``, after a warm run of the same length;
- host enqueue time per net forward: host clock around one forward with
  no synchronisation (the card runs behind), median of ``ENQUEUE_REPS``
  forwards, each started on an idle card;
- device time per step by kernel, and the device's busy share (summed
  kernel time over wall time), from ``torch.profiler`` over the same
  steps;
- the share of device time in the port's own kernels (K4 on the DiT
  path);
- the latent and bokeh paths' compressor encode and decode times, the
  host time to enqueue the NAFNet's fused 28-block level, and that
  level's kernel (K3) time by phase, from clock readings in the kernel.

Then where one train step's time goes on the two pixel train paths
(``configs/deraining/train/ir-sde.yml``: ConditionalUNet nf=64, depth=4,
Adam; ``configs/deraining/train/refusion.yml``: ConditionalNAFNet width 64,
enc [1, 1, 1, 28], Lion), built by the port's runner, float32, batch 4 of
128 px, on the kernel path and the plain path, with TF32 off for
convolutions (as ``chip_smoke.py`` runs) and with torch's default (cuDNN
TF32 on, what the train entry point runs with): wall ms per step (host
clock around ``TRAIN_STEPS`` steps ending in a synchronisation) and device
time by kernel over the same steps.  Then the same for two latent train
paths at torch's default, float32, batch 8 of 1024 px crops with a seeded
frozen compressor: the latent NAFNet (``configs/latent-dehazing/train/
nasde.yml``, kernel path and plain path) and DiT-L/2
(``configs/latent-dehazing/train/dit.yml``, kernel path: the plain path's
attention keeps B H N^2 float32 scores a block for its backward, past the
card's memory at batch 8), with the step's peak memory.

Without CUDA it exits at once.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED, STEPS, TRAIN_STEPS = 0, 10, 3
ENQUEUE_REPS = 5  # host enqueue per forward: median of this many forwards, each on an idle card
# the port's kernels by the stem of their device function names (csrc/*.cu)
PORT_KERNELS = {"K1": "channel_layernorm_kernel", "K2a": "la_ctx", "K2b": "la_apply", "K3": "naf_stack",
                "K4": "flash_fwd", "K5 context": "lin_attn_ctx", "K5 apply": "lin_attn_apply"}


def posterior(net, xt, mu, sde):
    """(run, forward): STEPS posterior steps of ``net(x, mu, tvec)`` from
    ``xt`` with zero noise, and one forward at t = 50."""
    import torch

    from image_restoration_sde_tpu_torch.sde import samplers

    noise = torch.zeros(STEPS, *xt.shape, device=xt.device)
    tvec = torch.full((xt.shape[0],), 50, device=xt.device)
    return (lambda: samplers.reverse_posterior(sde, net, xt, mu, None, steps=STEPS, noise_seq=noise),
            lambda: net(xt, mu, tvec))


def profile_steps(name, run, forward, steps=STEPS):
    """``run()``: ``steps`` sampler steps; ``forward()``: one net forward."""
    import torch

    with torch.inference_mode():
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
        enqueues = []
        for _ in range(ENQUEUE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward()
            enqueues.append((time.perf_counter() - t0) * 1e3)
        enqueue = statistics.median(enqueues)
        torch.cuda.synchronize()
        kernels = device_times(run, steps)
    report(name, kernels, wall, f"host enqueue {enqueue:.3f} ms/forward; ")


def device_times(run, steps):
    """{kernel name: device ms per step} of ``run()`` (``steps`` steps)
    under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.device_time_total / 1e3 / steps  # ms per step
    return kernels


def report(name, kernels, wall, extra=""):
    """Print wall and device time per step, the busy share, the top
    kernels and the port's kernels' share."""
    busy = sum(kernels.values())
    print(f"[{name}] wall {wall:.3f} ms/step; {extra}device busy "
          f"{busy:.3f} ms/step ({100 * busy / wall:.1f}% of wall, idle {100 - 100 * busy / wall:.1f}%)")
    for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:15]:
        print(f"[{name}]   {v:8.4f} ms/step {100 * v / busy:5.1f}%  {k[:110]}")
    for tag, stem in PORT_KERNELS.items():
        v = sum(t for k, t in kernels.items() if stem in k)
        if v:
            print(f"[{name}] {tag} ({stem}) {v:.4f} ms/step, {100 * v / busy:.1f}% of device time")


def fused_site_enqueue(net, batch, dev, reps=20):
    """Host time to enqueue the NAFNet's fused level (weight gathering,
    pointer table, time modulation and the K3 launch), median of ``reps``,
    with the card idle before each."""
    import torch

    from image_restoration_sde_tpu_torch.models.nafnet import FUSE_MIN_BLOCKS

    level = max(range(len(net.encoders)), key=lambda i: len(net.encoders[i]))
    blocks = net.encoders[level]
    assert len(blocks) >= FUSE_MIN_BLOCKS
    C = blocks[0].conv3.out_channels
    x = torch.zeros(batch, 8, 8, C, dtype=net.dtype, device=dev).permute(0, 3, 1, 2)
    times = []
    with torch.inference_mode():
        t = net.time_mlp(torch.full((batch,), 50.0, device=dev))
        for _ in range(reps + 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net._block_run(blocks, x, t)
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    print(f"[latent] fused level ({len(blocks)} blocks, C={C}) host enqueue {statistics.median(times[3:]):.3f} ms "
          f"per forward (median of {reps})")


def fused_site_phases(net, batch, dev):
    """K3's time by phase at the latent NAFNet's fused level: one launch
    with its first CTA reading the card's clock around every grid barrier
    (``naf_stack_phase_times``); per phase kind the mean over the blocks of
    that CTA's own work and of its wait at the barrier that ends the phase
    (the wait holds the slowest CTA's extra work and the barrier)."""
    import torch

    from image_restoration_sde_tpu_torch.ops import naf_stack as NS

    level = max(range(len(net.encoders)), key=lambda i: len(net.encoders[i]))
    blocks = [blk.tensors() for blk in net.encoders[level]]
    C = blocks[0]["conv3.weight"].shape[0]
    with torch.inference_mode():
        temb = net.time_mlp(torch.full((batch,), 50.0, device=dev))
        x = torch.randn(batch, 8, 8, C, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
        x = x.to(net.dtype)
        tmod = NS.time_modulation(blocks, temb)
        NS.naf_stack_cuda(x, blocks, tmod, 1e-3)
        _, st = NS.naf_stack_phase_times(x, blocks, tmod, 1e-3)
    st = st.tolist()
    names = ["opening stats", "opening combine"] + ["1 conv1+dw+gate+mean", "2 SCA", "3 conv3", "4 LN2+conv4",
                                                     "5 conv5"] * len(blocks)
    work, wait, prev = {}, {}, st[0]
    for name, before, after in zip(names, st[1:-1:2], st[2:-1:2]):
        work.setdefault(name, []).append((before - prev) / 1e3)
        wait.setdefault(name, []).append((after - before) / 1e3)
        prev = after
    work["5 conv5"].append((st[-1] - prev) / 1e3)
    print(f"[latent] K3 phases at ({batch}, 8, 8, {C}), {len(blocks)} blocks: {(st[-1] - st[0]) / 1e3:.1f} us "
          f"from first to last reading")
    for name in dict.fromkeys(names):
        print(f"[latent]   {name:22s} work {statistics.mean(work[name]):7.2f} us, barrier wait "
              f"{statistics.mean(wait.get(name, [0.0])):7.2f} us (mean over {len(work[name])})")


def compressor_times(tag, compressor, img):
    import torch

    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        latent, hidden = compressor.encode(img)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        compressor.decode(latent, hidden)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        compressor.decode(latent, hidden)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    print(f"[{tag}] compressor at batch {img.shape[0]}, {img.shape[1]} px, f32: encode {1e3 * (t1 - t0):.2f} ms "
          f"(cold), decode {1e3 * (t2 - t1):.2f} ms (cold), {1e3 * (t3 - t2):.2f} ms (warm)")
    return latent


def profile_train(dev, gen):
    """One train step of each pixel train path (module docstring), kernel
    path and plain path, TF32 off and at torch's default."""
    import torch
    import yaml

    from image_restoration_sde_tpu_torch import runners
    from image_restoration_sde_tpu_torch.utils import options

    lq = torch.rand(4, 128, 128, 3, generator=gen, device=dev)
    gt = (lq - 0.2 * torch.rand(lq.shape, generator=gen, device=dev)).clamp(0, 1)
    default_tf32 = torch.backends.cudnn.allow_tf32
    for cfg in ("ir-sde", "refusion"):
        with open(os.path.join(REPO, "configs", "deraining", "train", f"{cfg}.yml")) as f:
            raw = yaml.safe_load(f)
        for plain in (False, True):
            raw["network_G"]["setting"]["plain"] = plain
            task = runners.build_task(options.dict_to_nonedict(raw), SEED, dev)
            step_gen = torch.Generator(device=dev).manual_seed(SEED + 2)

            def run(n=TRAIN_STEPS):
                for _ in range(n):
                    task._train_step(task.state, lq, gt, step_gen)

            for tf32 in (False, True):
                torch.backends.cudnn.allow_tf32 = tf32
                run(2)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
                name = f"train {cfg} {'plain' if plain else 'kernel'} path, cuDNN TF32 {'on' if tf32 else 'off'}"
                report(name, device_times(run, TRAIN_STEPS), wall, "batch 4 at 128 px, float32; ")
            del task
            torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = default_tf32

    lq = torch.rand(8, 1024, 1024, 3, generator=gen, device=dev)
    gt = (lq - 0.2 * torch.rand(lq.shape, generator=gen, device=dev)).clamp(0, 1)
    for cfg, paths in (("nasde", (False, True)), ("dit", (False,))):
        with open(os.path.join(REPO, "configs", "latent-dehazing", "train", f"{cfg}.yml")) as f:
            raw = yaml.safe_load(f)
        raw["path"]["pretrain_model_L"] = None  # a seeded compressor
        for plain in paths:
            for key in ("network_G", "network_L"):
                raw[key]["setting"]["plain"] = plain
            task = runners.build_task(options.dict_to_nonedict(raw), SEED, dev)
            step_gen = torch.Generator(device=dev).manual_seed(SEED + 2)

            def run(n=TRAIN_STEPS):
                for _ in range(n):
                    task._train_step(task.state, lq, gt, step_gen)

            torch.cuda.reset_peak_memory_stats()
            run(2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
            peak = torch.cuda.max_memory_allocated() / 2**30
            name = f"train {cfg} {'plain' if plain else 'kernel'} path, cuDNN TF32 on"
            report(name, device_times(run, TRAIN_STEPS), wall, f"batch 8 at 1024 px, float32, peak {peak:.2f} GiB; ")
            del task
            torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import yaml

    sys.path.insert(0, REPO)
    from image_restoration_sde_tpu_torch.models import (
        ConditionalNAFNet, ConditionalUNet, UNet, build_network, init_params_,
    )
    from image_restoration_sde_tpu_torch.sampling import make_noise_fn
    from image_restoration_sde_tpu_torch.sde import IRSDE, DenoisingSDE, samplers

    dev = torch.device("cuda", 0)

    def load(*path):
        with open(os.path.join(REPO, "configs", *path)) as f:
            return yaml.safe_load(f)

    def seeded(net):
        return init_params_(net, torch.Generator().manual_seed(SEED)).to(dev).eval()

    def make_sde(opt):
        s = opt["sde"]
        return IRSDE.create(s["max_sigma"], s["T"], s["schedule"], s["eps"], device=dev)

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    opt = load("deraining", "test", "ir-sde.yml")
    unet = seeded(ConditionalUNet(**opt["network_G"]["setting"], dtype=torch.bfloat16))
    lq = torch.rand(8, 128, 128, 3, generator=gen, device=dev)
    profile_steps("deraining", *posterior(unet, lq + 0.1, lq, make_sde(opt)))
    del unet

    opt = load("latent-dehazing", "test", "nasde.yml")
    naf = seeded(ConditionalNAFNet(**opt["network_G"]["setting"], dtype=torch.bfloat16))
    compressor = seeded(UNet(**opt["network_L"]["setting"]))
    latent = compressor_times("latent", compressor, torch.rand(4, 512, 512, 3, generator=gen, device=dev))
    profile_steps("latent", *posterior(naf, latent + 0.1, latent, make_sde(opt)))
    fused_site_enqueue(naf, latent.shape[0], dev)
    fused_site_phases(naf, latent.shape[0], dev)
    del naf

    opt = load("latent-dehazing", "train", "dit.yml")
    dit = seeded(build_network(opt["network_G"]["which_model"], opt["network_G"]["setting"], dtype=torch.bfloat16))
    img = torch.rand(2, 1024, 1024, 3, generator=gen, device=dev)
    with torch.inference_mode():
        latent, _ = compressor.encode(img)
    profile_steps("dit", *posterior(make_noise_fn(dit, torch.bfloat16), latent + 0.1, latent, make_sde(opt)))
    del dit, compressor

    opt = load("denoising", "test", "ir-sde.yml")
    unet = seeded(ConditionalUNet(**opt["network_G"]["setting"], conditional=False, dtype=torch.bfloat16))
    s = opt["sde"]
    dsde = DenoisingSDE.create(s["max_sigma"], s["T"], s["schedule"], device=dev)
    for tag, x in (("denoise", torch.rand(8, 128, 128, 3, generator=gen, device=dev)),
                   ("denoise-512", torch.rand(1, 512, 512, 3, generator=gen, device=dev))):
        tvec = torch.full((x.shape[0],), 50, device=dev)
        profile_steps(tag, lambda: samplers.dsde_reverse_ode(dsde, lambda a, t: unet(a, None, t), x, steps=STEPS),
                      lambda: unet(x, None, tvec))
    del unet

    opt = load("stereo-sr", "test", "refusion.yml")
    stereo = seeded(build_network("StereoConditionalNAFNet", opt["network_G"]["setting"], dtype=torch.bfloat16))
    lq = torch.rand(4, 128, 128, 6, generator=gen, device=dev)
    profile_steps("stereo", *posterior(stereo, lq + 0.1, lq, make_sde(opt)))
    del stereo

    opt = load("latent-bokeh", "test", "refusion.yml")
    bokeh = seeded(build_network("BokehConditionalNAFNet", opt["network_G"]["setting"], dtype=torch.bfloat16))
    compressor = seeded(build_network(opt["network_L"]["which_model"], opt["network_L"]["setting"]))
    latent = compressor_times("bokeh", compressor, torch.rand(4, 512, 512, 3, generator=gen, device=dev))
    lens = (torch.full((4,), 2.0, device=dev), torch.full((4,), 16.0, device=dev), torch.full((4,), 0.5, device=dev))
    profile_steps("bokeh", *posterior(lambda x, m, t: bokeh(x, m, t, lens), latent + 0.1, latent, make_sde(opt)))
    del bokeh, compressor
    torch.cuda.empty_cache()
    profile_train(dev, gen)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[card] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
