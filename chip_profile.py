#!/usr/bin/env python3
"""Where the time of one sampler step goes, on one NVIDIA GPU.

    python3 chip_profile.py [--sampling | --train | --dit-train | --dit-xl] [--package CHECKOUT]
        [--form eager|captured|both]

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

- each in two forms (``--form``, default both): the eager chain, and the
  same chain captured as one CUDA graph and replayed (``sde/captured.py``,
  as the samplers run it on the card), each form's line tagged with it;
- wall time per step: host clock around ``STEPS`` reverse steps that end
  in ``torch.cuda.synchronize()``, after a warm run of the same length
  (the captured form's warm run captures);
- host time per step: host clock around the same call with no
  synchronisation, over ``STEPS`` (the card runs behind; median of
  ``ENQUEUE_REPS`` calls, each started on an idle card);
- host enqueue time per net forward (eager): host clock around one
  forward with no synchronisation, median of ``ENQUEUE_REPS`` forwards,
  each started on an idle card;
- device time per step by kernel, and the device's busy share (summed
  kernel time over wall time), from ``torch.profiler`` over the same
  steps;
- the share of device time in the port's own kernels (K4 on the DiT
  path);
- the latent and bokeh paths' compressor encode and decode times, the
  host time to enqueue the NAFNet's fused 28-block level, and that
  level's kernel (K3) time by phase, from clock readings in the kernel.

Then where one train step's time goes on the train paths, each in the two
forms of ``--form`` (the eager step, and the step replayed from its
captured CUDA graph, as the train entry point runs it on the card;
``training/captured.py``): the two pixel train paths
(``configs/deraining/train/ir-sde.yml``: ConditionalUNet nf=64, depth=4,
Adam; ``configs/deraining/train/refusion.yml``: ConditionalNAFNet width 64,
enc [1, 1, 1, 28], Lion), built by the port's runner, float32, batch 4 of
128 px, on the kernel path and the plain path, with TF32 off for
convolutions (as ``chip_smoke.py`` runs) and with torch's default (cuDNN
TF32 on, what the train entry point runs with): wall ms per step (host
clock around ``TRAIN_STEPS`` steps ending in a synchronisation), host ms
per step (the same steps with no synchronisation) and device time by
kernel over the same steps, with the busy and idle share.  Then the same
for two latent train paths at torch's default, float32, batch 8 of 1024 px
crops with a seeded frozen compressor: the latent NAFNet
(``configs/latent-dehazing/train/nasde.yml``, kernel path and plain path)
and DiT-L/2 (``configs/latent-dehazing/train/dit.yml``, kernel path: the
plain path's attention keeps B H N^2 float32 scores a block for its
backward, past the card's memory at batch 8), with the step's peak memory;
then the compressor (``configs/unet-latent/train/train_haze.yml``, batch 16
of 256 px), latent bokeh (``configs/latent-bokeh/train/refusion.yml``,
batch 8 of 512 px with lens values) and stereo
(``configs/stereo-sr/train/refusion.yml``, batch 8 of 128 px pairs) train
steps, kernel path.

``--sampling`` stops after the sampler paths; ``--train`` runs the train
steps alone; ``--dit-train`` times the DiT-L/2 train step alone (its
kernel path); ``--dit-xl`` profiles the DiT path's sampler step alone with
DiT-XL/2 (``configs/latent-dehazing/train/dit.yml`` with ``which_model:
DiT_XL_2``: 28 blocks, heads of 72) in its place; ``--package CHECKOUT`` imports
the port from another checkout of the repository (``chip_compare.py
--enqueue`` times two checkouts' host enqueue with the same script).
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
FORMS = ("eager", "captured")
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


def captured(run):
    """``run`` (a chain on tensors it holds) replayed from its captured CUDA
    graph, as the samplers replay theirs."""
    import torch

    from image_restoration_sde_tpu_torch.sde.captured import ChainGraphs

    graphs, anchor = ChainGraphs(), torch.zeros(1, device="cuda")
    return lambda: graphs(("run",), lambda _: run(), (anchor,))


def profile_steps(name, run, forward, steps=STEPS):
    """``run()``: ``steps`` sampler steps; ``forward()``: one net forward.
    One line a form of FORMS: eager, and ``run`` captured (``captured``)."""
    import torch

    for form in FORMS:
        call = run if form == "eager" else captured(run)
        with torch.inference_mode():
            call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps * 1e3
            hosts = []
            for _ in range(ENQUEUE_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                hosts.append((time.perf_counter() - t0) / steps * 1e3)
            torch.cuda.synchronize()
            extra = f"host {statistics.median(hosts):.3f} ms/step; "
            if form == "eager":
                enqueues = []
                for _ in range(ENQUEUE_REPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    forward()
                    enqueues.append((time.perf_counter() - t0) * 1e3)
                extra = f"host enqueue {statistics.median(enqueues):.3f} ms/forward; " + extra
                torch.cuda.synchronize()
            kernels = device_times(call, steps)
        report(name if form == "eager" else f"{name} {form}", kernels, wall, extra)


def device_times(run, steps):
    """{kernel name: device ms per step} of ``run()`` (``steps`` steps)
    under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels, count = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.device_time_total / 1e3 / steps  # ms per step
            count += 1
    print(f"[device-ops] {count / steps:.0f} device operations a step (kernels and copies the profiler saw)")
    return kernels


def report(name, kernels, wall, extra=""):
    """Print wall and device time per step, the busy share, the top
    kernels and the port's kernels' share."""
    busy = sum(kernels.values())
    if not busy:
        print(f"[{name}] wall {wall:.3f} ms/step; {extra}device busy not measured (the profiler saw no kernel)")
        return
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


def profile_train_task(name, build, args, extra=""):
    """One train step of the task ``build(capture)`` on ``args`` (``(lq,
    gt[, cond])``, or ``(gt,)`` for denoising) in each form of FORMS: the
    eager step, and the step replayed from its captured graph (the train
    entry point's on the card): wall ms per step (host clock around
    TRAIN_STEPS steps ending in a synchronisation, after two steps, the
    captured form's first capturing), host ms per step (the same steps with
    no synchronisation, started on an idle card), device time by kernel,
    the busy and idle share, and the peak memory."""
    import gc

    import torch

    for form in FORMS:
        task = build(form == "captured")
        step_gen = torch.Generator(device=args[0].device).manual_seed(SEED + 2)
        head, tail = (args[:2], args[2:]) if len(args) > 1 else (args, ())

        def run(n=TRAIN_STEPS):
            for _ in range(n):
                task._train_step(task.state, *head, step_gen, *tail)

        torch.cuda.reset_peak_memory_stats()
        run(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
        t0 = time.perf_counter()
        run()
        host = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        graphs = task._train_step.graphs if form == "captured" else None
        launch = ""
        if graphs is not None:  # the graph's own launch, apart from the step's other host work
            ((_, entry),) = graphs.entries()
            t0 = time.perf_counter()
            entry.graph.replay()
            launch = f"of it the graph's launch {(time.perf_counter() - t0) * 1e3:.3f} ms; "
            torch.cuda.synchronize()
        report(name if form == "eager" else f"{name} {form}", device_times(run, TRAIN_STEPS), wall,
               f"{extra}host {host:.3f} ms/step, {launch}peak {peak:.2f} GiB; ")
        if graphs is not None:  # the graphs' pool goes with them and the gradients in it
            graphs.clear()
            task.state.optimizer.zero_grad()
        del task, run, graphs
        gc.collect()
        torch.cuda.empty_cache()


def train_task(dev, raw, plain=False):
    """``build(capture)`` of the task of the train YAML ``raw`` (its nets'
    plain path where ``plain``; a latent task's compressor seeded)."""
    from image_restoration_sde_tpu_torch import runners
    from image_restoration_sde_tpu_torch.utils import options

    raw = {**raw, "path": {**raw["path"], "pretrain_model_L": None}}
    for key in ("network_G", "network_L"):
        if key in raw:
            raw[key] = {**raw[key], "setting": {**raw[key]["setting"], "plain": plain}}
    return lambda capture: runners.build_task(options.dict_to_nonedict(raw), SEED, dev, capture=capture)


def load_train(*path):
    import yaml

    with open(os.path.join(REPO, "configs", *path)) as f:
        return yaml.safe_load(f)


def profile_train(dev, gen):
    """One train step of each train path (module docstring) in both forms:
    DiT-L/2 first, on a card nothing else has used; the pixel paths on the
    kernel path and the plain path, TF32 off and at torch's default; then
    the latent NAFNet, compressor, bokeh and stereo paths."""
    import torch

    profile_latent_train(dev, gen, (("dit", (False,)),))

    lq = torch.rand(4, 128, 128, 3, generator=gen, device=dev)
    gt = (lq - 0.2 * torch.rand(lq.shape, generator=gen, device=dev)).clamp(0, 1)
    default_tf32 = torch.backends.cudnn.allow_tf32
    for cfg in ("ir-sde", "refusion"):
        raw = load_train("deraining", "train", f"{cfg}.yml")
        for plain in (False, True):
            for tf32 in (False, True):
                torch.backends.cudnn.allow_tf32 = tf32
                name = f"train {cfg} {'plain' if plain else 'kernel'} path, cuDNN TF32 {'on' if tf32 else 'off'}"
                profile_train_task(name, train_task(dev, raw, plain), (lq, gt), "batch 4 at 128 px, float32; ")
    torch.backends.cudnn.allow_tf32 = default_tf32
    profile_latent_train(dev, gen, (("nasde", (False, True)),))
    profile_other_train(dev, gen)


def profile_latent_train(dev, gen, cfgs=(("nasde", (False, True)), ("dit", (False,)))):
    """One train step of the latent train paths (module docstring): each
    (YAML stem, its plain flags) of ``cfgs``."""
    import torch

    lq = torch.rand(8, 1024, 1024, 3, generator=gen, device=dev)
    gt = (lq - 0.2 * torch.rand(lq.shape, generator=gen, device=dev)).clamp(0, 1)
    for cfg, paths in cfgs:
        raw = load_train("latent-dehazing", "train", f"{cfg}.yml")
        for plain in paths:
            name = f"train {cfg} {'plain' if plain else 'kernel'} path, cuDNN TF32 on"
            profile_train_task(name, train_task(dev, raw, plain), (lq, gt), "batch 8 at 1024 px, float32; ")


def profile_other_train(dev, gen):
    """One train step of the compressor, latent bokeh and stereo train
    paths at their YAMLs' batch and crop, kernel path, cuDNN TF32 on."""
    import torch

    def pair(batch, size, channels=3):
        lq = torch.rand(batch, size, size, channels, generator=gen, device=dev)
        return lq, (lq - 0.2 * torch.rand(lq.shape, generator=gen, device=dev)).clamp(0, 1)

    lens = tuple(torch.rand(8, generator=gen, device=dev) * s for s in (160.0, 160.0, 1.0))
    for cfg, path, args in (("compressor", ("unet-latent", "train", "train_haze.yml"), pair(16, 256)),
                            ("bokeh", ("latent-bokeh", "train", "refusion.yml"), (*pair(8, 512), lens)),
                            ("stereo", ("stereo-sr", "train", "refusion.yml"), pair(8, 128, 6))):
        raw = load_train(*path)
        ds = raw["datasets"]["train"]
        as_yaml = (ds["batch_size"], ds["GT_size"]) == tuple(args[0].shape[:2])
        name = f"train {cfg} kernel path, cuDNN TF32 on"
        extra = f"batch {ds['batch_size']} at {ds['GT_size']} px{'' if as_yaml else ' (not the YAML)'}, float32; "
        profile_train_task(name, train_task(dev, raw), args, extra)


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sampling", action="store_true", help="the sampler paths only, no train step")
    parser.add_argument("--package", default=REPO, help="the checkout whose port is imported")
    parser.add_argument("--dit-train", action="store_true", help="the DiT-L/2 train step only")
    parser.add_argument("--train", action="store_true", help="the train steps only, no sampler path")
    parser.add_argument("--dit-xl", action="store_true", help="the DiT-XL/2 sampler step only")
    parser.add_argument("--form", choices=("eager", "captured", "both"), default="both",
                        help="the sampler chains and train steps eager, captured as one CUDA graph, or both "
                             "(default)")
    args = parser.parse_args(argv)
    global FORMS
    FORMS = FORMS if args.form == "both" else (args.form,)
    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import yaml

    sys.path.insert(0, os.path.abspath(args.package))
    from image_restoration_sde_tpu_torch.models import (
        ConditionalNAFNet, ConditionalUNet, UNet, build_network, init_params_,
    )
    from image_restoration_sde_tpu_torch.sampling import make_noise_fn
    from image_restoration_sde_tpu_torch.sde import IRSDE, DenoisingSDE, samplers

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    if args.dit_train or args.train:
        if args.train:
            profile_train(dev, gen)
        else:
            profile_latent_train(dev, gen, (("dit", (False,)),))
        print_card()
        return 0

    def load(*path):
        with open(os.path.join(REPO, "configs", *path)) as f:
            return yaml.safe_load(f)

    def seeded(net):
        return init_params_(net, torch.Generator().manual_seed(SEED)).to(dev).eval()

    def make_sde(opt):
        s = opt["sde"]
        return IRSDE.create(s["max_sigma"], s["T"], s["schedule"], s["eps"], device=dev)

    if args.dit_xl:
        opt = load("latent-dehazing", "train", "dit.yml")
        compressor = seeded(UNet(**opt["network_L"]["setting"]))
        dit = seeded(build_network("DiT_XL_2", opt["network_G"]["setting"], dtype=torch.bfloat16))
        img = torch.rand(2, 1024, 1024, 3, generator=gen, device=dev)
        with torch.inference_mode():
            latent, _ = compressor.encode(img)
        profile_steps("dit-xl", *posterior(make_noise_fn(dit, torch.bfloat16), latent + 0.1, latent, make_sde(opt)))
        print_card()
        return 0

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
    if not args.sampling:
        profile_train(dev, gen)
    print_card()
    return 0


def print_card():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[card] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")


if __name__ == "__main__":
    sys.exit(main())
