#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

The main path is IR-SDE deraining with ConditionalUNet(nf=64, depth=4) in
bf16 with float32 parameters, 128 px images at batch 8, the cosine T=100
schedule and 100-step reverse sampling (configs/deraining/test/ir-sde.yml).
Weights are random, made from a seed.  Phases, each printing its lines:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels, from this checkout's sources;
3. kernels: each kernel against its plain PyTorch version at the path's
   shapes, float32 and bfloat16, with both times (CUDA events);
4. net: one forward of the full-width net, kernel path against plain path;
   and a 100-step float32 chain on a small input, kernel against plain;
5. main path: the sampler serves two posterior batches of 8, one sde batch
   of 8 and one odd-size single image; the kernel launch counts must be
   exactly 18 (K1) and 9 (K2a, K2b) per net call.

Then one JSON line with each kernel's launches, error and times, and last
``{"ok": true, "device": {...}}``.  Any failed check raises: the script
exits non-zero and prints no result.  Without CUDA it exits at once.

TF32 is off for the whole run (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` False), so float32 comparisons
are float32 on both sides.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "deraining", "test", "ir-sde.yml")
BATCH, SIZE, SEED = 8, 128, 0
ODD_HW = (100, 140)
LN_PER_FORWARD, ATTN_PER_FORWARD = 18, 9


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_bound(ref):
    """Per element: one bfloat16 ulp at its magnitude (both sides round a
    float32 value, either way) plus the float32 bound, 1e-5 of max|ref|
    (near-zero outputs are sums that cancel)."""
    import torch

    mag = ref.float().abs().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7) + 1e-5 * mag.max()


def path_shapes():
    """(C, rows) of the 18 LayerNorm sites and N of the 9 attention sites
    of one ConditionalUNet(nf=64, depth=4) forward at batch 8, 128 px."""
    ln, attn = [], []
    for i in range(4):
        res = SIZE >> i
        down_c, up_c = 64 << i, 64 << (i + 1)
        ln += [(down_c, BATCH * res * res)] * 2 + [(up_c, BATCH * res * res)] * 2
        attn += [res * res] * 2
    mid = SIZE >> 3
    ln += [(1024, BATCH * mid * mid)] * 2
    attn += [mid * mid]
    return ln, attn


# ---------------------------------------------------------------- phases
def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.device_count()} visible; nvidia-smi:")
    print(smi)
    return smi


def phase_build():
    from image_restoration_sde_tpu_torch import kernels

    path, seconds = kernels.build()
    kernels.load_library()
    print(f"[build] {path.relative_to(REPO)} built in {seconds:.1f} s")
    for line in (path.parent / "ptxas.log").read_text().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build]   {line.strip()}")


def phase_kernels(dev, stats):
    import torch

    from image_restoration_sde_tpu_torch.ops import layernorm as LN
    from image_restoration_sde_tpu_torch.ops import linear_attention as LA

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    ln_sites, attn_sites = path_shapes()

    # K1: bf16 (eps 1e-3) and f32 (eps 1e-5); bound: f32 1e-5 of max|y|,
    # bf16 bf16_bound
    shapes = sorted(set(ln_sites)) + [(64, 1001), (1024, 999)]
    for dtype, eps in ((torch.bfloat16, 1e-3), (torch.float32, 1e-5)):
        for C, rows in shapes:
            x = (torch.randn(rows, C, generator=gen, device=dev) * 2 + 0.5).to(dtype)
            g = torch.randn(C, generator=gen, device=dev) * 0.2 + 1
            y = LN.channel_layernorm_cuda(x, g, eps)
            ref = LN.channel_layernorm_plain(x, g, eps)
            err = (y.float() - ref.float()).abs()
            if dtype == torch.float32:
                ok = err.max().item() <= 1e-5 * ref.abs().max().item()
            else:
                ok = bool((err <= bf16_bound(ref)).all())
            stats[LN.LAYERNORM]["err"] = max(stats[LN.LAYERNORM]["err"], err.max().item())
            check(ok, f"K1 {dtype} C={C} rows={rows}: max|dy|={err.max().item():.3g}")
            ms = cuda_ms(lambda: LN.channel_layernorm_cuda(x, g, eps))
            pms = cuda_ms(lambda: LN.channel_layernorm_plain(x, g, eps))
            print(f"[kernels] K1 {str(dtype)[6:]:8s} C={C:5d} rows={rows:6d} max|dy|={err.max().item():.3g} "
                  f"kernel {ms:.4f} ms plain {pms:.4f} ms")
            if dtype == torch.bfloat16 and (C, rows) in ln_sites:
                n = ln_sites.count((C, rows))
                stats[LN.LAYERNORM]["ms"] += n * ms
                stats[LN.LAYERNORM]["plain_ms"] += n * pms

    # K2a / K2b at the path's N, plus a ragged N; bound: ctx (f32) and f32
    # outputs 1e-5 of max|ref|; bf16 outputs bf16_bound
    for dtype in (torch.bfloat16, torch.float32):
        for N in sorted(set(attn_sites), reverse=True) + [36]:
            qkv = (torch.randn(BATCH, N, 384, generator=gen, device=dev) * 1.5).to(dtype)
            ctx = LA.linear_attention_ctx_cuda(qkv)
            ctx_ref = LA.linear_attention_ctx_plain(qkv)
            cerr = (ctx - ctx_ref).abs().max().item()
            check(cerr <= 1e-5 * ctx_ref.abs().max().item(), f"K2a {dtype} N={N}: max|dctx|={cerr:.3g}")
            out = LA.linear_attention_apply_cuda(qkv, ctx_ref)
            ref = LA.linear_attention_apply_plain(qkv, ctx_ref)
            err = (out.float() - ref.float()).abs()
            if dtype == torch.float32:
                ok = err.max().item() <= 1e-5 * ref.abs().max().item()
            else:
                ok = bool((err <= bf16_bound(ref)).all())
            check(ok, f"K2b {dtype} N={N}: max|dout|={err.max().item():.3g}")
            stats[LA.LA_CTX]["err"] = max(stats[LA.LA_CTX]["err"], cerr)
            stats[LA.LA_APPLY]["err"] = max(stats[LA.LA_APPLY]["err"], err.max().item())
            ms_c = cuda_ms(lambda: LA.linear_attention_ctx_cuda(qkv))
            pms_c = cuda_ms(lambda: LA.linear_attention_ctx_plain(qkv))
            ms_a = cuda_ms(lambda: LA.linear_attention_apply_cuda(qkv, ctx_ref))
            pms_a = cuda_ms(lambda: LA.linear_attention_apply_plain(qkv, ctx_ref))
            print(f"[kernels] K2 {str(dtype)[6:]:8s} N={N:5d} max|dctx|={cerr:.3g} max|dout|={err.max().item():.3g} "
                  f"K2a {ms_c:.4f} ms plain {pms_c:.4f} ms | K2b {ms_a:.4f} ms plain {pms_a:.4f} ms")
            if dtype == torch.bfloat16 and N in attn_sites:
                n = attn_sites.count(N)
                stats[LA.LA_CTX]["ms"] += n * ms_c
                stats[LA.LA_CTX]["plain_ms"] += n * pms_c
                stats[LA.LA_APPLY]["ms"] += n * ms_a
                stats[LA.LA_APPLY]["plain_ms"] += n * pms_a


def make_net(setting, dtype, plain, dev, state=None):
    import torch

    from image_restoration_sde_tpu_torch.models import ConditionalUNet, init_params_

    net = ConditionalUNet(**setting, dtype=dtype, plain=plain)
    if state is None:
        gen = torch.Generator()
        gen.manual_seed(SEED)
        init_params_(net, gen)
    else:
        net.load_state_dict(state)
    return net.to(dev).eval()


def phase_net(dev, setting, sde_opt):
    import torch

    from image_restoration_sde_tpu_torch.sampling import make_restoration_sampler
    from image_restoration_sde_tpu_torch.sde import IRSDE

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    lq = torch.rand(BATCH, SIZE, SIZE, 3, generator=gen, device=dev)
    xt = lq + 10 / 255 * torch.randn(lq.shape, generator=gen, device=dev)
    t = torch.randint(1, 101, (BATCH,), generator=gen, device=dev)

    nets, state = {}, None
    for dtype in (torch.bfloat16, torch.float32):
        for plain in (False, True):
            nets[dtype, plain] = make_net(setting, dtype, plain, dev, state)
            state = nets[dtype, plain].state_dict()
    with torch.inference_mode():
        outs = {key: net(xt, lq, t) for key, net in nets.items()}
    torch.cuda.synchronize()
    for o in outs.values():
        check(o.shape == (BATCH, SIZE, SIZE, 3) and bool(torch.isfinite(o).all()), "net output shape/finite")
    f32_ref = outs[torch.float32, True]
    # f32: kernel and plain path agree to float32 rounding through the net
    f32_err = (outs[torch.float32, False] - f32_ref).abs().max().item()
    f32_bound = 1e-4 * f32_ref.abs().max().item()
    # bf16: the kernel path may differ from the plain bf16 path by at most
    # twice the plain bf16 path's own distance from float32
    bf_err = (outs[torch.bfloat16, False] - outs[torch.bfloat16, True]).abs().max().item()
    bf_floor = (outs[torch.bfloat16, True] - f32_ref).abs().max().item()
    print(f"[net] nf={setting['nf']} depth={setting['depth']} batch {BATCH} {SIZE}px: "
          f"f32 kernel-vs-plain max|d|={f32_err:.3g} (bound {f32_bound:.3g}); "
          f"bf16 kernel-vs-plain max|d|={bf_err:.3g} (bound 2 x bf16-vs-f32 {bf_floor:.3g})")
    check(f32_err <= f32_bound, "f32 net: kernel path differs from plain path")
    check(bf_err <= 2 * bf_floor, "bf16 net: kernel path differs from plain path")

    # 100-step f32 posterior chain, kernel vs plain, on a small input with
    # the same seeded noise; bound 1e-3 of max|ref|
    sde = IRSDE.create(sde_opt["max_sigma"], sde_opt["T"], sde_opt["schedule"], sde_opt["eps"], device=dev)
    small = lq[:2, :32, :32]
    chain = {}
    for plain in (False, True):
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 2)
        chain[plain] = make_restoration_sampler(sde, nets[torch.float32, plain], mode="posterior")(small, g)
    c_err = (chain[False] - chain[True]).abs().max().item()
    c_bound = 1e-3 * chain[True].abs().max().item()
    print(f"[net] 100-step f32 posterior chain 2x32x32 kernel-vs-plain max|d|={c_err:.3g} (bound {c_bound:.3g})")
    check(bool(torch.isfinite(chain[False]).all()) and c_err <= c_bound, "f32 chain: kernel path differs from plain path")
    return nets[torch.bfloat16, False]


def phase_main_path(dev, net, sde_opt, smi):
    import torch

    from image_restoration_sde_tpu_torch.ops import KERNELS, LA_APPLY, LA_CTX, LAYERNORM
    from image_restoration_sde_tpu_torch.sampling import make_restoration_sampler, pad_to_bucket, unpad
    from image_restoration_sde_tpu_torch.sde import IRSDE

    sde = IRSDE.create(sde_opt["max_sigma"], sde_opt["T"], sde_opt["schedule"], sde_opt["eps"], device=dev)
    samplers = {m: make_restoration_sampler(sde, net, mode=m) for m in ("posterior", "sde")}
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    rng = np.random.default_rng(SEED + 3)
    requests = [("posterior", rng.random((BATCH, SIZE, SIZE, 3), np.float32)),
                ("posterior", rng.random((BATCH, SIZE, SIZE, 3), np.float32)),
                ("sde", rng.random((BATCH, SIZE, SIZE, 3), np.float32)),
                ("posterior", rng.random((1, *ODD_HW, 3), np.float32))]

    for k in KERNELS:
        k.launches = 0
    rates = {}
    for mode, img in requests:
        before = {k.symbol: k.launches for k in KERNELS}
        padded, hw = pad_to_bucket(img)
        lq = torch.from_numpy(padded).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = unpad(samplers[mode](lq, gen), hw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(out.shape == img.shape and out.dtype == torch.float32, f"{mode} output shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{mode} output not finite")
        steps = sde.T  # one chunk: the default runs the whole batch at once
        grew = {k.symbol: k.launches - before[k.symbol] for k in KERNELS}
        want = {LAYERNORM.symbol: LN_PER_FORWARD * steps, LA_CTX.symbol: ATTN_PER_FORWARD * steps,
                LA_APPLY.symbol: ATTN_PER_FORWARD * steps}
        check(grew == want, f"launch counts {grew}, expected {want}")
        if img.shape[0] == BATCH:
            rates[mode] = BATCH / seconds
        print(f"[main] {mode:9s} {img.shape[0]}x{img.shape[1]}x{img.shape[2]} "
              f"(padded {tuple(padded.shape[1:3])}): {seconds:.3f} s, {img.shape[0] / seconds:.3f} img/s, "
              f"launches {grew}")
    launches = {k.symbol: k.launches for k in KERNELS}
    print(f"[main] img/s at batch {BATCH}, {SIZE}px, {sde.T} steps, bf16: posterior {rates['posterior']:.4f}, "
          f"sde {rates['sde']:.4f} (host clock, warm; card: {smi})")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import yaml

    sys.path.insert(0, REPO)
    from image_restoration_sde_tpu_torch.ops import KERNELS

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    with open(CONFIG) as f:
        opt = yaml.safe_load(f)
    sde_opt = opt["sde"]
    setting = opt["network_G"]["setting"]

    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    stats = {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0} for k in KERNELS}
    phase_kernels(dev, stats)
    net = phase_net(dev, setting, sde_opt)
    launches = phase_main_path(dev, net, sde_opt, smi)

    report = [
        {"name": k.symbol, "route": "cuda", "source": k.source, "replaces": k.replaces,
         "launches": launches[k.symbol], "max_abs_err": stats[k]["err"],
         "ms": stats[k]["ms"], "plain_ms": stats[k]["plain_ms"]}
        for k in KERNELS
    ]
    print(f"[done] {time.perf_counter() - t_start:.1f} s; kernel ms / plain_ms: summed over one "
          f"forward's sites at batch {BATCH}, {SIZE}px, bf16")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
