#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Eight paths, each at full width with random weights made from a seed:

- IR-SDE deraining (configs/deraining/test/ir-sde.yml): ConditionalUNet
  (nf=64, depth=4) in bf16 with float32 parameters, 128 px images at
  batch 8, cosine T=100 schedule, 100-step reverse sampling;
- Refusion latent dehazing (configs/latent-dehazing/test/nasde.yml): the
  compressor UNet (ch 8, ch_mult [4, 8, 8, 16], embed_dim 8, float32)
  encodes 512 px images to 64x64x8 latents; ConditionalNAFNet (width 64,
  enc [1, 1, 1, 28], mid 1, dec [1, 1, 1, 1], bf16 with float32 parameters)
  runs 100 reverse steps on them, its 28-block level fused (kernel K3);
  the compressor decodes with the LQ skips;
- Refusion DiT latent dehazing (configs/latent-dehazing/train/dit.yml for
  the network, compressor and SDE; posterior mode and 1024 px are this
  script's serving constants): the same compressor encodes 1024 px images
  to 128x128x8 latents; DiT-L/2 (hidden 1024, 24 blocks, 16 heads of 64:
  4096 tokens, bf16 compute, parameters cast to bf16 once per request)
  runs 100 reverse steps, its attention through kernel K4;
- tiled large images: a 1536x1536 uint8 image as four 1024 px tiles in one
  call of the DiT sampler, blended on the card;
- the public op ``ops.linear_attention.linear_attention`` (kernel K5) at
  the token counts of the deraining UNet's levels;
- Gaussian denoising (configs/denoising/test/ir-sde.yml): the unconditional
  ConditionalUNet (nf=64, depth=4, full attention in the mid block) in bf16,
  DenoisingSDE (max_sigma 70, T 1000, cosine), the reverse ODE from the
  optimal timestep of sigma 50 (414 steps);
- stereo super-resolution (configs/stereo-sr/test/refusion.yml): the stereo
  NAFNet (width 64, enc [1, 1, 1, 28], mid 1, dec [1, 1, 1, 1], a SCAM after
  every block) in bf16, 100 posterior steps;
- latent bokeh (configs/latent-bokeh/test/refusion.yml): the compressor
  UNet (ch 64, ch_mult [1, 2, 4], embed_dim 4) and the bokeh NAFNet (width
  64, enc [2, 2, 4, 8], mid 12, dec [2, 2, 2, 2], lens conditioning) in
  bf16, 100 posterior steps on H/4 latents.

Phases, each printing its lines and its seconds:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels, from this checkout's sources;
3. kernels: each kernel against its plain PyTorch version at the paths'
   shapes (K1 and K2 at every path's, the DiT and tiled requests'
   compressor included), float32 and bfloat16, with both times, the time
   of one PyTorch call computing the same function where there is one, and
   the least time the card could take (bytes or operations at the H100's
   published peaks; K3's at the float32 rate its arithmetic runs at); K1
   and K2 at the deraining sites, K2 also at the denoising 512 px
   request's (and K5 in phase 12) timed from a CUDA graph of 20
   back-to-back calls, since one launch between CUDA events reads the
   host's enqueue, with that earlier figure beside it; K2 run twice on
   every input, the two runs bit-equal; K3 also block by block, as
   chained one-block launches that must end bit-equal to the one launch;
   the packed op's gradient on the card against the plain composition's,
   and K1, K3 and K4 raising under grad (they have no backward yet);
4. net: one forward of the full-width UNet, kernel path against plain
   path; and a 100-step float32 chain on a small input, kernel against plain;
5. main path: the deraining sampler serves two posterior batches of 8, one
   sde batch of 8 and one odd-size single image; per net call exactly 18
   K1 and 9 K2a, K2b launches, and no K3;
6. latent net: one forward of the full-width latent NAFNet and one of the
   deraining Refusion NAFNet (configs/deraining/test/refusion.yml, 128 px,
   batch 8), and the compressor's encode and decode at batch 4, 512 px and
   at 704x1024, each kernel path against plain path;
7. latent main path: the latent sampler serves two posterior batches of 4
   at 512 px, one sde batch of 4 and one 700x1000 image (padded to
   704x1024); per 100-step request exactly 100 K3, 16 x 100 + 4 K1, 2 K2a
   and 2 K2b launches;
8. DiT kernels: K4 against its plain version in float32 and bfloat16 at
   (B, N, H, D) = (2, 4096, 16, 64) (the slice), (1, 2816, 16, 64) (the
   odd request), (2, 1024, 16, 64) (512 px), (1, 4096, 16, 72) (DiT-XL's
   head), (1, 1000, 16, 64) and (3, 35, 4, 64) (ragged), (4, 4096, 16, 64)
   (the tiled call), and on strided views of a packed qkv; bfloat16 also
   against a plain version that rounds p where the kernel does; beside
   F.scaled_dot_product_attention and the bound;
9. DiT net: one forward of DiT-L/2 at batch 2 on 128x128x8 latents, kernel
   path against plain path, float32 and bfloat16; the path's compressor,
   kernel path against plain path, at each DiT request's shape and at the
   tiled call's (batch 4, 1024 px);
10. DiT main path: the latent sampler serves two posterior batches of 2 at
   1024 px, one sde batch of 2 and one 1000x700 image (padded to
   1024x704: 2816 tokens); per 100-step request exactly 2400 K4, 4 K1,
   2 K2a, 2 K2b and no K3 launches;
11. tiled path: ``tiling.tiled_restore_device`` on a 1x1536x1536 uint8
   image, tile 1024, overlap 64, tile_batch 4 (four tiles, one sampler
   call: 2400 K4 launches);
12. linear attention: the op path at (BH, N, d) = (32, 16384, 32),
   (32, 4096, 32), (32, 1024, 32), (32, 256, 32) (the deraining UNet's
   levels at batch 8 x 4 heads), (6, 1000, 32), (8, 4096, 16) and
   (8, 4096, 64), float32 and bfloat16, one context and one apply launch
   per call; each against its plain version, both passes timed beside
   their plain halves and the bound; one gradient through the op;
13. denoise net: one forward of the unconditional UNet at batch 8, 128 px,
   kernel path against plain path (17 K1, 8 K2a, 8 K2b per forward), and
   K1, K2 at its sites and those of the 512 px request;
14. denoise main path: ``make_denoising_sampler`` (t0 = 414) serves a batch
   of 8 noisy 128 px images and one 500x500 image (padded to 512x512)
   twice; per request exactly 7038 K1, 3312 K2a and 3312 K2b launches;
15. stereo net: one forward at batch 4 pairs, 128 px, kernel path against
   plain path (144 K1 per forward, no K3), and K1 at its sites and those
   of the 140x200 request;
16. stereo main path: the restoration sampler serves two posterior batches
   of 4 pairs at 128 px and one 140x200 pair (the net pads it to 144x208:
   SCAM at 18x26 and 9x13); per request exactly 14400 K1 launches;
17. bokeh net: the compressor's kernel path against its plain path at
   batch 4, 512 px and at 704x1024; the bokeh NAFNet's at batch 4 on
   128x128x4 latents (72 K1 per forward, no K3); K1, K2 at both nets' sites;
18. bokeh main path: the latent sampler with seeded lens values serves two
   posterior batches of 4 at 512 px and one 700x1000 image (padded to
   704x1024); per request exactly 7204 K1, 2 K2a and 2 K2b launches.

K1 is also timed over one bf16 forward of each path's score net (phases 3,
6, 13, 15 and 17: each site from a CUDA graph of 20 calls, beside
F.layer_norm and the bound by bytes), one ``[k1-path]`` line a path and
``by_path`` on K1's entry of the JSON line.

Launch counts are set to 0 just before each main path and read just after.
Then one JSON line with each kernel's launches, error, times and bound, and
last ``{"ok": true, "device": {...}}``.  Any failed check raises: the
script exits non-zero and prints no result.  Without CUDA it exits at once.

TF32 is off for the whole run (``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` False), so float32 comparisons
are float32 on both sides.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "deraining", "test", "ir-sde.yml")
LATENT_CONFIG = os.path.join(REPO, "configs", "latent-dehazing", "test", "nasde.yml")
REFUSION_CONFIG = os.path.join(REPO, "configs", "deraining", "test", "refusion.yml")
DIT_CONFIG = os.path.join(REPO, "configs", "latent-dehazing", "train", "dit.yml")
DENOISE_CONFIG = os.path.join(REPO, "configs", "denoising", "test", "ir-sde.yml")
STEREO_CONFIG = os.path.join(REPO, "configs", "stereo-sr", "test", "refusion.yml")
BOKEH_CONFIG = os.path.join(REPO, "configs", "latent-bokeh", "test", "refusion.yml")
BATCH, SIZE, SEED = 8, 128, 0
ODD_HW = (100, 140)
LN_PER_FORWARD, ATTN_PER_FORWARD = 18, 9
LATENT_BATCH, LATENT_SIZE, LATENT_ODD_HW = 4, 512, (700, 1000)
# per latent request: K1 at the 8 unfused NAFBlocks (2 each) per step plus
# the compressor's 4 (deepest level, encode and decode); K2 twice; K3 once
# per step
NAF_LN_PER_FORWARD, COMPRESSOR_LN, COMPRESSOR_ATTN = 16, 4, 2
# the DiT path's serving constants: posterior sampling at 1024 px, batch 2
DIT_MODE, DIT_BATCH, DIT_SIZE, DIT_ODD_HW = "posterior", 2, 1024, (1000, 700)
TILED_HW, TILE, TILE_OVERLAP, TILE_BATCH = (1536, 1536), 1024, 64, 4
# K5's (BH, N, d): the deraining UNet's 128, 64, 32 and 16 px levels at
# batch 8 x 4 heads (K5b's and K5a's regimes on the TPU), an N where the JAX
# op falls back to its composition, and the other two head dims; one
# gradient through the op at LIN_ATTN_GRAD_SHAPE
LIN_ATTN_SHAPES = [(32, 16384, 32), (32, 4096, 32), (32, 1024, 32), (32, 256, 32), (6, 1000, 32),
                   (8, 4096, 16), (8, 4096, 64)]
LIN_ATTN_GRAD_SHAPE = (4, 1000, 32)
# the serving constants of the denoising, stereo and bokeh paths: batch 8
# at 128 px (the train crop) and one 500x500 image (McMaster's size),
# sigma 50 -> t0 = 414 reverse ODE steps; batch 4 pairs at 128 px and one
# 140x200 pair; batch 4 at 512 px (the train GT_size) and one 700x1000
# image.  K1 and K2 launches per net forward
DENOISE_ODD_HW, DENOISE_T0, DENOISE_LN_PER_FORWARD, DENOISE_ATTN_PER_FORWARD = (500, 500), 414, 17, 8
STEREO_BATCH, STEREO_ODD_HW, STEREO_LN_PER_FORWARD = 4, (140, 200), 144
BOKEH_BATCH, BOKEH_SIZE, BOKEH_ODD_HW, BOKEH_LN_PER_FORWARD = 4, 512, (700, 1000), 72
# K4's (B, N, H, D): the slice first; phase 8 adds the shapes of every DiT
# and tiled request (dit_path_shapes) that are not among these
FLASH_SHAPES = [(2, 4096, 16, 64), (1, 2816, 16, 64), (2, 1024, 16, 64), (1, 4096, 16, 72),
                (1, 1000, 16, 64), (3, 35, 4, 64)]
# bf16 K4 against flash_mha_tiled_plain: the share of elements that may lie
# past two ulps (a p whose rounding a float32 difference in s flips)
FLASH_FLIP_SHARE = 5e-4
# NVIDIA H100 SXM published peaks (dense): HBM bytes/s, and FLOP/s for
# bfloat16 on the tensor cores and float32 outside them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


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


def graph_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Milliseconds per call of ``fn`` on the card: ``n`` back-to-back calls
    captured in one CUDA graph and replayed (median of ``reps`` replays,
    CUDA events) over ``n``.  For kernels shorter than the host's ~40 us
    per launch, where ``cuda_ms`` around one launch reads the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(times)


def bf16_bound(ref, ulps: int = 1):
    """Per element: ``ulps`` bfloat16 ulps at its magnitude (both sides
    round a float32 value, either way) plus the float32 bound, 1e-5 of
    max|ref| (near-zero outputs are sums that cancel)."""
    import torch

    mag = ref.float().abs().clamp_min(2.0**-126)
    return ulps * torch.exp2(torch.floor(torch.log2(mag)) - 7) + 1e-5 * mag.max()


def bound(nbytes: float, flops: float, dtype: str):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    HBM rate and the operations over the peak rate for ``dtype``."""
    ms_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ms_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (ms_bytes, "bytes") if ms_bytes >= ms_ops else (ms_ops, "operations")


def naf_blocks(K, C, T, dev, seed):
    """K NAFBlocks' tensors in the reference key space, on the card: kernels
    with variance 1/fan_in, biases and residual scales ~0.1-0.2, gains ~1."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + shift

    return [{
        "conv1.weight": randn(2 * C, C, 1, 1, scale=C**-0.5), "conv1.bias": randn(2 * C, scale=0.1),
        "conv2.weight": randn(2 * C, 1, 3, 3, scale=1 / 3), "conv2.bias": randn(2 * C, scale=0.1),
        "sca.1.weight": randn(C, C, 1, 1, scale=C**-0.5), "sca.1.bias": randn(C, scale=0.1, shift=1.0),
        "conv3.weight": randn(C, C, 1, 1, scale=C**-0.5), "conv3.bias": randn(C, scale=0.1),
        "conv4.weight": randn(2 * C, C, 1, 1, scale=C**-0.5), "conv4.bias": randn(2 * C, scale=0.1),
        "conv5.weight": randn(C, C, 1, 1, scale=C**-0.5), "conv5.bias": randn(C, scale=0.1),
        "norm1.g": randn(1, C, 1, 1, scale=0.2, shift=1.0), "norm2.g": randn(1, C, 1, 1, scale=0.2, shift=1.0),
        "beta": randn(1, C, 1, 1, scale=0.2), "gamma": randn(1, C, 1, 1, scale=0.2),
        "mlp.1.weight": randn(4 * C, T // 2, scale=(T // 2) ** -0.5), "mlp.1.bias": randn(4 * C, scale=0.1),
    } for _ in range(K)]


def naf_stack_work(x, blocks):
    """(bytes, FLOP) that K3 must move and do on x (B, H, W, C): each weight
    it reads, x, tmod and the output once; per pixel and block the four 1x1
    products (12 C^2), the depthwise conv (36 C), norms, gates and
    residuals (~30 C), and per sample the SCA product (2 C^2)."""
    from image_restoration_sde_tpu_torch.ops.naf_stack import PARAM_ORDER

    B, H, W, C = x.shape
    K = len(blocks)
    weights = sum(blk[k].numel() for blk in blocks for k in PARAM_ORDER) * 4
    nbytes = weights + 2 * x.numel() * x.element_size() + K * B * 4 * C * 4
    flops = K * (B * H * W * (12 * C * C + 36 * C + 30 * C) + B * 2 * C * C)
    return nbytes, flops


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


def denoise_attn_sites():
    """(batch, N) of the 8 K2 sites of one denoising UNet forward on the
    512 px request (the 500x500 image padded): two per level, no mid-block
    linear attention."""
    h, w = pad64(DENOISE_ODD_HW)
    return [(1, (h >> i) * (w >> i)) for i in range(4) for _ in range(2)]


def la_work(batch, N, itemsize):
    """(bytes, FLOP) of one K2a or one K2b call: K2a reads k and v (256 of
    the 384 channels) and writes ctx, K2b reads q and ctx and writes out
    (256 channels of traffic a row either way); 2 FLOP for each of a head's
    32 x 32 products a row, and 4 for each exponential and sum."""
    ctx_bytes = batch * 4 * 32 * 32 * 4
    return batch * N * 256 * itemsize + ctx_bytes, 2 * batch * N * 4 * 32 * 32 + 4 * batch * N * 128


def ln_work(sites):
    """(bytes, FLOP) of K1 over bf16 (C, rows) sites: x read and y written
    once, g (float32) read once a site; ~8 FLOP an element."""
    return sum(2 * rows * C * 2 + C * 4 for C, rows in sites), sum(8 * rows * C for C, rows in sites)


def k1_site_times(dev, sites):
    """{(C, rows): (K1 ms, F.layer_norm ms)} for each distinct bf16 site
    (eps 1e-3, seeded x and g), each from a CUDA graph of 20 calls."""
    import torch
    import torch.nn.functional as F

    from image_restoration_sde_tpu_torch.ops import layernorm as LN

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 23)
    times = {}
    for C, rows in sorted(set(sites)):
        x = (torch.randn(rows, C, generator=gen, device=dev) * 2 + 0.5).bfloat16()
        g = torch.randn(C, generator=gen, device=dev) * 0.2 + 1
        g_lib = g.bfloat16()
        times[C, rows] = (graph_ms(lambda: LN.channel_layernorm_cuda(x, g, 1e-3)),
                          graph_ms(lambda: F.layer_norm(x, (C,), g_lib, None, 1e-3)))
    return times


def k1_path(label, sites, times, stats):
    """Print and record (stats[K1]["by_path"]) K1 over one forward's bf16
    sites: the sum of each site's time, its bound by bytes and
    F.layer_norm's sum."""
    from image_restoration_sde_tpu_torch.ops import LAYERNORM

    ms = sum(times[site][0] for site in sites)
    lms = sum(times[site][1] for site in sites)
    bms, by = bound(*ln_work(sites), "bfloat16")
    print(f"[k1-path] {label}: {len(sites)} K1 launches a forward over {len(set(sites))} (C, rows) sites, bf16: "
          f"K1 {ms:.4f} ms, least {bms:.4f} ms ({by}), F.layer_norm {lms:.4f} ms (graphs of 20 calls per site)")
    stats[LAYERNORM]["by_path"][label] = {"launches": len(sites), "ms": ms, "bound_ms": bms, "bound_by": by,
                                          "library_ms": lms}


def counts(**nonzero):
    """Expected launch counts by kernel symbol: the named kernels' (by
    their ops attribute name), 0 for every other kernel of ops.KERNELS."""
    from image_restoration_sde_tpu_torch import ops

    want = {k.symbol: 0 for k in ops.KERNELS}
    want.update({getattr(ops, name).symbol: n for name, n in nonzero.items()})
    return want


def pad64(hw):
    return tuple(-(-n // 64) * 64 for n in hw)


def latent_requests():
    """(batch, H, W) of the latent path's requests after padding."""
    return [(LATENT_BATCH, LATENT_SIZE, LATENT_SIZE), (1, *pad64(LATENT_ODD_HW))]


def dit_requests():
    """(batch, H, W) of the DiT path's requests after padding, and of the
    tiled path's one sampler call (TILE_BATCH tiles of TILE px)."""
    return [(DIT_BATCH, DIT_SIZE, DIT_SIZE), (1, *pad64(DIT_ODD_HW)), (TILE_BATCH, TILE, TILE)]


def compressor_shapes(comp, requests):
    """(C, rows) of the K1 sites and (batch, N) of the K2 sites of the
    compressor's deepest level at H/8 (K1 at its two widths, K2 once per
    width) for each (batch, H, W) request."""
    ln, attn = set(), set()
    for batch, h, w in requests:
        lh, lw = h // 8, w // 8
        ln |= {(comp["ch"] * m, batch * lh * lw) for m in comp["ch_mult"][-2:]}
        attn.add((batch, lh * lw))
    return ln, attn


def dit_path_shapes(dit_opt):
    """The DiT and tiled paths' kernel shapes: the compressor's K1 (C, rows)
    and K2 (batch, N), and K4's (B, N, H, D) on the latent's patch grid."""
    import torch

    from image_restoration_sde_tpu_torch.models import build_network

    with torch.device("meta"):
        net = build_network(dit_opt["network_G"]["which_model"], dit_opt["network_G"]["setting"])
    p, heads = net.patch_size, net.blocks[0].attn.heads
    dh = net.blocks[0].attn.proj.in_features // heads
    ln, attn = compressor_shapes(dit_opt["network_L"]["setting"], dit_requests())
    flash = [(batch, (h // 8 // p) * (w // 8 // p), heads, dh) for batch, h, w in dit_requests()]
    return sorted(ln), sorted(attn), flash


def latent_path_shapes(latent_opt):
    """(C, rows) of the K1 sites and (batch, N) of the K2 sites that the
    latent path gives its kernels, for both request shapes (batch 4 at
    512 px, and one 700x1000 image padded to 704x1024): the compressor's
    (compressor_shapes), and the NAFNet's levels that run an unfused block,
    on the latent zero-padded to a multiple of 2^depth (a run of 4 or more
    blocks runs K3 instead)."""
    naf = latent_opt["network_G"]["setting"]
    enc, dec = naf["enc_blk_nums"], naf["dec_blk_nums"]
    runs = [(enc[i], dec[len(dec) - 1 - i]) for i in range(len(enc))] + [(naf["middle_blk_num"],)]
    ln, attn = compressor_shapes(latent_opt["network_L"]["setting"], latent_requests())
    for batch, h, w in latent_requests():
        lh, lw = h // 8, w // 8
        pad = 2 ** len(enc)
        ph, pw = -(-lh // pad) * pad, -(-lw // pad) * pad
        for i, nums in enumerate(runs):
            if any(0 < n < 4 for n in nums):
                ln.add((naf["width"] << i, batch * (ph >> i) * (pw >> i)))
    return sorted(ln), sorted(attn)


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
        if any(w in line for w in ("Used", "spill", "Compiling entry", "Performance", "setmaxnreg", "rror")):
            print(f"[build]   {line.strip()}")


def phase_kernels(dev, stats, latent_opt, dit_opt):
    import torch
    import torch.nn.functional as F

    from image_restoration_sde_tpu_torch.ops import layernorm as LN
    from image_restoration_sde_tpu_torch.ops import linear_attention as LA

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    ln_sites, attn_sites = path_shapes()
    latent_ln, latent_attn = latent_path_shapes(latent_opt)
    dit_ln, dit_attn, _ = dit_path_shapes(dit_opt)

    # K1 at the deraining path's sites (the ones its stats sum), two ragged
    # shapes and the latent, DiT and tiled paths' sites: bf16 (eps 1e-3) and
    # f32 (eps 1e-5); bound: f32 1e-5 of max|y|, bf16 bf16_bound.  Library
    # call: F.layer_norm on the same rows (its bias-free affine with g in
    # x's dtype)
    shapes = sorted(set(ln_sites))
    shapes += sorted({(64, 1001), (1024, 999), *latent_ln, *dit_ln} - set(shapes))
    site_times = {}
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
            g_lib = g.to(dtype)
            timer = graph_ms if dtype == torch.bfloat16 and (C, rows) in ln_sites else cuda_ms
            ms = timer(lambda: LN.channel_layernorm_cuda(x, g, eps))
            pms = timer(lambda: LN.channel_layernorm_plain(x, g, eps))
            lms = timer(lambda: F.layer_norm(x, (C,), g_lib, None, eps))
            ems = cuda_ms(lambda: LN.channel_layernorm_cuda(x, g, eps)) if timer is graph_ms else ms
            how = "graph of 20" if timer is graph_ms else "events"
            print(f"[kernels] K1 {str(dtype)[6:]:8s} C={C:5d} rows={rows:6d} max|dy|={err.max().item():.3g} "
                  f"kernel {ms:.4f} ms plain {pms:.4f} ms F.layer_norm {lms:.4f} ms ({how}; "
                  f"kernel by events around one launch {ems:.4f} ms)")
            if timer is graph_ms:
                site_times[C, rows] = (ms, lms)
                n = ln_sites.count((C, rows))
                stats[LN.LAYERNORM]["ms"] += n * ms
                stats[LN.LAYERNORM]["event_ms"] += n * ems
                stats[LN.LAYERNORM]["plain_ms"] += n * pms
                stats[LN.LAYERNORM]["library_ms"] += n * lms
    # bound over one forward's 18 sites, bf16: read x, write y, read g
    stats[LN.LAYERNORM]["bound_ms"], stats[LN.LAYERNORM]["bound_by"] = bound(*ln_work(ln_sites), "bfloat16")
    k1_path(f"deraining {BATCH}x{SIZE}px", ln_sites, site_times, stats)

    # K2a / K2b at the deraining path's N (batch 8), the denoising 512 px
    # request's (batch 1), N = 1 and a ragged N, and the latent, DiT and
    # tiled paths' (batch, N); bound: ctx (f32) and f32 outputs 1e-5 of
    # max|ref| (ctx against the float64 composition past N = 16384, where
    # the plain float32 version's own sums drift past that bound); bf16
    # outputs bf16_bound.  Every pair runs each kernel twice: the two runs
    # must be bit-equal
    denoise_sites = denoise_attn_sites()
    timed_sites = {(BATCH, N) for N in attn_sites} | set(denoise_sites)
    pairs = [(BATCH, N) for N in sorted(set(attn_sites), reverse=True)]
    pairs += sorted(set(denoise_sites), reverse=True)
    pairs += sorted({(BATCH, 36), (3, 1), *latent_attn, *dit_attn} - set(pairs))
    per_step = {"K2a": 0.0, "K2b": 0.0, "K2a events": 0.0, "K2b events": 0.0, "bound": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for batch, N in pairs:
            qkv = (torch.randn(batch, N, 384, generator=gen, device=dev) * 1.5).to(dtype)
            ctx = LA.linear_attention_ctx_cuda(qkv)
            ctx_ref = LA.linear_attention_ctx_plain(qkv)
            if N > 16384:
                ref64 = ctx_float64(qkv)
                cerr = (ctx.double() - ref64).abs().max().item()
                cbound, cref = 1e-5 * ref64.abs().max().item(), "float64 composition"
                del ref64
            else:
                cerr = (ctx - ctx_ref).abs().max().item()
                cbound, cref = 1e-5 * ctx_ref.abs().max().item(), "plain"
            check(cerr <= cbound, f"K2a {dtype} B={batch} N={N}: max|dctx|={cerr:.3g} against the {cref}")
            out = LA.linear_attention_apply_cuda(qkv, ctx_ref)
            ref = LA.linear_attention_apply_plain(qkv, ctx_ref)
            err = (out.float() - ref.float()).abs()
            if dtype == torch.float32:
                ok = err.max().item() <= 1e-5 * ref.abs().max().item()
            else:
                ok = bool((err <= bf16_bound(ref)).all())
            check(ok, f"K2b {dtype} B={batch} N={N}: max|dout|={err.max().item():.3g}")
            same = (torch.equal(ctx, LA.linear_attention_ctx_cuda(qkv))
                    and torch.equal(out, LA.linear_attention_apply_cuda(qkv, ctx_ref)))
            check(same, f"K2 {dtype} B={batch} N={N}: two runs differ")
            stats[LA.LA_CTX]["err"] = max(stats[LA.LA_CTX]["err"], cerr)
            stats[LA.LA_APPLY]["err"] = max(stats[LA.LA_APPLY]["err"], err.max().item())
            site = dtype == torch.bfloat16 and (batch, N) in timed_sites
            timer = graph_ms if site else cuda_ms
            ms_c = timer(lambda: LA.linear_attention_ctx_cuda(qkv))
            pms_c = timer(lambda: LA.linear_attention_ctx_plain(qkv))
            ms_a = timer(lambda: LA.linear_attention_apply_cuda(qkv, ctx_ref))
            pms_a = timer(lambda: LA.linear_attention_apply_plain(qkv, ctx_ref))
            ems_c = cuda_ms(lambda: LA.linear_attention_ctx_cuda(qkv)) if site else ms_c
            ems_a = cuda_ms(lambda: LA.linear_attention_apply_cuda(qkv, ctx_ref)) if site else ms_a
            bms, by = bound(*la_work(batch, N, qkv.element_size()), str(dtype)[6:])
            print(f"[kernels] K2 {str(dtype)[6:]:8s} B={batch} N={N:6d} max|dctx|={cerr:.3g} ({cref}) "
                  f"max|dout|={err.max().item():.3g} bit-equal reruns "
                  f"K2a {ms_c:.4f} ms plain {pms_c:.4f} ms | K2b {ms_a:.4f} ms plain {pms_a:.4f} ms | "
                  f"least {bms:.4f} ms each ({by}) ({'graph of 20' if site else 'events'}; kernels by events "
                  f"around one launch {ems_c:.4f} / {ems_a:.4f} ms)")
            if site and batch == BATCH:
                n = attn_sites.count(N)
                stats[LA.LA_CTX]["ms"] += n * ms_c
                stats[LA.LA_CTX]["event_ms"] += n * ems_c
                stats[LA.LA_CTX]["plain_ms"] += n * pms_c
                stats[LA.LA_APPLY]["ms"] += n * ms_a
                stats[LA.LA_APPLY]["event_ms"] += n * ems_a
                stats[LA.LA_APPLY]["plain_ms"] += n * pms_a
            if site and (batch, N) in denoise_sites:
                n = denoise_sites.count((batch, N))
                for key, v in (("K2a", ms_c), ("K2b", ms_a), ("K2a events", ems_c), ("K2b events", ems_a),
                               ("bound", bms)):
                    per_step[key] += n * v
            del qkv, ctx, ctx_ref, out, ref, err
    print(f"[kernels] K2 bf16 over one denoising 512 px step's {len(denoise_sites)} sites: K2a "
          f"{per_step['K2a']:.4f} ms, K2b {per_step['K2b']:.4f} ms (graphs of 20; by events around one launch "
          f"{per_step['K2a events']:.4f} / {per_step['K2b events']:.4f} ms), least {per_step['bound']:.4f} ms each")
    # bounds over one deraining forward's 9 sites, bf16
    work = [la_work(BATCH, N, 2) for N in attn_sites]
    for k in (LA.LA_CTX, LA.LA_APPLY):
        stats[k]["bound_ms"], stats[k]["bound_by"] = bound(sum(w[0] for w in work), sum(w[1] for w in work),
                                                           "bfloat16")

    phase_naf_stack(dev, stats)
    check_gradients(dev)


def check_gradients(dev):
    """The packed op's gradient on the card (its forward launches K2a and
    K2b, its backward is the plain composition's) against the plain
    composition's, float32, within 1e-5 of max|grad|; and K1, K3 and K4,
    which have no backward yet, raise under grad instead of cutting it."""
    import torch

    from image_restoration_sde_tpu_torch.ops import flash_attention as FA
    from image_restoration_sde_tpu_torch.ops import layernorm as LN
    from image_restoration_sde_tpu_torch.ops import linear_attention as LA
    from image_restoration_sde_tpu_torch.ops import naf_stack as NS

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 18)
    qkv = (torch.randn(2, 1000, 384, generator=gen, device=dev) * 1.5).requires_grad_()
    g = torch.randn(2, 1000, 128, generator=gen, device=dev)
    before = (LA.LA_CTX.launches, LA.LA_APPLY.launches)
    out = LA.linear_attention_packed(qkv)
    check((LA.LA_CTX.launches - before[0], LA.LA_APPLY.launches - before[1]) == (1, 1),
          "K2 gradient: the forward did not launch K2a and K2b once each")
    (got,) = torch.autograd.grad(out, qkv, g)
    (want,) = torch.autograd.grad(LA.linear_attention_packed_plain(qkv), qkv, g)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    check(rel <= 1e-5, f"K2 gradient: max|dgrad| / max|grad| = {rel:.3g}")

    x = torch.randn(64, 64, generator=gen, device=dev)
    w = torch.ones(64, device=dev, requires_grad=True)
    blocks = naf_blocks(2, 64, 64, dev, SEED + 19)
    tmod = NS.time_modulation(blocks, torch.randn(2, 64, generator=gen, device=dev))
    blocks[0]["conv1.weight"].requires_grad_()
    q = torch.randn(1, 64, 2, 64, generator=gen, device=dev, requires_grad=True)
    refused = []
    for name, call in (("K1", lambda: LN.channel_layernorm_cuda(x, w, 1e-5)),
                       ("K3", lambda: NS.naf_stack_cuda(x.view(2, 4, 8, 64), blocks, tmod, 1e-5)),
                       ("K4", lambda: FA.flash_mha_cuda(q, q, q, 0.125))):
        try:
            call()
        except RuntimeError as e:
            if "no backward" in str(e):
                refused.append(name)
    check(refused == ["K1", "K3", "K4"], f"grad guards: only {refused} raised under grad")
    print(f"[kernels] K2 gradient through the op on the card at (2, 1000, 384) f32: max|dgrad| / max|grad| = "
          f"{rel:.3g} (bound 1e-5); K1, K3 and K4 raise under grad (no backward yet)")


def phase_naf_stack(dev, stats):
    """K3 against its plain version at the latent path's shapes (28 blocks,
    C = 512): batch 4 at 512 px, the 700x1000 request's 12x16 map, the
    deraining Refusion net's 16x16 map at batch 8; and a ragged 3x5x7x64
    stack of 4.  Bound: f32 1e-4 of max|ref|; bf16 twice the plain bf16
    result's distance from the plain float32 result on the same input.

    Each block's rounding is held block by block: the K blocks run again as
    K chained one-block launches, each against the one-block plain version
    on the same input (f32 1e-5 of max|ref|, bf16 bf16_bound: one ulp), and
    the chain's end must equal the K-block launch bit for bit (every sum
    runs in a fixed order and the grid is sized without K, so a kernel that
    kept the activation in float32 across blocks would differ)."""
    import torch

    from image_restoration_sde_tpu_torch.ops import naf_stack as NS

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    main_shape = (LATENT_BATCH, 8, 8, 512)
    cases = [(main_shape, 28), ((1, 12, 16, 512), 28), ((8, 16, 16, 512), 28), ((3, 5, 7, 64), 4)]
    for shape, K in cases:
        C = shape[-1]
        blocks = naf_blocks(K, C, 4 * C // 8, dev, SEED + K)
        x32 = torch.randn(shape, generator=gen, device=dev)
        temb = torch.randn(shape[0], 4 * C // 8, generator=gen, device=dev)
        stacked = NS.stack_middle_params(blocks, temb)
        tmod = NS.time_modulation(blocks, temb)
        for dtype, eps in ((torch.bfloat16, 1e-3), (torch.float32, 1e-5)):
            x = x32.to(dtype)
            y = NS.naf_stack_cuda(x, blocks, tmod, eps)
            ref = NS.naf_stack_plain(x, stacked, eps)
            err = (y.float() - ref.float()).abs().max().item()
            check(bool(torch.isfinite(y).all()), f"K3 {dtype} {shape}: output not finite")
            if dtype == torch.float32:
                limit = 1e-4 * ref.abs().max().item()
            else:
                limit = 2 * (ref.float() - NS.naf_stack_plain(x.float(), stacked, eps)).abs().max().item()
            check(err <= limit, f"K3 {dtype} {shape} K={K}: max|dy|={err:.3g} (bound {limit:.3g})")
            z, one_err = x, 0.0
            for i in range(K):
                zi = NS.naf_stack_cuda(z, blocks[i : i + 1], tmod[i : i + 1], eps)
                one = NS.naf_stack_plain(z, {k: v[i : i + 1] for k, v in stacked.items()}, eps)
                e = (zi.float() - one.float()).abs()
                if dtype == torch.float32:
                    ok = e.max().item() <= 1e-5 * one.abs().max().item()
                else:
                    ok = bool((e <= bf16_bound(one)).all())
                check(ok, f"K3 {dtype} {shape} block {i} alone: max|dy|={e.max().item():.3g}")
                one_err, z = max(one_err, e.max().item()), zi
            check(torch.equal(z, y), f"K3 {dtype} {shape}: K={K} in one launch differs from {K} chained launches")
            stats[NS.NAF_STACK]["err"] = max(stats[NS.NAF_STACK]["err"], err)
            # the card's time from a CUDA graph of 5 launches; beside it one launch
            # between CUDA events, the earlier figure, which also holds the host's
            # ~0.5-1 ms of pointer-table and argument work before each launch
            ms = graph_ms(lambda: NS.naf_stack_cuda(x, blocks, tmod, eps), n=5, reps=3)
            ems = cuda_ms(lambda: NS.naf_stack_cuda(x, blocks, tmod, eps), reps=10)
            pms = cuda_ms(lambda: NS.naf_stack_plain(x, stacked, eps), reps=10)
            nbytes, flops = naf_stack_work(x, blocks)
            # K3 computes in float32 (FMA) whatever x's dtype: the float32 peak
            bms, by = bound(nbytes, flops, "float32")
            print(f"[kernels] K3 {str(dtype)[6:]:8s} {shape} K={K}: max|dy|={err:.3g} (bound {limit:.3g}), "
                  f"one block at a time max|dy|={one_err:.3g}, chained launches bit-equal; "
                  f"kernel {ms:.4f} ms (graph of 5; one launch between events {ems:.4f} ms) plain {pms:.4f} ms; "
                  f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP, "
                  f"least {bms:.4f} ms ({by}, float32 FMA; bytes alone {bound(nbytes, 0, 'float32')[0]:.4f} ms), "
                  f"{nbytes / ms / 1e9:.3f} TB/s, {flops / ms / 1e9:.2f} TFLOP/s")
            if dtype == torch.bfloat16 and shape == main_shape:
                stats[NS.NAF_STACK].update(ms=ms, event_ms=ems, plain_ms=pms, bound_ms=bms, bound_by=by)


def make_net(cls, setting, dtype, plain, dev, state=None):
    import torch

    from image_restoration_sde_tpu_torch.models import init_params_

    net = cls(**setting, dtype=dtype, plain=plain)
    if state is None:
        gen = torch.Generator()
        gen.manual_seed(SEED)
        init_params_(net, gen)
    else:
        net.load_state_dict(state)
    return net.to(dev).eval()


def make_nets(cls, setting, dev):
    """The same seeded weights in the four (dtype, plain) variants."""
    import torch

    nets, state = {}, None
    for dtype in (torch.bfloat16, torch.float32):
        for plain in (False, True):
            nets[dtype, plain] = make_net(cls, setting, dtype, plain, dev, state)
            state = nets[dtype, plain].state_dict()
    return nets


def compare_nets(tag, name, nets, inputs):
    """One forward of each variant: kernel path against plain path.  f32:
    the two agree to float32 rounding through the net, 1e-4 of max|ref|;
    bf16: the kernel path may differ from the plain bf16 path by at most
    twice the plain bf16 path's own distance from float32."""
    import torch

    with torch.inference_mode():
        outs = {key: net(*inputs) for key, net in nets.items()}
    torch.cuda.synchronize()
    for o in outs.values():
        check(o.shape == inputs[0].shape and bool(torch.isfinite(o).all()), f"{name}: output shape/finite")
    f32_ref = outs[torch.float32, True]
    f32_err = (outs[torch.float32, False] - f32_ref).abs().max().item()
    f32_bound = 1e-4 * f32_ref.abs().max().item()
    bf_err = (outs[torch.bfloat16, False] - outs[torch.bfloat16, True]).abs().max().item()
    bf_floor = (outs[torch.bfloat16, True] - f32_ref).abs().max().item()
    print(f"[{tag}] {name}: f32 kernel-vs-plain max|d|={f32_err:.3g} (bound {f32_bound:.3g}); "
          f"bf16 kernel-vs-plain max|d|={bf_err:.3g} (bound 2 x bf16-vs-f32 {bf_floor:.3g})")
    check(f32_err <= f32_bound, f"f32 {name}: kernel path differs from plain path")
    check(bf_err <= 2 * bf_floor, f"bf16 {name}: kernel path differs from plain path")


def phase_net(dev, setting, sde_opt):
    import torch

    from image_restoration_sde_tpu_torch.models import ConditionalUNet
    from image_restoration_sde_tpu_torch.sampling import make_restoration_sampler
    from image_restoration_sde_tpu_torch.sde import IRSDE

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    lq = torch.rand(BATCH, SIZE, SIZE, 3, generator=gen, device=dev)
    xt = lq + 10 / 255 * torch.randn(lq.shape, generator=gen, device=dev)
    t = torch.randint(1, 101, (BATCH,), generator=gen, device=dev)

    nets = make_nets(ConditionalUNet, setting, dev)
    compare_nets("net", f"nf={setting['nf']} depth={setting['depth']} batch {BATCH} {SIZE}px", nets, (xt, lq, t))

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
    """The deraining sampler serves two posterior batches of 8, one sde
    batch of 8 and the odd 100x140 image (padded to 128x192)."""
    from image_restoration_sde_tpu_torch.sampling import make_restoration_sampler
    from image_restoration_sde_tpu_torch.sde import IRSDE

    sde = IRSDE.create(sde_opt["max_sigma"], sde_opt["T"], sde_opt["schedule"], sde_opt["eps"], device=dev)
    samplers = {m: make_restoration_sampler(sde, net, mode=m) for m in ("posterior", "sde")}
    gen = rng_generator(dev, SEED + 3)
    rng = np.random.default_rng(SEED + 3)
    requests = [("posterior", rng.random((BATCH, SIZE, SIZE, 3), np.float32), (gen,)),
                ("posterior", rng.random((BATCH, SIZE, SIZE, 3), np.float32), (gen,)),
                ("sde", rng.random((BATCH, SIZE, SIZE, 3), np.float32), (gen,)),
                ("posterior", rng.random((1, *ODD_HW, 3), np.float32), (gen,))]
    # one chunk: the default runs the whole batch at once
    want = counts(LAYERNORM=LN_PER_FORWARD * sde.T, LA_CTX=ATTN_PER_FORWARD * sde.T, LA_APPLY=ATTN_PER_FORWARD * sde.T)
    return serve("main", dev, requests, samplers, want, smi, BATCH, pad=64)


def compare_compressor(tag, compressor, plain, img):
    """The float32 compressor's kernel path against its plain path on one
    image batch: encode (the latent and every skip), then decode of the
    plain path's latent and skips; each within 1e-4 of max|ref|.  Encode
    and decode together launch K1 4 times and K2a, K2b twice each."""
    import torch

    from image_restoration_sde_tpu_torch.ops import LA_APPLY, LA_CTX, LAYERNORM

    counted = (LAYERNORM, LA_CTX, LA_APPLY)
    before = [k.launches for k in counted]
    with torch.inference_mode():
        latent, hs = compressor.encode(img)
        latent_ref, hs_ref = plain.encode(img)
        out = compressor.decode(latent_ref, hs_ref, img.shape[1:3])
        ref = plain.decode(latent_ref, hs_ref, img.shape[1:3])
    grew = [k.launches - b for k, b in zip(counted, before)]
    check(grew == [COMPRESSOR_LN, COMPRESSOR_ATTN, COMPRESSOR_ATTN], f"compressor launches {grew}")
    worst = 0.0
    for name, got, want in [("latent", latent, latent_ref), *((f"skip {i}", a, b) for i, (a, b) in
                                                              enumerate(zip(hs, hs_ref))), ("decode", out, ref)]:
        err = (got - want).abs().max().item()
        check(got.shape == want.shape and bool(torch.isfinite(got).all()), f"compressor {name}: shape/finite")
        check(err <= 1e-4 * want.abs().max().item(), f"compressor {name}: kernel path differs from plain path")
        worst = max(worst, err / want.abs().max().item())
    check(out.shape == img.shape, f"compressor output shape {tuple(out.shape)}")
    print(f"[{tag}] compressor f32 {tuple(img.shape)}: latent, {len(hs)} skips and decode kernel-vs-plain "
          f"max|d| / max|ref| = {worst:.3g} (bound 1e-4); launches K1, K2a, K2b {grew}")


def phase_latent_net(dev, latent_opt, refusion_setting, stats):
    """One forward of each full-width NAFNet, kernel path against plain
    path: the latent net at batch 4 on 64x64x8 latents (K3 at 8x8), and the
    deraining Refusion net at batch 8, 128 px (K3 at 16x16).  The kernel
    forward of the latent net launches K3 once and K1 16 times.  Then the
    compressor, kernel path against plain path, at batch 4, 512 px and on
    the 704x1024 request."""
    import torch

    from image_restoration_sde_tpu_torch.models import ConditionalNAFNet, UNet, init_params_
    from image_restoration_sde_tpu_torch.ops import LAYERNORM, NAF_STACK

    latent_setting = latent_opt["network_G"]["setting"]

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    kept = None
    for name, setting, batch, size in (("latent NAFNet", latent_setting, LATENT_BATCH, LATENT_SIZE // 8),
                                       ("deraining NAFNet", refusion_setting, BATCH, SIZE)):
        nets = make_nets(ConditionalNAFNet, setting, dev)
        ch = setting.get("img_channel", 3)
        cond = torch.randn(batch, size, size, ch, generator=gen, device=dev)
        xt = cond + torch.randn(cond.shape, generator=gen, device=dev)
        t = torch.randint(1, 101, (batch,), generator=gen, device=dev)
        if kept is None:
            before = (LAYERNORM.launches, NAF_STACK.launches)
            with recorded_sites() as (ln, _), torch.inference_mode():
                nets[torch.bfloat16, False](xt, cond, t)
            grew = (LAYERNORM.launches - before[0], NAF_STACK.launches - before[1])
            check(grew == (NAF_LN_PER_FORWARD, 1), f"{name}: K1, K3 launches {grew} per forward")
            kept = nets[torch.bfloat16, False]
            ln = [(C, rows) for C, rows, _ in ln]
            k1_path(f"latent {batch}x{LATENT_SIZE}px", ln, k1_site_times(dev, ln), stats)
        compare_nets("latent-net", f"{name} batch {batch} {size}x{size}x{ch}", nets, (xt, cond, t))
        del nets

    comp_setting = latent_opt["network_L"]["setting"]
    compressor = init_params_(UNet(**comp_setting), torch.Generator().manual_seed(SEED + 7)).to(dev).eval()
    plain = UNet(**comp_setting, plain=True)
    plain.load_state_dict(compressor.state_dict())
    plain.to(dev).eval()
    for request in latent_requests():
        compare_compressor("latent-net", compressor, plain, torch.rand(*request, 3, generator=gen, device=dev))
    return kept, compressor


def phase_latent_main_path(dev, net, compressor, latent_opt, smi):
    """The latent sampler serves two batches of 4 at 512 px in the YAML's
    mode, one sde batch of 4 and the odd 700x1000 image (704x1024)."""
    from image_restoration_sde_tpu_torch.sde import IRSDE
    from image_restoration_sde_tpu_torch.training import make_latent_sampler

    sde_opt = latent_opt["sde"]
    sde = IRSDE.create(sde_opt["max_sigma"], sde_opt["T"], sde_opt["schedule"], sde_opt["eps"], device=dev)
    steps, mode = sde_opt["sample_T"], sde_opt["sampling_mode"]
    samplers = {m: make_latent_sampler(sde, net, compressor, mode=m, steps=steps) for m in (mode, "sde")}
    gen = rng_generator(dev, SEED + 8)
    rng = np.random.default_rng(SEED + 8)
    full = (LATENT_BATCH, LATENT_SIZE, LATENT_SIZE, 3)
    requests = [(mode, rng.random(full, np.float32), (gen,)), (mode, rng.random(full, np.float32), (gen,)),
                ("sde", rng.random(full, np.float32), (gen,)),
                (mode, rng.random((1, *LATENT_ODD_HW, 3), np.float32), (gen,))]
    want = counts(LAYERNORM=NAF_LN_PER_FORWARD * steps + COMPRESSOR_LN, LA_CTX=COMPRESSOR_ATTN,
                  LA_APPLY=COMPRESSOR_ATTN, NAF_STACK=steps)
    return serve("latent-main", dev, requests, samplers, want, smi, LATENT_BATCH, pad=64)


def flash_work(shape, itemsize):
    """(bytes, FLOP, exponentials) of attention on (B, N, H, D): q, k, v read
    and the output written once; q k^T and p v; one exp per score."""
    B, N, H, D = shape
    return 4 * B * N * H * D * itemsize, 4 * B * H * N * N * D, B * H * N * N


def softmax_peak(q, k, scale):
    """(B, N, H, 1) float32: each row's largest softmax weight, one batch
    element at a time."""
    import torch

    peaks = []
    for qb, kb in zip(q, k):
        s = torch.einsum("ihd,jhd->hij", qb.float(), kb.float()) * scale
        peaks.append(torch.exp(s.amax(dim=-1) - s.logsumexp(dim=-1)).transpose(0, 1))
        del s
    return torch.stack(peaks)[..., None]


def flash_bf16_agreement(out, tiled, q, k, v, scale):
    """bf16 K4 against flash_mha_tiled_plain, which rounds p where the
    kernel does: (share of elements past two ulps plus 1e-5 of max|ref|,
    largest error over that bound plus one bf16 ulp of the row's largest
    p v term).  A float32 difference in s flips the rounding of a p now and
    then, and one flip moves an element by at most that last term.  Phase
    8 also prints the share of flash_mha_plain, which rounds p at the row
    max: what a kernel that rounds p elsewhere would show."""
    err = (out.float() - tiled.float()).abs()
    tight = bf16_bound(tiled, ulps=2)
    flip = 2.0**-7 * softmax_peak(q, k, scale) * v.float().abs().max()
    return (err > tight).float().mean().item(), (err / (tight + flip)).max().item()


def phase_flash(dev, stats, dit_opt):
    """K4 against its plain version at FLASH_SHAPES and the DiT and tiled
    requests' shapes, and on strided views of a packed qkv product.
    Bounds: float32 1e-5 of max|ref|; bfloat16 twice the plain bf16
    result's distance from the plain float32 result on the same inputs
    (kernel and plain version round p at other maxima), and against
    flash_mha_tiled_plain, which rounds p at the kernel's running maxima,
    flash_bf16_agreement: at most FLASH_FLIP_SHARE of the elements past
    two ulps, none past the flip allowance.  Library call:
    F.scaled_dot_product_attention on the same tensors as (B, H, N, D),
    transposed beforehand (bfloat16 only)."""
    import torch
    import torch.nn.functional as F

    from image_restoration_sde_tpu_torch.ops import FLASH_ATTN
    from image_restoration_sde_tpu_torch.ops import flash_attention as FA

    shapes = FLASH_SHAPES + [s for s in dit_path_shapes(dit_opt)[2] if s not in FLASH_SHAPES]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    for dtype in (torch.bfloat16, torch.float32):
        for shape in shapes:
            D = shape[-1]
            scale = D**-0.5
            q, k, v = ((torch.randn(shape, generator=gen, device=dev) * 1.5).to(dtype) for _ in range(3))
            out = FA.flash_mha_cuda(q, k, v, scale)
            ref = FA.flash_mha_plain(q, k, v, scale)
            err = (out.float() - ref.float()).abs().max().item()
            check(out.shape == shape and bool(torch.isfinite(out).all()), f"K4 {dtype} {shape}: shape/finite")
            share, worst, tiled = 0.0, 0.0, ""
            if dtype == torch.float32:
                limit = 1e-5 * ref.abs().max().item()
            else:
                f32 = FA.flash_mha_plain(q.float(), k.float(), v.float(), scale)
                limit = 2 * (ref.float() - f32).abs().max().item()
                del f32
                tiled_ref = FA.flash_mha_tiled_plain(q, k, v, scale)
                share, worst = flash_bf16_agreement(out, tiled_ref, q, k, v, scale)
                row_max = flash_bf16_agreement(ref, tiled_ref, q, k, v, scale)[0]
                del tiled_ref
                tiled = (f"; vs tiled plain {share:.3g} past two ulps (un-tiled plain {row_max:.3g}), "
                         f"worst {worst:.3g} of the flip allowance")
            stats[FLASH_ATTN]["err"] = max(stats[FLASH_ATTN]["err"], err)
            reps = 10 if shape[1] >= 2048 else 20
            ms = cuda_ms(lambda: FA.flash_mha_cuda(q, k, v, scale), reps=reps)
            pms = cuda_ms(lambda: FA.flash_mha_plain(q, k, v, scale), reps=reps)
            lib = "-"
            if dtype == torch.bfloat16:
                qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
                lms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), reps=reps)
                lib = f"{lms:.4f} ms"
                del qt, kt, vt
            nbytes, flops, exps = flash_work(shape, q.element_size())
            bms, by = bound(nbytes, flops, str(dtype)[6:])
            print(f"[dit-kernels] K4 {str(dtype)[6:]:8s} {shape}: max|dy|={err:.3g} (bound {limit:.3g}){tiled}; "
                  f"kernel {ms:.4f} ms plain {pms:.4f} ms sdpa {lib}; {flops / 1e9:.1f} GFLOP, "
                  f"{nbytes / 1e6:.1f} MB, {exps / 1e6:.0f} M exp, least {bms:.4f} ms ({by}), "
                  f"{flops / ms / 1e9:.1f} TFLOP/s")
            check(err <= limit, f"K4 {dtype} {shape}: max|dy|={err:.3g} (bound {limit:.3g})")
            check(share <= FLASH_FLIP_SHARE and worst <= 1,
                  f"K4 {dtype} {shape} against the tiled plain version: {share:.3g} of the elements past two ulps "
                  f"(bound {FLASH_FLIP_SHARE}), worst {worst:.3g} of the flip allowance")
            if dtype == torch.bfloat16 and shape == FLASH_SHAPES[0]:
                stats[FLASH_ATTN].update(ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bms, bound_by=by)
            del q, k, v, out, ref

        # strided views of a packed (B, N, 3, H, D) product, as the DiT gives them
        B, N, H, D = FLASH_SHAPES[0]
        qkv = (torch.randn(B, N, 3, H, D, generator=gen, device=dev) * 1.5).to(dtype)
        q, k, v = qkv.unbind(2)
        out = FA.flash_mha_cuda(q, k, v, D**-0.5)
        same = torch.equal(out, FA.flash_mha_cuda(q.contiguous(), k.contiguous(), v.contiguous(), D**-0.5))
        err = (out.float() - FA.flash_mha_plain(q, k, v, D**-0.5).float()).abs().max().item()
        check(same, f"K4 {dtype}: strided q/k/v views differ from contiguous copies")
        print(f"[dit-kernels] K4 {str(dtype)[6:]:8s} strided views of a packed ({B}, {N}, 3, {H}, {D}) qkv: "
              f"bit-equal to contiguous copies, max|dy| vs plain {err:.3g}")
        del qkv, q, k, v, out


def phase_dit_net(dev, dit_opt):
    """One forward of the full-width DiT-L/2 at batch 2 on 128x128x8
    latents, kernel path against plain path, float32 and bfloat16 (bounds
    of compare_nets).  Seeded weights with flax's default initialisers on
    every layer: flax zeroes adaLN and the final layer, and a net whose
    output is exactly 0 would agree with anything.  The bf16 kernel forward
    launches K4 once per block.  Then the path's float32 compressor, kernel
    path against plain path, at each DiT request's shape and the tiled
    call's (compare_compressor)."""
    import functools

    import torch

    from image_restoration_sde_tpu_torch.models import build_network, init_params_
    from image_restoration_sde_tpu_torch.ops import FLASH_ATTN

    which, setting = dit_opt["network_G"]["which_model"], dit_opt["network_G"]["setting"]
    nets = make_nets(functools.partial(build_network, which), setting, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 10)
    lat = DIT_SIZE // 8
    cond = torch.randn(DIT_BATCH, lat, lat, setting["in_channels"], generator=gen, device=dev)
    xt = cond + torch.randn(cond.shape, generator=gen, device=dev)
    t = torch.randint(1, 101, (DIT_BATCH,), generator=gen, device=dev)
    before = FLASH_ATTN.launches
    with torch.inference_mode():
        nets[torch.bfloat16, False](xt, cond, t)
    depth = len(nets[torch.bfloat16, False].blocks)
    check(FLASH_ATTN.launches - before == depth, f"DiT forward: {FLASH_ATTN.launches - before} K4 launches")
    compare_nets("dit-net", f"{which} batch {DIT_BATCH} {lat}x{lat}x{setting['in_channels']}", nets, (xt, cond, t))
    net = nets.pop((torch.bfloat16, False))
    del nets

    comp_opt = dit_opt["network_L"]
    compressor = build_network(comp_opt["which_model"], comp_opt["setting"])
    compressor = init_params_(compressor, torch.Generator().manual_seed(SEED + 11)).to(dev).eval()
    plain = build_network(comp_opt["which_model"], comp_opt["setting"], plain=True)
    plain.load_state_dict(compressor.state_dict())
    plain.to(dev).eval()
    for request in dit_requests():
        compare_compressor("dit-net", compressor, plain, torch.rand(*request, 3, generator=gen, device=dev))
    return net, compressor


def dit_want(steps, depth):
    """Launches per 100-step DiT request: K4 once per block and step, the
    compressor's K1 and K2 once per request, no K3."""
    return counts(LAYERNORM=COMPRESSOR_LN, LA_CTX=COMPRESSOR_ATTN, LA_APPLY=COMPRESSOR_ATTN,
                  FLASH_ATTN=depth * steps)


def phase_dit_main_path(dev, net, compressor, dit_opt, smi):
    """The DiT latent sampler (compressor float32; DiT bf16 compute with its
    parameters cast to bf16 once per request) serves two posterior batches
    of 2 at 1024 px, one sde batch of 2 and the odd 1000x700 image (padded
    to 1024x704: 2816 tokens)."""
    import torch

    from image_restoration_sde_tpu_torch.sde import IRSDE
    from image_restoration_sde_tpu_torch.training import make_latent_sampler

    sde_opt = dit_opt["sde"]
    sde = IRSDE.create(sde_opt["max_sigma"], sde_opt["T"], sde_opt["schedule"], sde_opt["eps"], device=dev)
    steps = sde_opt["sample_T"]
    samplers = {m: make_latent_sampler(sde, net, compressor, mode=m, steps=steps, cast_params=torch.bfloat16)
                for m in (DIT_MODE, "sde")}
    gen = rng_generator(dev, SEED + 12)
    rng = np.random.default_rng(SEED + 12)
    full = (DIT_BATCH, DIT_SIZE, DIT_SIZE, 3)
    requests = [(DIT_MODE, rng.random(full, np.float32), (gen,)), (DIT_MODE, rng.random(full, np.float32), (gen,)),
                ("sde", rng.random(full, np.float32), (gen,)),
                (DIT_MODE, rng.random((1, *DIT_ODD_HW, 3), np.float32), (gen,))]
    launches = serve("dit-main", dev, requests, samplers, dit_want(steps, len(net.blocks)), smi, DIT_BATCH, pad=64)
    return launches, samplers[DIT_MODE]


def phase_tiled(dev, sampler, steps, depth, smi):
    """tiled_restore_device on a 1x1536x1536 uint8 image through the DiT
    posterior sampler: four 1024 px tiles in one call of tile_batch 4."""
    from image_restoration_sde_tpu_torch.ops import KERNELS
    from image_restoration_sde_tpu_torch.tiling import tiled_restore_device

    img = np.random.default_rng(SEED + 13).integers(0, 256, (1, *TILED_HW, 3)).astype(np.uint8)
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    out = tiled_restore_device(sampler, img, SEED, tile=TILE, overlap=TILE_OVERLAP, tile_batch=TILE_BATCH,
                               device=dev)
    seconds = time.perf_counter() - t0
    launches = {k.symbol: k.launches for k in KERNELS}
    check(out.shape == img.shape and out.dtype == np.uint8, f"tiled output {out.shape} {out.dtype}")
    check(launches == dit_want(steps, depth), f"tiled launch counts {launches}")
    print(f"[tiled] 1x{TILED_HW[0]}x{TILED_HW[1]} uint8, tile {TILE}, overlap {TILE_OVERLAP}, tile_batch "
          f"{TILE_BATCH}: {seconds:.3f} s per image, output {out.dtype} {out.shape} (mean {out.mean():.2f}), "
          f"launches {launches} (host clock; card: {smi})")
    return launches


def lin_attn_work(shape, itemsize):
    """(bytes, FLOP) of the K5 op on (BH, N, d): q, k, v read and the output
    written once; the d x d outer products of the context and the d x d
    product of the apply, 2 N d^2 FLOP each per slice."""
    BH, N, d = shape
    return 4 * BH * N * d * itemsize, 4 * BH * N * d * d


def phase_lin_attn(dev, stats):
    """The public op ``ops.linear_attention.linear_attention`` (K5) at
    LIN_ATTN_SHAPES, float32 and bfloat16: the op path (counts set to 0,
    one call of the op per shape and dtype, counts read: exactly one
    context and one apply launch per call), then each call's output against
    ``linear_attention_plain`` on the same inputs (float32 1e-5 of
    max|ref|, bfloat16 bf16_bound), each pass timed beside its plain half
    and the op's bound; then one gradient through the op on the card
    against the plain composition's (float32, 1e-5 of max|grad|).  No
    single PyTorch call computes the function: library_ms is null."""
    import torch

    from image_restoration_sde_tpu_torch.ops import KERNELS, LIN_ATTN_APPLY, LIN_ATTN_CTX
    from image_restoration_sde_tpu_torch.ops import linear_attention as LA

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 14)
    cases = [(dtype, shape) for dtype in (torch.bfloat16, torch.float32) for shape in LIN_ATTN_SHAPES]
    inputs = {case: [(torch.randn(case[1], generator=gen, device=dev) * 1.5).to(case[0]) for _ in range(3)]
              for case in cases}
    for k in KERNELS:
        k.launches = 0
    outs = {case: LA.linear_attention(*inputs[case]) for case in cases}
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in KERNELS}
    check(launches == counts(LIN_ATTN_CTX=len(cases), LIN_ATTN_APPLY=len(cases)),
          f"linear_attention path launch counts {launches}")
    print(f"[lin-attn] op path: {len(cases)} calls, launches {launches}")
    for case in cases:
        dtype, shape = case
        q, k, v = inputs[case]
        out, ref = outs[case], LA.linear_attention_plain(q, k, v)
        err = (out.float() - ref.float()).abs()
        check(out.shape == shape and out.dtype == dtype and bool(torch.isfinite(out).all()),
              f"K5 {dtype} {shape}: shape/dtype/finite")
        if dtype == torch.float32:
            ok = err.max().item() <= 1e-5 * ref.abs().max().item()
        else:
            ok = bool((err <= bf16_bound(ref)).all())
        check(ok, f"K5 {dtype} {shape}: max|dy|={err.max().item():.3g}")
        ctx = LA.linear_attention_context_cuda(k, v)
        ctx_ref = LA.linear_attention_context_plain(k, v)
        cerr = (ctx - ctx_ref).abs().max().item()
        check(cerr <= 1e-5 * ctx_ref.abs().max().item(), f"K5 {dtype} {shape}: max|dctx|={cerr:.3g}")
        stats[LIN_ATTN_CTX]["err"] = max(stats[LIN_ATTN_CTX]["err"], cerr)
        stats[LIN_ATTN_APPLY]["err"] = max(stats[LIN_ATTN_APPLY]["err"], err.max().item())
        ms_c = graph_ms(lambda: LA.linear_attention_context_cuda(k, v))
        pms_c = graph_ms(lambda: LA.linear_attention_context_plain(k, v))
        ms_a = graph_ms(lambda: LA.linear_attention_apply_heads_cuda(q, ctx))
        pms_a = graph_ms(lambda: LA.linear_attention_apply_heads_plain(q, ctx))
        ems_c = cuda_ms(lambda: LA.linear_attention_context_cuda(k, v))
        ems_a = cuda_ms(lambda: LA.linear_attention_apply_heads_cuda(q, ctx))
        nbytes, flops = lin_attn_work(shape, q.element_size())
        bms, by = bound(nbytes, flops, str(dtype)[6:])
        half = bound(nbytes / 2, flops / 2, str(dtype)[6:])
        print(f"[lin-attn] K5 {str(dtype)[6:]:8s} {shape}: max|dctx|={cerr:.3g} max|dy|={err.max().item():.3g}; "
              f"context {ms_c:.4f} ms plain {pms_c:.4f} ms | apply {ms_a:.4f} ms plain {pms_a:.4f} ms | op "
              f"{ms_c + ms_a:.4f} ms, least {bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
              f"{nbytes / (ms_c + ms_a) / 1e9:.3f} TB/s (graph of 20; by events around one launch: context "
              f"{ems_c:.4f} ms, apply {ems_a:.4f} ms)")
        if case == cases[0]:
            stats[LIN_ATTN_CTX].update(ms=ms_c, event_ms=ems_c, plain_ms=pms_c, bound_ms=half[0], bound_by=half[1])
            stats[LIN_ATTN_APPLY].update(ms=ms_a, event_ms=ems_a, plain_ms=pms_a, bound_ms=half[0],
                                         bound_by=half[1])
        del q, k, v, out, ref, ctx, ctx_ref
    del inputs, outs

    ins = [torch.randn(LIN_ATTN_GRAD_SHAPE, generator=gen, device=dev, requires_grad=True) for _ in range(3)]
    g = torch.randn(LIN_ATTN_GRAD_SHAPE, generator=gen, device=dev)
    got = torch.autograd.grad(LA.linear_attention(*ins), ins, g)
    want = torch.autograd.grad(LA.linear_attention_plain(*ins), ins, g)
    errs = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want)]
    check(max(errs) <= 1e-5, f"K5 gradient: max|dgrad| / max|grad| = {errs}")
    print(f"[lin-attn] gradient through the op at {LIN_ATTN_GRAD_SHAPE} f32: max|dgrad| / max|grad| "
          f"(q, k, v) = {', '.join(f'{e:.3g}' for e in errs)} (bound 1e-5)")
    return launches


@contextlib.contextmanager
def recorded_sites():
    """Record the (C, rows, dtype) of every K1 launch and the (B, N, dtype)
    of every K2 launch made inside the block, into the yielded lists."""
    from image_restoration_sde_tpu_torch.ops import layernorm as LN
    from image_restoration_sde_tpu_torch.ops import linear_attention as LA

    ln, attn = [], []
    ln_cuda, ctx_cuda = LN.channel_layernorm_cuda, LA.linear_attention_ctx_cuda

    def ln_rec(x, g, eps):
        ln.append((x.shape[-1], x.numel() // x.shape[-1], x.dtype))
        return ln_cuda(x, g, eps)

    def ctx_rec(qkv, *a):
        attn.append((qkv.shape[0], qkv.shape[1], qkv.dtype))
        return ctx_cuda(qkv, *a)

    LN.channel_layernorm_cuda, LA.linear_attention_ctx_cuda = ln_rec, ctx_rec
    try:
        yield ln, attn
    finally:
        LN.channel_layernorm_cuda, LA.linear_attention_ctx_cuda = ln_cuda, ctx_cuda


def ctx_float64(qkv, heads=4, dim_head=32):
    """K2a's function, linear_attention_ctx_plain's math in float64."""
    import torch

    B, N, _ = qkv.shape
    x = qkv.double().reshape(B, N, 3, heads, dim_head)
    return torch.einsum("bnhd,bnhe->bhed", torch.softmax(x[:, :, 1], dim=1), x[:, :, 2] / N)


def hold_sites(tag, dev, ln_sites, attn_sites, stats, forwards):
    """K1 and K2b against their plain versions at each recorded site shape,
    on seeded inputs, with phase 3's bounds; K2a's ctx within 1e-5 of
    max|ctx| of the float64 composition (at N >= 65536 the plain float32
    version's own sums over N drift past that bound; the kernel's do not).
    Then K1 timed over each of ``forwards`` ({label: the (C, rows, dtype)
    of one bf16 forward's K1 launches}, k1_path)."""
    import torch

    from image_restoration_sde_tpu_torch.ops import layernorm as LN
    from image_restoration_sde_tpu_torch.ops import linear_attention as LA

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 15)

    def agree(out, ref):
        err = (out.float() - ref.float()).abs()
        if out.dtype == torch.float32:
            return err.max().item() <= 1e-5 * ref.abs().max().item(), err.max().item()
        return bool((err <= bf16_bound(ref)).all()), err.max().item()

    worst = [0.0, 0.0]
    for C, rows, dtype in sorted(set(ln_sites), key=str):
        eps = 1e-5 if dtype == torch.float32 else 1e-3
        x = (torch.randn(rows, C, generator=gen, device=dev) * 2 + 0.5).to(dtype)
        g = torch.randn(C, generator=gen, device=dev) * 0.2 + 1
        ok, err = agree(LN.channel_layernorm_cuda(x, g, eps), LN.channel_layernorm_plain(x, g, eps))
        check(ok, f"{tag}: K1 {dtype} C={C} rows={rows}: max|dy|={err:.3g}")
        worst[0] = max(worst[0], err)
    ctx_rel = [0.0, 0.0]  # kernel and plain float32 ctx against float64, / max|ctx|
    for batch, N, dtype in sorted(set(attn_sites), key=str):
        qkv = (torch.randn(batch, N, 384, generator=gen, device=dev) * 1.5).to(dtype)
        ctx, ctx_ref = LA.linear_attention_ctx_cuda(qkv), LA.linear_attention_ctx_plain(qkv)
        ref64 = ctx_float64(qkv)
        scale = ref64.abs().max().item()
        rel = [(c.double() - ref64).abs().max().item() / scale for c in (ctx, ctx_ref)]
        ctx_rel = [max(a, b) for a, b in zip(ctx_rel, rel)]
        check(rel[0] <= 1e-5, f"{tag}: K2a {dtype} B={batch} N={N}: max|dctx| = {rel[0]:.3g} of max|ctx|")
        ok, err = agree(LA.linear_attention_apply_cuda(qkv, ctx_ref), LA.linear_attention_apply_plain(qkv, ctx_ref))
        check(ok, f"{tag}: K2b {dtype} B={batch} N={N}: max|dout|={err:.3g}")
        worst[1] = max(worst[1], err)
        del qkv, ref64
    print(f"[{tag}] K1 at the path's {len(set(ln_sites))} (C, rows, dtype) sites and K2 at its "
          f"{len(set(attn_sites))} (B, N, dtype) sites against their plain versions: max|dy| {worst[0]:.3g}, "
          f"max|dout| {worst[1]:.3g} (phase 3's bounds); K2a's ctx against the float64 composition "
          f"{ctx_rel[0]:.3g} of max|ctx| (bound 1e-5), the plain float32 version's {ctx_rel[1]:.3g}")
    forwards = {label: [(C, rows) for C, rows, _ in sites] for label, sites in forwards.items()}
    times = k1_site_times(dev, [site for sites in forwards.values() for site in sites])
    for label, sites in forwards.items():
        k1_path(label, sites, times, stats)


def serve(tag, dev, requests, samplers, want, smi, rate_batch, pad=None):
    """Each request (mode, NHWC float32 array, extra arguments) through
    ``samplers[mode](x, *extra)``, with exact launch counts per request (``want``);
    counts set to 0 before the first and read after the last.  ``pad``
    pads each request to a bucket multiple first (pad_to_bucket) and crops
    the output back."""
    import torch

    from image_restoration_sde_tpu_torch.ops import KERNELS
    from image_restoration_sde_tpu_torch.sampling import pad_to_bucket, unpad

    for k in KERNELS:
        k.launches = 0
    rates = {}
    for i, (mode, img, args) in enumerate(requests):
        before = {k.symbol: k.launches for k in KERNELS}
        padded, hw = pad_to_bucket(img, pad) if pad else (img, img.shape[1:3])
        x = torch.from_numpy(padded).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = unpad(samplers[mode](x, *args), hw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(out.shape == img.shape and out.dtype == torch.float32, f"{tag} {mode} output shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{tag} {mode} output not finite")
        grew = {k.symbol: k.launches - before[k.symbol] for k in KERNELS}
        check(grew == want, f"{tag} launch counts {grew}, expected {want}")
        if img.shape[0] == rate_batch:
            rates.setdefault(mode, []).append(rate_batch / seconds)
        print(f"[{tag}] {mode:9s} {'x'.join(map(str, img.shape))} (run as {tuple(padded.shape[1:3])}): "
              f"{seconds:.3f} s, {img.shape[0] / seconds:.4f} img/s, launches {grew}")
    for mode, r in rates.items():
        print(f"[{tag}] img/s at batch {rate_batch}, {mode}: {r[-1]:.4f} (last), {r[0]:.4f} (first) "
              f"(host clock; card: {smi})")
    return {k.symbol: k.launches for k in KERNELS}


def phase_denoise_net(dev, opt, stats):
    """The denoising UNet (configs/denoising/test/ir-sde.yml's setting with
    conditional=False: full attention in the mid block) at full width:
    one forward at batch 8, 128 px, kernel path against plain path in
    float32 and bfloat16 (compare_nets); the bf16 kernel forward launches
    K1 17 times and K2a, K2b 8 times each; K1 and K2 at the sites of that
    forward and of the 512 px request, against their plain versions."""
    import torch

    from image_restoration_sde_tpu_torch.models import ConditionalUNet

    setting = {**opt["network_G"]["setting"], "conditional": False}
    nets = make_nets(ConditionalUNet, setting, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 16)
    x = torch.rand(BATCH, SIZE, SIZE, 3, generator=gen, device=dev)
    t = torch.randint(1, 415, (BATCH,), generator=gen, device=dev)
    net = nets[torch.bfloat16, False]
    with recorded_sites() as (ln, attn), torch.inference_mode():
        net(x, None, t)
        big = torch.rand(1, *pad64(DENOISE_ODD_HW), 3, generator=gen, device=dev)
        net(big, None, t[:1])
    check((len(ln), len(attn)) == (2 * DENOISE_LN_PER_FORWARD, 2 * DENOISE_ATTN_PER_FORWARD),
          f"denoising forward: {len(ln) // 2} K1, {len(attn) // 2} K2 launches")
    compare_nets("denoise-net", f"unconditional nf={setting['nf']} depth={setting['depth']} batch {BATCH} "
                 f"{SIZE}px", nets, (x, None, t))
    n = DENOISE_LN_PER_FORWARD
    hold_sites("denoise-net", dev, ln, attn, stats, {f"denoising {BATCH}x{SIZE}px": ln[:n],
                                                     f"denoising 1x{pad64(DENOISE_ODD_HW)[0]}px": ln[n:]})
    del nets
    return net


def phase_denoise_main_path(dev, net, opt, smi):
    """make_denoising_sampler (DenoisingSDE max_sigma 70, T 1000, cosine;
    sigma 50 -> t0 reverse ODE steps; bf16 net, f32 parameters) serves a
    batch of 8 noisy 128 px images and one 500x500 image (reflect-padded to
    512x512), twice; per request exactly 17 t0 K1 and 8 t0 K2a, K2b
    launches."""
    import torch

    from image_restoration_sde_tpu_torch.sampling import make_denoising_sampler
    from image_restoration_sde_tpu_torch.sde import DenoisingSDE

    sde_opt, sigma = opt["sde"], float(opt["degradation"]["sigma"])
    sde = DenoisingSDE.create(sde_opt["max_sigma"], sde_opt["T"], sde_opt["schedule"], device=dev)
    sample = make_denoising_sampler(sde, net, sigma)
    check(sample.t0 == DENOISE_T0, f"optimal timestep {sample.t0} for sigma {sigma}, expected {DENOISE_T0}")
    rng = np.random.default_rng(SEED + 17)

    def noisy(shape):
        clean = rng.random(shape, np.float32)
        return (clean + sigma / 255 * rng.standard_normal(shape, np.float32)).astype(np.float32)

    requests = [("ode", noisy((BATCH, SIZE, SIZE, 3)), ()), ("ode", noisy((1, *DENOISE_ODD_HW, 3)), ())]
    requests.append(("ode", requests[-1][1], ()))
    want = counts(LAYERNORM=DENOISE_LN_PER_FORWARD * sample.t0, LA_CTX=DENOISE_ATTN_PER_FORWARD * sample.t0,
                  LA_APPLY=DENOISE_ATTN_PER_FORWARD * sample.t0)
    print(f"[denoise-main] sigma {sigma:g} -> t0 = {sample.t0} reverse ODE steps per request")
    return serve("denoise-main", dev, requests, {"ode": sample}, want, smi, BATCH, pad=64)


def phase_stereo_net(dev, opt, stats):
    """The stereo NAFNet (configs/stereo-sr/test/refusion.yml: width 64, enc
    [1, 1, 1, 28], mid 1, dec [1, 1, 1, 1], a SCAM after every block) at
    full width and depth: one forward at batch 4 pairs, 128 px, kernel path
    against plain path (compare_nets); the bf16 kernel forward launches K1
    144 times (36 blocks: norm1, norm2 and SCAM's two) and K3 never; K1 at
    the sites of that forward and of the 140x200 request."""
    import torch

    from image_restoration_sde_tpu_torch.models import StereoConditionalNAFNet
    from image_restoration_sde_tpu_torch.ops import NAF_STACK

    setting = opt["network_G"]["setting"]
    nets = make_nets(StereoConditionalNAFNet, setting, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 18)
    lq = torch.rand(STEREO_BATCH, SIZE, SIZE, 6, generator=gen, device=dev)
    xt = lq + torch.randn(lq.shape, generator=gen, device=dev) * 0.2
    t = torch.randint(1, 101, (STEREO_BATCH,), generator=gen, device=dev)
    net = nets[torch.bfloat16, False]
    k3 = NAF_STACK.launches
    with recorded_sites() as (ln, attn), torch.inference_mode():
        net(xt, lq, t)
        odd = torch.rand(1, *STEREO_ODD_HW, 6, generator=gen, device=dev)
        net(odd, odd, t[:1])
    check((len(ln), len(attn), NAF_STACK.launches - k3) == (2 * STEREO_LN_PER_FORWARD, 0, 0),
          f"stereo forward: {len(ln) // 2} K1, {len(attn)} K2, {NAF_STACK.launches - k3} K3 launches")
    compare_nets("stereo-net", f"stereo NAFNet batch {STEREO_BATCH} pairs {SIZE}px", nets, (xt, lq, t))
    hold_sites("stereo-net", dev, ln, attn, stats,
               {f"stereo {STEREO_BATCH}x{SIZE}px pairs": ln[:STEREO_LN_PER_FORWARD]})
    del nets
    return net


def phase_stereo_main_path(dev, net, opt, smi):
    """The IR-SDE restoration sampler with the stereo net (max_sigma 50,
    T 100, cosine, eps 0.005; posterior, 100 steps; bf16 net): a batch of 4
    pairs at 128 px, twice, and one 140x200 pair (zero-padded by the net to
    144x208: SCAM at 18x26 and 9x13); per request exactly 144 x 100 K1."""
    from image_restoration_sde_tpu_torch.sampling import make_restoration_sampler
    from image_restoration_sde_tpu_torch.sde import IRSDE

    sde_opt = opt["sde"]
    sde = IRSDE.create(sde_opt["max_sigma"], sde_opt["T"], sde_opt["schedule"], sde_opt["eps"], device=dev)
    mode = sde_opt["sampling_mode"]
    sampler = {mode: make_restoration_sampler(sde, net, mode=mode)}
    gen = rng_generator(dev, SEED + 19)
    rng = np.random.default_rng(SEED + 19)
    full = (STEREO_BATCH, SIZE, SIZE, 6)
    requests = [(mode, rng.random(full, np.float32), (gen,)), (mode, rng.random(full, np.float32), (gen,)),
                (mode, rng.random((1, *STEREO_ODD_HW, 6), np.float32), (gen,))]
    return serve("stereo-main", dev, requests, sampler, counts(LAYERNORM=STEREO_LN_PER_FORWARD * sde.T), smi,
                 STEREO_BATCH)


def rng_generator(dev, seed):
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def phase_bokeh_net(dev, opt, stats):
    """The bokeh path's nets (configs/latent-bokeh/test/refusion.yml): the
    compressor UNet (ch 64, ch_mult [1, 2, 4], embed_dim 4: latents at H/4),
    kernel path against plain path at each request's shape
    (compare_compressor); the bokeh NAFNet (img_channel 4, width 64, enc
    [2, 2, 4, 8], mid 12, dec [2, 2, 2, 2], lens conditioning) at batch 4 on
    128x128x4 latents, kernel path against plain path (compare_nets); its
    bf16 kernel forward launches K1 72 times and K3 never; K1 and K2 at the
    sites of both nets at both request shapes."""
    import functools

    import torch

    from image_restoration_sde_tpu_torch.models import build_network, init_params_
    from image_restoration_sde_tpu_torch.ops import NAF_STACK

    comp_opt = opt["network_L"]
    compressor = build_network(comp_opt["which_model"], comp_opt["setting"])
    compressor = init_params_(compressor, torch.Generator().manual_seed(SEED + 20)).to(dev).eval()
    plain = build_network(comp_opt["which_model"], comp_opt["setting"], plain=True)
    plain.load_state_dict(compressor.state_dict())
    plain.to(dev).eval()
    gen = rng_generator(dev, SEED + 21)
    sites = ([], [])
    for batch, h, w in bokeh_requests():
        img = torch.rand(batch, h, w, 3, generator=gen, device=dev)
        with recorded_sites() as (ln, attn):
            compare_compressor("bokeh-net", compressor, plain, img)
        sites[0].extend(ln)
        sites[1].extend(attn)
    del plain

    setting = opt["network_G"]["setting"]
    nets = make_nets(functools.partial(build_network, "BokehConditionalNAFNet"), setting, dev)
    ch, down = setting["img_channel"], 2 ** (len(comp_opt["setting"]["ch_mult"]) - 1)
    lat = BOKEH_SIZE // down
    cond = torch.randn(BOKEH_BATCH, lat, lat, ch, generator=gen, device=dev)
    xt = cond + torch.randn(cond.shape, generator=gen, device=dev)
    t = torch.randint(1, 101, (BOKEH_BATCH,), generator=gen, device=dev)
    lens = bokeh_lens(np.random.default_rng(SEED + 21), BOKEH_BATCH, dev)
    net = nets[torch.bfloat16, False]
    k3 = NAF_STACK.launches
    with recorded_sites() as (ln, attn), torch.inference_mode():
        net(xt, cond, t, lens)
        _, oh, ow = bokeh_requests()[1]
        odd = torch.rand(1, oh // down, ow // down, ch, generator=gen, device=dev)
        net(odd, odd, t[:1], tuple(v[:1] for v in lens))
    check((len(ln), len(attn), NAF_STACK.launches - k3) == (2 * BOKEH_LN_PER_FORWARD, 0, 0),
          f"bokeh forward: {len(ln) // 2} K1, {len(attn)} K2, {NAF_STACK.launches - k3} K3 launches")
    compare_nets("bokeh-net", f"bokeh NAFNet batch {BOKEH_BATCH} {lat}x{lat}x{ch}", nets, (xt, cond, t, lens))
    hold_sites("bokeh-net", dev, sites[0] + ln, sites[1] + attn, stats,
               {f"bokeh {BOKEH_BATCH}x{BOKEH_SIZE}px": ln[:BOKEH_LN_PER_FORWARD]})
    del nets
    return net, compressor


def bokeh_requests():
    """(batch, H, W) of the bokeh path's requests after padding."""
    return [(BOKEH_BATCH, BOKEH_SIZE, BOKEH_SIZE), (1, *pad64(BOKEH_ODD_HW))]


def bokeh_lens(rng, batch, dev):
    """Seeded lens values (src, tgt, disparity), each (batch,): lens
    apertures in [1, 20) and a disparity in [0, 1)."""
    import torch

    vals = [rng.uniform(1, 20, batch), rng.uniform(1, 20, batch), rng.random(batch)]
    return tuple(torch.tensor(v, dtype=torch.float32, device=dev) for v in vals)


def phase_bokeh_main_path(dev, net, compressor, opt, smi):
    """The latent sampler with the bokeh net (max_sigma 50, T 100, cosine,
    eps 0.005; posterior, 100 steps; bf16 score net, f32 compressor; lens
    values from the seed as the per-sample cond): a batch of 4 at 512 px,
    twice, and one 700x1000 image (padded to 704x1024); per request exactly
    72 x 100 + 4 K1 and 2 K2a, K2b launches."""
    from image_restoration_sde_tpu_torch.sde import IRSDE
    from image_restoration_sde_tpu_torch.training import make_latent_sampler

    sde_opt = opt["sde"]
    sde = IRSDE.create(sde_opt["max_sigma"], sde_opt["T"], sde_opt["schedule"], sde_opt["eps"], device=dev)
    mode = sde_opt["sampling_mode"]
    sampler = {mode: make_latent_sampler(sde, net, compressor, mode=mode)}
    gen = rng_generator(dev, SEED + 22)
    rng = np.random.default_rng(SEED + 22)
    full = (BOKEH_BATCH, BOKEH_SIZE, BOKEH_SIZE, 3)
    requests = [(mode, rng.random(full, np.float32), (gen, bokeh_lens(rng, BOKEH_BATCH, dev))),
                (mode, rng.random(full, np.float32), (gen, bokeh_lens(rng, BOKEH_BATCH, dev))),
                (mode, rng.random((1, *BOKEH_ODD_HW, 3), np.float32), (gen, bokeh_lens(rng, 1, dev)))]
    want = counts(LAYERNORM=BOKEH_LN_PER_FORWARD * sde.T + COMPRESSOR_LN, LA_CTX=COMPRESSOR_ATTN,
                  LA_APPLY=COMPRESSOR_ATTN)
    return serve("bokeh-main", dev, requests, sampler, want, smi, BOKEH_BATCH, pad=64)


def load_yaml(path):
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from image_restoration_sde_tpu_torch.ops import KERNELS

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    opt, latent_opt, dit_opt = (load_yaml(p) for p in (CONFIG, LATENT_CONFIG, DIT_CONFIG))
    refusion_setting = load_yaml(REFUSION_CONFIG)["network_G"]["setting"]
    sde_opt = opt["sde"]
    setting = opt["network_G"]["setting"]

    t_start = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        torch.cuda.synchronize()
        print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
        return result

    smi = timed("device", phase_device)
    timed("build", phase_build)
    stats = {k: {"err": 0.0, "ms": 0.0, "event_ms": None, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes",
                 "library_ms": None} for k in KERNELS}
    for k in KERNELS[:3]:  # K1, K2a, K2b: summed over sites
        stats[k]["event_ms"] = 0.0
    stats[KERNELS[0]].update(library_ms=0.0, by_path={})  # K1: F.layer_norm; K1 per path
    timed("kernels", phase_kernels, dev, stats, latent_opt, dit_opt)
    net = timed("net", phase_net, dev, setting, sde_opt)
    launches = {"deraining": timed("main path", phase_main_path, dev, net, sde_opt, smi)}
    del net
    latent_net, compressor = timed("latent net", phase_latent_net, dev, latent_opt, refusion_setting, stats)
    launches["latent_dehazing"] = timed("latent main path", phase_latent_main_path, dev, latent_net, compressor,
                                        latent_opt, smi)
    del latent_net, compressor
    timed("dit kernels", phase_flash, dev, stats, dit_opt)
    dit_net, dit_compressor = timed("dit net", phase_dit_net, dev, dit_opt)
    launches["dit"], dit_sampler = timed("dit main path", phase_dit_main_path, dev, dit_net, dit_compressor,
                                         dit_opt, smi)
    launches["tiled"] = timed("tiled", phase_tiled, dev, dit_sampler, dit_opt["sde"]["sample_T"],
                              len(dit_net.blocks), smi)
    del dit_net, dit_compressor, dit_sampler
    torch.cuda.empty_cache()

    launches["linear_attention"] = timed("linear attention", phase_lin_attn, dev, stats)
    denoise_opt, stereo_opt, bokeh_opt = (load_yaml(p) for p in (DENOISE_CONFIG, STEREO_CONFIG, BOKEH_CONFIG))
    denoise_net = timed("denoise net", phase_denoise_net, dev, denoise_opt, stats)
    launches["denoising"] = timed("denoise main path", phase_denoise_main_path, dev, denoise_net, denoise_opt, smi)
    del denoise_net
    stereo_net = timed("stereo net", phase_stereo_net, dev, stereo_opt, stats)
    launches["stereo_sr"] = timed("stereo main path", phase_stereo_main_path, dev, stereo_net, stereo_opt, smi)
    del stereo_net
    bokeh_net, bokeh_compressor = timed("bokeh net", phase_bokeh_net, dev, bokeh_opt, stats)
    launches["latent_bokeh"] = timed("bokeh main path", phase_bokeh_main_path, dev, bokeh_net, bokeh_compressor,
                                     bokeh_opt, smi)

    report = []
    for k in KERNELS:
        by_path = {path: grew[k.symbol] for path, grew in launches.items()}
        report.append({
            "name": k.symbol, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": stats[k]["err"], "ms": stats[k]["ms"], "plain_ms": stats[k]["plain_ms"],
            "bound_ms": stats[k]["bound_ms"], "bound_by": stats[k]["bound_by"],
            "library_ms": stats[k]["library_ms"],
        })
        if stats[k]["event_ms"] is not None:  # the earlier figure, one launch between CUDA events
            report[-1]["event_ms"] = stats[k]["event_ms"]
        if "by_path" in stats[k]:  # K1 over one forward of each path's score net
            report[-1]["by_path"] = stats[k]["by_path"]
    print(f"[done] {time.perf_counter() - t_start:.1f} s; ms / plain_ms / bound_ms / library_ms: K1, K2a, K2b "
          f"summed over one deraining UNet forward's sites at batch {BATCH}, {SIZE}px, bf16, from CUDA graphs "
          f"of 20 calls (event_ms: one launch between CUDA events, the earlier figure); K3 one call at "
          f"batch {LATENT_BATCH}, 8x8x512, 28 blocks, bf16 (one latent NAFNet forward at {LATENT_SIZE}px); K4 one "
          f"call at {FLASH_SHAPES[0]} bf16 (one attention site of a DiT-L/2 forward at batch {DIT_BATCH}, "
          f"{DIT_SIZE}px), library_ms F.scaled_dot_product_attention; K5 (irsde_lin_attn_*) one call of each "
          f"pass at {LIN_ATTN_SHAPES[0]} bf16 from CUDA graphs, bound_ms half the op's bytes and FLOP each; "
          f"K1's by_path: one bf16 forward of each path's score net, from CUDA graphs")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
