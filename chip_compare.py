#!/usr/bin/env python3
"""Time K1 and K5 (or K4, or the host enqueue) of two checkouts of the port
on one NVIDIA GPU, in turns.

    python3 chip_compare.py OTHER_CHECKOUT [--enqueue | --k4]

OTHER_CHECKOUT is another checkout of this repository (the parent commit,
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
Each side runs in a process of its own that imports the port's package from
its checkout and builds that checkout's kernels; the sides run in the order
other, this, this, other, and the tables give each side's median.

Measured, bf16 unless named, each from a CUDA graph of 20 back-to-back calls
(``chip_smoke.graph_ms``):

- K1 (``channel_layernorm_cuda``) at every (C, rows) site of one bf16
  forward of each path's score net, recorded from this checkout's nets at
  the serving constants of ``chip_smoke.py`` (deraining and denoising batch
  8 at 128 px and one 512 px image; latent batch 4 at 512 px; stereo 4
  pairs at 128 px; bokeh batch 4 at 512 px), beside ``F.layer_norm`` and
  the bound by bytes; then each path's forward as the sum over its sites;
- K5's context and apply passes (``linear_attention_context_cuda``,
  ``linear_attention_apply_heads_cuda``) at ``chip_smoke.LIN_ATTN_SHAPES``,
  float32 and bfloat16, beside half the op's bound each.

With ``--enqueue`` it times instead the host enqueue per score-net forward
on the six sampler paths, eager: this checkout's ``chip_profile.py
--sampling --form eager`` run on each checkout's package (``--package``),
in the same turns repeated three times, and the table gives each side's
median and quartiles of its six runs a path.

With ``--k4`` it times instead K4's bf16 forward (``flash_mha_cuda``)
and ``F.scaled_dot_product_attention`` on the same tensors at K4_SHAPES
(the DiT-L/2 and DiT-XL/2 sites), CUDA events around one call (the median
of 30 after 3 warm-ups, ``chip_smoke.cuda_ms``), the sides in K4_ROUNDS,
with each side's median and range and the pairs this side won.

The kernels are held against their plain versions by ``chip_smoke.py``;
this script only times them.  Without CUDA it exits at once.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
ROUNDS = ("other", "this", "this", "other")
ENQUEUE_ROUNDS = ROUNDS * 3
# K4 at the DiT-L/2 (head dim 64) and DiT-XL/2 (72) sampling sites and the
# tiled call's; two rounds of turns: one side's medians move a few percent
# between processes
K4_SHAPES = [(2, 4096, 16, 64), (4, 4096, 16, 64), (1, 4096, 16, 72), (2, 4096, 16, 72), (1, 2816, 16, 72)]
K4_ROUNDS = ROUNDS * 2


def smoke():
    """chip_smoke.py as a module, loaded by path: the package it then
    imports is the one first on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def record_sites(cs, dev):
    """{path: [(C, rows), ...]}: the K1 launches of one bf16 forward of each
    path's score net (random weights: only the shapes matter)."""
    import torch

    from image_restoration_sde_tpu_torch.models import (
        ConditionalNAFNet, ConditionalUNet, StereoConditionalNAFNet, build_network,
    )

    def forward(net, *inputs):
        with cs.recorded_sites() as (ln, _), torch.inference_mode():
            net(*inputs)
        return [(C, rows) for C, rows, _ in ln]

    def rand(*shape):
        return torch.rand(shape, device=dev)

    sites = {f"deraining {cs.BATCH}x{cs.SIZE}px": cs.path_shapes()[0]}
    setting = cs.load_yaml(cs.LATENT_CONFIG)["network_G"]["setting"]
    x = rand(cs.LATENT_BATCH, cs.LATENT_SIZE // 8, cs.LATENT_SIZE // 8, setting.get("img_channel", 3))
    t = torch.full((cs.LATENT_BATCH,), 50, device=dev)
    net = cs.make_net(ConditionalNAFNet, setting, torch.bfloat16, False, dev)
    sites[f"latent {cs.LATENT_BATCH}x{cs.LATENT_SIZE}px"] = forward(net, x, x, t)
    setting = {**cs.load_yaml(cs.DENOISE_CONFIG)["network_G"]["setting"], "conditional": False}
    unet = cs.make_net(ConditionalUNet, setting, torch.bfloat16, False, dev)
    t = torch.full((cs.BATCH,), 50, device=dev)
    sites[f"denoising {cs.BATCH}x{cs.SIZE}px"] = forward(unet, rand(cs.BATCH, cs.SIZE, cs.SIZE, 3), None, t)
    h, w = cs.pad64(cs.DENOISE_ODD_HW)
    sites[f"denoising 1x{h}px"] = forward(unet, rand(1, h, w, 3), None, t[:1])
    x = rand(cs.STEREO_BATCH, cs.SIZE, cs.SIZE, 6)
    stereo = cs.make_net(StereoConditionalNAFNet, cs.load_yaml(cs.STEREO_CONFIG)["network_G"]["setting"],
                         torch.bfloat16, False, dev)
    sites[f"stereo {cs.STEREO_BATCH}x{cs.SIZE}px pairs"] = forward(stereo, x, x, t[:cs.STEREO_BATCH])
    opt = cs.load_yaml(cs.BOKEH_CONFIG)
    bokeh = cs.make_net(functools.partial(build_network, "BokehConditionalNAFNet"), opt["network_G"]["setting"],
                        torch.bfloat16, False, dev)
    lat = cs.BOKEH_SIZE // 2 ** (len(opt["network_L"]["setting"]["ch_mult"]) - 1)
    x = rand(cs.BOKEH_BATCH, lat, lat, opt["network_G"]["setting"]["img_channel"])
    lens = cs.bokeh_lens(np.random.default_rng(cs.SEED), cs.BOKEH_BATCH, dev)
    sites[f"bokeh {cs.BOKEH_BATCH}x{cs.BOKEH_SIZE}px"] = forward(bokeh, x, x, t[:cs.BOKEH_BATCH], lens)
    return sites


def side(tree):
    """One side's times as a JSON line: K1 by site, K5 by (dtype, shape)."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    cs = smoke()
    from image_restoration_sde_tpu_torch.ops import linear_attention as LA

    dev = torch.device("cuda", 0)
    sites = json.loads(sys.stdin.read())
    k1 = cs.k1_site_times(dev, [tuple(s) for s in sites])
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 14)
    k5 = {}
    for dtype in (torch.bfloat16, torch.float32):
        for shape in cs.LIN_ATTN_SHAPES:
            q, k, v = ((torch.randn(shape, generator=gen, device=dev) * 1.5).to(dtype) for _ in range(3))
            ctx = LA.linear_attention_context_cuda(k, v)
            k5[f"{str(dtype)[6:]} {shape}"] = (cs.graph_ms(lambda: LA.linear_attention_context_cuda(k, v)),
                                               cs.graph_ms(lambda: LA.linear_attention_apply_heads_cuda(q, ctx)))
    print(json.dumps({"k1": [[C, rows, *t] for (C, rows), t in k1.items()], "k5": k5}))


def side_k4(tree):
    """One side's K4 times as a JSON line: (kernel ms, SDPA ms) by shape."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import torch.nn.functional as F

    cs = smoke()
    from image_restoration_sde_tpu_torch.ops import flash_attention as FA

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 9)
    times = {}
    for shape in K4_SHAPES:
        q, k, v = ((torch.randn(shape, generator=gen, device=dev) * 1.5).bfloat16() for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        scale = shape[-1] ** -0.5
        times[str(shape)] = (cs.cuda_ms(lambda: FA.flash_mha_cuda(q, k, v, scale), reps=30),
                             cs.cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), reps=30))
    print(json.dumps({"k4": times}))


def compare_k4(trees, cs, smi) -> int:
    """K4 bf16 of the two checkouts at K4_SHAPES, in K4_ROUNDS."""
    runs = {"other": [], "this": []}
    for name in K4_ROUNDS:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--side-k4", trees[name]],
                             stdout=subprocess.PIPE, text=True, check=True)
        runs[name].append(json.loads(out.stdout.strip().splitlines()[-1])["k4"])
    n = K4_ROUNDS.count("this")
    print(f"[k4] other = {trees['other']}; K4 bf16 ms, median [min, max] of {n} processes a side in turns "
          f"(other, this, this, other) x {n // 2}; SDPA the median over both sides' processes; card: {smi}")
    for shape in map(str, K4_SHAPES):
        t = {name: [r[shape][0] for r in runs[name]] for name in runs}
        sdpa = statistics.median(r[shape][1] for name in runs for r in runs[name])
        wins = sum(a < b for a, b in zip(t["this"], t["other"]))
        nbytes, flops, _ = cs.flash_work(tuple(json.loads(shape.replace("(", "[").replace(")", "]"))), 2)
        bms, by = cs.bound(nbytes, flops, "bfloat16")
        print(f"[k4] {shape}: other {statistics.median(t['other']):.4f} [{min(t['other']):.4f}, "
              f"{max(t['other']):.4f}] this {statistics.median(t['this']):.4f} [{min(t['this']):.4f}, "
              f"{max(t['this']):.4f}] ({100 * (statistics.median(t['this']) / statistics.median(t['other']) - 1):+.1f}%; "
              f"this lower in {wins} of {n} pairs); sdpa {sdpa:.4f}; least {bms:.4f} ({by})")
    return 0


def compare_enqueue(trees) -> int:
    """Host enqueue per forward of each sampler path, the two checkouts'
    packages in turns under this checkout's ``chip_profile.py --sampling``
    (ENQUEUE_ROUNDS: one process's median moves ~30% between processes, so
    a side takes six runs)."""
    import re

    line = re.compile(r"^\[([\w-]+)\] wall ([\d.]+) ms/step; host enqueue ([\d.]+) ms/forward")
    runs = {"other": [], "this": []}
    for name in ENQUEUE_ROUNDS:
        out = subprocess.run([sys.executable, os.path.join(REPO, "chip_profile.py"), "--sampling", "--form", "eager",
                              "--package", trees[name]], stdout=subprocess.PIPE, text=True, check=True).stdout
        runs[name].append({m[1]: (float(m[2]), float(m[3])) for m in map(line.match, out.splitlines()) if m})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60).stdout.strip()
    n = ENQUEUE_ROUNDS.count("this")
    print(f"[enqueue] other = {trees['other']}; host enqueue ms per forward (median and quartiles of {n} runs a "
          f"side, in turns other, this, this, other) and wall ms per step (median); pairs: the k-th run of each "
          f"side; card: {smi}")
    for path in runs["this"][0]:
        enq = {name: [r[path][1] for r in runs[name]] for name in runs}
        q = {name: np.percentile(v, [25, 50, 75]) for name, v in enq.items()}
        wall = {name: statistics.median(r[path][0] for r in runs[name]) for name in runs}
        wins = sum(t < o for t, o in zip(enq["this"], enq["other"]))
        print(f"[enqueue] {path}: other {q['other'][1]:.3f} [{q['other'][0]:.3f}, {q['other'][2]:.3f}] this "
              f"{q['this'][1]:.3f} [{q['this'][0]:.3f}, {q['this'][2]:.3f}] "
              f"({100 * (q['this'][1] / q['other'][1] - 1):+.1f}%; this lower in {wins} of {n} pairs); wall other "
              f"{wall['other']:.3f} this {wall['this']:.3f}")
    return 0


def main() -> int:
    import torch

    if len(sys.argv) == 3 and sys.argv[1] in ("--side", "--side-k4"):
        (side if sys.argv[1] == "--side" else side_k4)(sys.argv[2])
        return 0
    if len(sys.argv) not in (2, 3) or sys.argv[2:] not in ([], ["--enqueue"], ["--k4"]):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_compare: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    trees = {"other": os.path.abspath(sys.argv[1]), "this": REPO}
    sys.path.insert(0, REPO)
    cs = smoke()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[compare] {smi}; torch {torch.__version__} cuda {torch.version.cuda}; other = {trees['other']}")

    # both libraries built at once, before any timing
    builds = [subprocess.Popen([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                                "from image_restoration_sde_tpu_torch import kernels; "
                                "print(sys.argv[1], 'built in %.1f s' % kernels.build()[1])", tree])
              for tree in trees.values()]
    if any(b.wait() != 0 for b in builds):
        return 1
    if "--enqueue" in sys.argv[2:]:
        return compare_enqueue(trees)
    if "--k4" in sys.argv[2:]:
        return compare_k4(trees, cs, smi)

    sites = record_sites(cs, torch.device("cuda", 0))
    distinct = sorted({s for path in sites.values() for s in path})
    runs = {"other": [], "this": []}
    for name in ROUNDS:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--side", trees[name]],
                             input=json.dumps(distinct), stdout=subprocess.PIPE, text=True, check=True)
        runs[name].append(json.loads(out.stdout.strip().splitlines()[-1]))

    def med(name, key, pick):
        return statistics.median(pick(r[key]) for r in runs[name])

    for r in runs["other"] + runs["this"]:
        r["k1"] = {(C, rows): t for C, rows, *t in r["k1"]}
    k1 = {}
    for site in distinct:
        k1[site] = {name: med(name, "k1", lambda r: r[site][0]) for name in runs}
        k1[site]["lib"] = statistics.median(r["k1"][site][1] for name in runs for r in runs[name])
    print("[compare] K1 per site, bf16, ms (median of 2 runs a side): C rows | other this | bound | F.layer_norm")
    for (C, rows), t in k1.items():
        bms, _ = cs.bound(*cs.ln_work([(C, rows)]), "bfloat16")
        print(f"[compare] K1 {C:5d} {rows:7d} | {t['other']:.4f} {t['this']:.4f} | {bms:.4f} | {t['lib']:.4f}")
    print("[compare] K1 per path, one forward, bf16, ms: other this | bound | F.layer_norm")
    for label, path in sites.items():
        tot = {key: sum(k1[s][key] for s in path) for key in ("other", "this", "lib")}
        bms, _ = cs.bound(*cs.ln_work(path), "bfloat16")
        print(f"[compare] K1 {label} ({len(path)} launches): {tot['other']:.4f} {tot['this']:.4f} | {bms:.4f} | "
              f"{tot['lib']:.4f}")
    print("[compare] K5 per shape, ms: other context / apply | this context / apply | bound each")
    for key in runs["this"][0]["k5"]:
        dtype, shape = key.split(" ", 1)
        nbytes, flops = cs.lin_attn_work(tuple(json.loads(shape.replace("(", "[").replace(")", "]"))),
                                         2 if dtype == "bfloat16" else 4)
        bms, _ = cs.bound(nbytes / 2, flops / 2, dtype)
        o = [med("other", "k5", lambda r: r[key][j]) for j in (0, 1)]
        t = [med("this", "k5", lambda r: r[key][j]) for j in (0, 1)]
        print(f"[compare] K5 {key}: {o[0]:.4f} / {o[1]:.4f} | {t[0]:.4f} / {t[1]:.4f} | {bms:.4f}")
    print(f"[compare] card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
