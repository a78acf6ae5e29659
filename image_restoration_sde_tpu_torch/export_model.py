"""Export entry point of the PyTorch port: a trained model to a serving
artifact (``exporting.py``).

    python -m image_restoration_sde_tpu_torch.export_model -opt=<yml> --out m.irsdet \\
        [--size 128] [--batch 8] [--steps N] [--bf16] [--per-sample-seed] \\
        [--lens SRC TGT DISPARITY] [--check] [--device cuda|cpu]
    python -m image_restoration_sde_tpu_torch.export_model --inspect m.irsdet

Counterpart of ``tools/export_model.py``: the YAML's task runner
(``runners.build_task``) with ``path.pretrain_model_G`` (and a latent
task's ``pretrain_model_L``) loaded where the YAML names them, else its
seeded weights; pixel tasks (stereo at 6 channels), Gaussian denoising,
latent tasks and the bokeh latent task with its lens values baked in.
``--batch 0`` (the default) exports a symbolic batch.  ``--bf16`` serves at
the bf16 operating point: the score net computes in bf16 on parameters cast
before the export.  The programs call the ``irsde::`` kernel operators.
``--check`` reloads the file and holds its call against the live sampler
with the same generators.  ``--device`` replaces the JAX tool's
``--platforms``: the device the export traces on (the card unless ``cpu``
is asked for); the artifact runs on either.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
from typing import Optional, Sequence

import torch

from . import exporting
from .models import StereoConditionalNAFNet
from .runners import BokehLatentDiffusionTask, GaussianDenoisingTask, LatentDiffusionTask, PixelDiffusionTask, \
    build_task, resolve_device
from .sampling import make_denoising_sampler, make_restoration_sampler
from .sde import rng
from .training import make_latent_sampler
from .utils import options

# the bokeh app's lens values (ref config/latent-bokeh/app.py:31-33)
DEFAULT_LENS = (18.0, 160.0, 35.0)
# --check: the loaded call against the live sampler, |d| / max|live|
CHECK_BOUND = 1e-5


def _serving_net(net, bf16: bool):
    """The score net, rebuilt to compute in bf16 for ``--bf16`` (the same
    parameters; the export casts them)."""
    if bf16 and getattr(net, "dtype", None) == torch.float32:
        net = copy.deepcopy(net)
        net.dtype = torch.bfloat16
    return net.eval()


def export_task(task, opt, size: int, batch: Optional[int], steps: Optional[int], bf16: bool,
                per_sample_seed: bool, lens: Optional[Sequence[float]]):
    """``(artifact bytes, live sampler)`` for the task: ``live(lq, gen)`` is
    the eager sampler the artifact bakes."""
    cast = torch.bfloat16 if bf16 else None
    meta = {"config": opt["name"], "model_type": opt["model"]}
    hw = (size, size)
    net = _serving_net(task.net, bf16)
    common = dict(batch=batch, cast_params=cast, meta=meta)
    sde_opt = opt["sde"]
    mode = sde_opt["sampling_mode"] or "sde"
    if isinstance(task, LatentDiffusionTask):
        cond = None
        if isinstance(task, BokehLatentDiffusionTask):
            cond = tuple(float(v) for v in (lens or DEFAULT_LENS))
        data = exporting.export_latent_sampler(task.sde, net, task.compressor.eval(), hw, mode=mode, steps=steps,
                                               cond=cond, per_sample_seed=per_sample_seed, **common)
        sampler = make_latent_sampler(task.sde, net, task.compressor, mode=mode, steps=steps, cast_params=cast)

        def live(lq, gen):
            c = None if cond is None else tuple(torch.full((lq.shape[0],), v, device=lq.device) for v in cond)
            return sampler(lq, gen, c)

        return data, live
    if isinstance(task, GaussianDenoisingTask):
        data = exporting.export_denoising_sampler(task.sde, net, hw, task.sigma, **common)
        sampler = make_denoising_sampler(task.sde, net, task.sigma, cast_params=cast)
        return data, lambda lq, gen: sampler(lq)
    if isinstance(task, PixelDiffusionTask):
        which, setting = options.network_setting(opt)
        channels = int(setting.get("in_nc") or setting.get("img_channel") or 3)
        if isinstance(task.net, StereoConditionalNAFNet):
            channels *= 2  # the stereo task stacks the eyes
        data = exporting.export_restoration_sampler(task.sde, net, hw, mode=mode, steps=steps, channels=channels,
                                                    per_sample_seed=per_sample_seed, **common)
        return data, make_restoration_sampler(task.sde, net, mode=mode, steps=steps, cast_params=cast)
    raise SystemExit(f"export is not supported for task {type(task).__name__} (pixel and latent diffusion only)")


def check_artifact(path: str, live, device: torch.device, batch: Optional[int]) -> float:
    """Reload ``path`` and hold its call against ``live`` on a seeded batch
    with the same generators; returns max |d| / max |live|."""
    call, header = exporting.load_artifact(path, device)
    b = batch or 2
    H, W = header["size"]
    lq = torch.rand((b, H, W, header.get("channels", 3)), generator=rng.generator(0, "cpu")).to(device)
    seeds = list(range(b)) if header["seed"] == "per_sample" else 0
    got = call(lq, seeds)
    gen = rng.generators_for_seeds(seeds, device) if header["seed"] == "per_sample" else rng.generator(0, device)
    want = live(lq, gen)
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise SystemExit(f"check failed: {tuple(got.shape)} against {tuple(want.shape)}, or not finite")
    err = float((got - want).abs().max() / want.abs().max().clamp_min(1e-12))
    if err > CHECK_BOUND:
        raise SystemExit(f"check failed: the loaded call is {err:.3g} of max|live| from the live sampler")
    print(f"check OK: {tuple(got.shape)}, {err:.3g} of max|live| from the live sampler"
          f"{' (bit-equal)' if torch.equal(got, want) else ''}")
    return err


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-opt", type=str, help="train or test YAML of the model")
    parser.add_argument("--out", type=str, help="artifact output path")
    parser.add_argument("--inspect", type=str, help="print an artifact's header and exit")
    parser.add_argument("--size", type=int, default=128, help="H = W the programs are traced at")
    parser.add_argument("--batch", type=int, default=0, help="0 = a symbolic batch")
    parser.add_argument("--steps", type=int, default=0, help="override sde.sample_T")
    parser.add_argument("--bf16", action="store_true",
                        help="the score net computes in bf16 on parameters cast before the export")
    parser.add_argument("--per-sample-seed", action="store_true",
                        help="call(lq, seeds) with one seed per row: row i depends on seeds[i] alone")
    parser.add_argument("--lens", type=float, nargs=3, default=None, metavar=("SRC", "TGT", "DISPARITY"),
                        help=f"bokeh latent models: the lens values baked in (default {DEFAULT_LENS})")
    parser.add_argument("--check", action="store_true", help="reload the artifact and hold it against the live sampler")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    if args.inspect:
        print(json.dumps(exporting.read_header(args.inspect), indent=2, sort_keys=True))
        return 0
    if not args.opt or not args.out:
        parser.error("-opt and --out are required (or use --inspect)")

    device = resolve_device(args.device)
    opt = options.dict_to_nonedict(options.parse(args.opt, is_train=False))
    task = build_task(opt, int(opt["seed"] or 0), device)
    task.maybe_load_pretrained(task.state)
    steps = args.steps or (int(opt["sde"]["sample_T"]) if opt["sde"]["sample_T"] else None)
    batch = args.batch or None
    data, live = export_task(task, opt, args.size, batch, steps, args.bf16, args.per_sample_seed, args.lens)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "wb") as f:
        f.write(data)
    print(f"wrote {args.out} ({len(data) / 1e6:.1f} MB)")
    print(json.dumps(exporting.read_header(args.out), indent=2, sort_keys=True))
    if args.check:
        check_artifact(args.out, live, device, batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
