#!/usr/bin/env python3
"""Train one demo to its learning curve on one NVIDIA GPU, through the port's
own entry points.

    python3 chip_learn.py --demo {refusion,deraining,stereo,bokeh} [--resume] [--work DIR]

Each demo writes its data from a seed (``gen_synth``, ``data.synthetic``)
under ``DIR/<demo>/data``, copies its shipped YAMLs to ``DIR/<demo>/yml``
with only the dataroots, ``path.root`` and a stage 2's
``pretrain_model_L`` changed (the directory stage 1 wrote to; the YAML's
``{iter}_G`` spelling kept, which the loader resolves to ``{iter}_G.pth``),
and runs each stage as a process of its own: ``python -m
image_restoration_sde_tpu_torch.train -opt=<copy>``, then ``python -m
image_restoration_sde_tpu_torch.test`` on the stage's final checkpoint
(``lastest_EMA.pth`` where the task keeps an EMA, else the last
``{iter}_G.pth``) over the stage's validation set, and where it keeps an
EMA on its raw last ``{iter}_G.pth`` too (``raw_test``).  The demos:

- ``refusion``: ``configs/demo/refusion-two-stage/``, the compressor (1500
  iterations), the latent NAFNet (2000), and the latent NAFNet resumed from
  its 2000 checkpoint to 4000 (``path.resume_state``, ``niter`` 4000), on
  ``gen_synth dehaze``'s 32 + 4 pairs at 512 px;
- ``deraining``: ``configs/deraining/train/ir-sde.yml``'s net
  (ConditionalUNet nf 64, depth 4) at batch 16 of 128 px crops for 4000
  iterations, a validation every 1000 on 4 images with the YAML's
  100-step sampler; data ``data.synthetic.write_pairs`` (64 train pairs,
  4 val);
- ``stereo``: ``configs/demo/stereo_sr.yml`` as shipped, on ``gen_synth
  stereo``'s 24 + 4 pairs;
- ``bokeh``: ``configs/demo/bokeh-two-stage/``, the compressor (1000) and
  the lens-conditioned latent NAFNet (1500), on ``gen_synth bokeh``'s 24 +
  4 triplets.

Standard output is JSON lines: one at each validation (demo, stage,
iteration, val PSNR, seconds since the stage began, the train img/s of
the last print interval), one per stage with the test entry point's
averages and the stage's minutes, and last the input baseline of each
stage over the same validation images, by the same metric code
(``metrics.calculate_psnr`` of ``tensor2img``'s images): LQ against GT
(hazy or rainy input), src against tgt (bokeh), the bicubic x4 of LR
against HR (stereo), with the card's name and power limit.  The entry
points' own logs go to standard error and to ``DIR/<demo>/<stage>.log``.

``--resume`` continues in a work directory that holds an interrupted run:
a stage whose last checkpoint exists is not trained again, and a stage
with a ``training_state`` short of its end resumes from the latest one.
Without CUDA it exits at once.
"""

from __future__ import annotations

import argparse
import copy
import glob
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "image_restoration_sde_tpu_torch"
DEMO_DIR = os.path.join(REPO, "configs", "demo")

# per demo: its data (writer, arguments) and its stages in order, each
# (label, YAML, changes): "compressor" names the stage whose last
# checkpoint is the frozen compressor; "resume" the stage whose last
# training state this one continues, to "extend" times its iterations; "batch",
# "train" and "val_images" the deraining run's budget (BENCH.md's flagship
# run: batch 16, 4000 iterations, a validation every 1000 on 4 images)
DEMOS = {
    "refusion": (("dehaze", {}), (
        ("stage1", os.path.join(DEMO_DIR, "refusion-two-stage", "stage1_compressor.yml"), {}),
        ("stage2", os.path.join(DEMO_DIR, "refusion-two-stage", "stage2_latent_sde.yml"), {"compressor": "stage1"}),
        ("stage2_resumed", os.path.join(DEMO_DIR, "refusion-two-stage", "stage2_latent_sde.yml"),
         {"compressor": "stage1", "resume": "stage2", "extend": 2}),
    )),
    "deraining": (("pairs", {"n_train": 64, "n_val": 4}), (
        ("ir-sde", os.path.join(REPO, "configs", "deraining", "train", "ir-sde.yml"),
         {"batch": 16, "train": {"niter": 4000, "val_freq": 1000}, "val_images": 4}),
    )),
    "stereo": (("stereo", {}), (
        ("stereo_sr", os.path.join(DEMO_DIR, "stereo_sr.yml"), {}),
    )),
    "bokeh": (("bokeh", {}), (
        ("stage1", os.path.join(DEMO_DIR, "bokeh-two-stage", "stage1.yml"), {}),
        ("stage2", os.path.join(DEMO_DIR, "bokeh-two-stage", "stage2.yml"), {"compressor": "stage1"}),
    )),
}
# the data folders of each kind, by split, for each dataroot key
ROOTS = {
    "dehaze": {"dataroot_GT": "GT", "dataroot_LQ": "LQ"},
    "pairs": {"dataroot_GT": "GT", "dataroot_LQ": "LQ"},
    "bokeh": {"dataroot_GT": "tgt", "dataroot_LQ": "src", "dataroot_alpha": "alpha", "dataroot_meta": "meta.txt"},
    "stereo": {"dataroot_GT": "HR", "dataroot_LQ": "LR_x4"},
}
PRINT_LINE = re.compile(r"iter:\s*([\d,]+), lr:[^,]*, img/s:\s*([\d.]+)> loss: (\S+)")
VAL_LINE = re.compile(r"iter:\s*([\d,]+), psnr: (\S+),")
TEST_LINE = re.compile(r"--- \[(.+)\] avg over (\d+): PSNR (\S+) SSIM (\S+) PSNR-Y (\S+) SSIM-Y (\S+) .*"
                       r"time/img (\S+)s")


def write_data(kind: str, out: str, **kw) -> str:
    """The demo's data under ``out``: ``gen_synth``'s trees, or for
    ``pairs`` ``data.synthetic.write_pairs``' train (seed 0) and val (seed
    1) folders; ``kw`` the writer's counts and sizes."""
    from image_restoration_sde_tpu_torch import gen_synth
    from image_restoration_sde_tpu_torch.data.synthetic import write_pairs

    if kind == "pairs":
        n_train, n_val = kw.pop("n_train"), kw.pop("n_val")
        write_pairs(os.path.join(out, "train"), n_train, 0, **kw)
        write_pairs(os.path.join(out, "val"), n_val, 1, **kw)
        return out
    return {"dehaze": gen_synth.write_dehaze, "bokeh": gen_synth.write_bokeh,
            "stereo": gen_synth.write_stereo}[kind](out, **kw)


def load_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def dump_yaml(opt: dict, path: str) -> str:
    import yaml

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(opt, f, sort_keys=False)
    return path


def stage_opt(shipped: dict, kind: str, data: str, root: str, changes: dict) -> dict:
    """A shipped train YAML with its dataroots on ``data``, ``path.root``
    ``root`` and the deraining budget's keys where ``changes`` names them.
    Every other key as shipped."""
    opt = copy.deepcopy(shipped)
    for split in ("train", "val"):
        ds = opt["datasets"][split]
        for key, sub in ROOTS[kind].items():
            if key in ds:
                ds[key] = os.path.join(data, split, sub)
    opt["path"]["root"] = root
    if "batch" in changes:
        opt["datasets"]["train"]["batch_size"] = changes["batch"]
    opt["train"].update(changes.get("train", {}))
    if "val_images" in changes:
        opt["datasets"]["val"]["max_images"] = changes["val_images"]
    return opt


def link(opt: dict, changes: dict, done: dict) -> None:
    """Point a stage 2's ``pretrain_model_L`` into the directory its stage 1
    wrote, at the iteration it ended on, spelled as the YAML spells it
    (``{iter}_G``, with no ``.pth``, in the shipped YAMLs); give a resumed
    stage the ``resume_state`` its stage ended on and ``extend`` times that
    stage's iterations.  ``done``: label -> (models directory, iterations)."""
    if "compressor" in changes:
        models, niter = done[changes["compressor"]]
        suffix = ".pth" if str(opt["path"].get("pretrain_model_L")).endswith(".pth") else ""
        opt["path"]["pretrain_model_L"] = os.path.join(models, f"{niter}_G{suffix}")
    if "resume" in changes:
        models, niter = done[changes["resume"]]
        opt["path"]["resume_state"] = os.path.join(os.path.dirname(models), "training_state", f"{niter}.state")
        opt["train"]["niter"] = changes["extend"] * niter


def test_opt(train_opt: dict, weights: str, root: str) -> dict:
    """The test YAML of a trained stage: its task, nets and SDE, ``weights``
    as ``pretrain_model_G`` (a latent stage's frozen compressor as
    trained), its validation folders as the one test set, every image."""
    val = {k: v for k, v in train_opt["datasets"]["val"].items() if k != "max_images"}
    opt = {k: copy.deepcopy(train_opt[k]) for k in ("model", "distortion", "sde", "degradation", "network_G",
                                                    "network_L") if k in train_opt}
    opt.update(name=f"{train_opt['name']}_test", datasets={"test1": val},
               path={"root": root, "pretrain_model_G": weights,
                     "pretrain_model_L": train_opt["path"].get("pretrain_model_L")})
    return opt


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def run_child(module: str, argv) -> "iter[str]":
    """Run ``python -m module argv`` from the repository, yielding each line
    of its output (standard error included) as it comes; raises where it
    exits non-zero."""
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    with subprocess.Popen([sys.executable, "-m", module, *argv], cwd=REPO, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, bufsize=1) as proc:
        yield from proc.stdout
    check(proc.returncode == 0, f"{module} {' '.join(argv)}: exit code {proc.returncode}")


def baseline_psnr(opt_path: str) -> tuple:
    """(mean PSNR, images) of the input against the GT over the validation
    images a train run of ``opt_path`` scores (its first ``max_images``):
    the sampler's LQ (bicubic x``scale`` for SR) as ``tensor2img`` makes it,
    by ``metrics.calculate_psnr``, as the runners' ``validate`` scores
    their outputs."""
    from image_restoration_sde_tpu_torch.data import create_dataloader, create_dataset
    from image_restoration_sde_tpu_torch.runners import effective_distortion
    from image_restoration_sde_tpu_torch.utils import metrics, options
    from image_restoration_sde_tpu_torch.utils.degradations import upscale
    from image_restoration_sde_tpu_torch.utils.img_utils import tensor2img

    opt = options.dict_to_nonedict(options.parse(opt_path, is_train=True))
    ds_opt = opt["datasets"]["val"]
    loader = create_dataloader(create_dataset(ds_opt), ds_opt, opt)
    total, n = 0.0, 0
    for i, vb in enumerate(loader):
        if i >= (ds_opt["max_images"] or 16):
            break
        lq = vb["LQ"]
        if effective_distortion(opt) == "sr":
            lq = upscale(lq, int(opt["degradation"]["scale"]))
        total += metrics.calculate_psnr(tensor2img(lq[0]), tensor2img(vb["GT"][0]))
        n += 1
    return total / max(1, n), n


def last_checkpoint(models: str, niter: int, keeps_ema: bool) -> str:
    return os.path.join(models, "lastest_EMA.pth" if keeps_ema else f"{niter}_G.pth")


def latest_state(training_state: str):
    """The latest ``{iter}.state`` under ``training_state``, else None."""
    states = glob.glob(os.path.join(training_state, "*.state"))
    return max(states, key=lambda p: int(os.path.basename(p).split(".")[0])) if states else None


def run_demo(demo: str, work: str, device: str = "cuda", runner=run_child, resume: bool = False, data_kw=None,
             edit=None) -> dict:
    """Run the demo's stages in ``work/<demo>`` (see the module's
    docstring), each entry point through ``runner(module, argv)`` (which
    yields its output's lines); ``data_kw`` replaces the data writer's
    arguments and ``edit(opt)`` edits each stage's YAML after the demo's
    own changes (a test's narrowed copies; None for the demo as shipped).
    Prints each JSON record; returns them by kind: ``val``, ``test`` and
    ``baseline``."""
    from image_restoration_sde_tpu_torch.utils import options

    def emit(rec):
        print(json.dumps(rec), flush=True)

    (kind, kw), stages = DEMOS[demo]
    base = os.path.join(work, demo)
    data = os.path.join(base, "data")
    if not (resume and os.path.isdir(data)):
        write_data(kind, data, **dict(data_kw if data_kw is not None else kw))
    done, records = {}, {"val": [], "test": [], "baseline": {}}
    for label, shipped, changes in stages:
        opt = stage_opt(load_yaml(shipped), kind, data, os.path.join(base, "run"), changes)
        if edit:
            edit(opt)
        link(opt, changes, done)
        yml = dump_yaml(opt, os.path.join(base, "yml", f"{label}.yml"))
        paths = options.parse(yml, is_train=True)["path"]
        niter = int(opt["train"]["niter"])
        keeps_ema = opt["model"] != "latent" and not opt["datasets"]["train"]["mode"].startswith("Bokeh")
        weights = last_checkpoint(paths["models"], niter, keeps_ema)
        t0 = time.perf_counter()
        if not (resume and os.path.exists(os.path.join(paths["models"], f"{niter}_G.pth"))):
            state = latest_state(paths["training_state"]) if resume else None
            if state and "resume" not in changes:
                opt["path"]["resume_state"] = state
                dump_yaml(opt, yml)
            ips = None
            with open(os.path.join(base, f"{label}.log"), "a") as f:
                for line in runner(f"{PKG}.train", [f"-opt={yml}", "--device", device]):
                    f.write(line)
                    sys.stderr.write(line)
                    if m := PRINT_LINE.search(line):
                        ips = float(m.group(2))
                    elif m := VAL_LINE.search(line):
                        rec = {"demo": demo, "stage": label, "iter": int(m.group(1).replace(",", "")),
                               "val_psnr": float(m.group(2)), "seconds": round(time.perf_counter() - t0, 1),
                               "img_per_s": ips}
                        records["val"].append(rec)
                        emit(rec)
        train_minutes = (time.perf_counter() - t0) / 60
        check(os.path.exists(weights), f"{demo} {label}: no {weights}")
        done[label] = (paths["models"], niter)
        tests = {"weights": weights}
        if keeps_ema:  # the raw net's last weights too: how far the EMA lags them
            tests["raw_weights"] = os.path.join(paths["models"], f"{niter}_G.pth")
        rec = {"demo": demo, "stage": label, "train_minutes": round(train_minutes, 2)}
        for key, path in tests.items():
            tag = label if key == "weights" else f"{label}_raw"
            test_yml = dump_yaml(test_opt(opt, path, os.path.join(base, "run")),
                                 os.path.join(base, "yml", f"{tag}_test.yml"))
            t1, test = time.perf_counter(), None
            with open(os.path.join(base, f"{label}.log"), "a") as f:
                for line in runner(f"{PKG}.test", [f"-opt={test_yml}", "--device", device]):
                    f.write(line)
                    sys.stderr.write(line)
                    if m := TEST_LINE.search(line):
                        test = {"images": int(m.group(2)), "psnr": float(m.group(3)), "ssim": float(m.group(4)),
                                "psnr_y": float(m.group(5)), "ssim_y": float(m.group(6)),
                                "seconds_per_image": float(m.group(7))}
            check(test is not None, f"{demo} {label}: the test entry point printed no averages")
            rec.update({key: os.path.basename(path), key.replace("weights", "test"): test,
                        key.replace("weights", "test_seconds"): round(time.perf_counter() - t1, 1)})
        records["test"].append(rec)
        emit(rec)
        psnr, n = baseline_psnr(yml)
        records["baseline"][label] = {"psnr": psnr, "images": n}
    emit({"demo": demo, "baseline": records["baseline"],
          "input": {"refusion": "LQ (hazy) against GT", "deraining": "LQ (rainy) against GT",
                    "stereo": "bicubic x4 of LR against HR", "bokeh": "src against tgt"}[demo],
          "card": card() if device == "cuda" else None})
    return records


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], check=True,
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--demo", required=True, choices=sorted(DEMOS))
    parser.add_argument("--resume", action="store_true",
                        help="continue the run in the work directory: skip finished stages, resume a cut one")
    parser.add_argument("--work", default=os.path.join(REPO, "learn_runs"),
                        help="where the data, YAML copies, checkpoints and logs go (default: learn_runs/)")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_learn: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; {card()}", file=sys.stderr, flush=True)
    run_demo(args.demo, args.work, resume=args.resume)
    return 0


if __name__ == "__main__":
    sys.exit(main())
