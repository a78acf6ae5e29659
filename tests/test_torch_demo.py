"""The demo YAMLs (``configs/demo/``) and the flagship deraining YAML chained
through the port's train and test entry points on the CPU, as
``chip_learn.py`` runs them on the card: narrowed copies (widths 8, one
block a level, 32 px crops of 64 px data from ``gen_synth`` and
``data.synthetic``, 2 iterations, a validation at 2, samplers at 3 steps);
each stage 2 loads its stage 1's ``{iter}_G.pth`` through the YAML's
``{iter}_G`` spelling, and the Refusion stage 2 is resumed through
``path.resume_state``.  Also the loader's resolution of that spelling, and
the fault of the shipped stage-2 YAMLs it leaves."""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import math
import os
import sys

import pytest
import torch

from image_restoration_sde_tpu_torch.training.checkpoint import load_params, resolve_params_path
from image_restoration_sde_tpu_torch.utils import options

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_learn  # noqa: E402

DATA = {
    "refusion": {"n_train": 2, "n_val": 1, "size": 64},
    "bokeh": {"n_train": 2, "n_val": 1, "size": 64},
    "stereo": {"n_train": 2, "n_val": 1, "train_size": 64, "val_size": 64},
    "deraining": {"n_train": 2, "n_val": 1, "min_size": 48, "max_size": 64},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread in this module: the suite runs several workers on
    the machine's cores, where many threads a worker spin on tiny ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def narrow(opt: dict) -> None:
    """A demo YAML cut to a CPU test: every net 8 wide with one block a
    level (the compressors 4 wide, two levels), batch 2 of 32 px crops (8 px
    LR for stereo SR), 2 iterations with a validation and a save point at 2,
    one validation image, samplers at 3 steps."""
    opt["use_tb_logger"] = False
    for key in ("network_G", "network_L"):
        if key not in opt:
            continue
        setting = opt[key]["setting"]
        if "ch_mult" in setting:  # the compressor UNet
            setting.update(ch=4, ch_mult=[1, 2])
        elif "nf" in setting:  # ConditionalUNet
            setting.update(nf=8, depth=2)
        else:  # the NAFNet family
            setting.update(width=8, enc_blk_nums=[1] * len(setting["enc_blk_nums"]), middle_blk_num=1,
                           dec_blk_nums=[1] * len(setting["dec_blk_nums"]))
    train = opt["datasets"]["train"]
    sr = train.get("scale", 1) if opt.get("distortion") == "sr" else 1
    train.update(batch_size=2, GT_size=32, LR_size=32 // sr, n_workers=1)
    opt["datasets"]["val"]["max_images"] = 1
    opt["train"].update(niter=2, val_freq=2)
    opt["logger"] = {**(opt.get("logger") or {}), "print_freq": 1, "save_checkpoint_freq": 2}
    opt["sde"]["sample_T"] = 3


def in_process(module, argv):
    """``module.main(argv)`` in this process (a child process would pay
    torch's import again), its log lines yielded after it returns."""
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf), contextlib.redirect_stdout(buf):
        assert importlib.import_module(module).main(list(argv)) == 0
    yield from buf.getvalue().splitlines(keepends=True)


@pytest.mark.parametrize("demo", ["refusion", "bokeh", "stereo", "deraining"])
def test_demo_chains_through_train_and_test(demo, tmp_path, capsys):
    out = chip_learn.run_demo(demo, str(tmp_path), device="cpu", runner=in_process, data_kw=DATA[demo], edit=narrow)
    records = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    stages = [label for label, _, _ in chip_learn.DEMOS[demo][1]]
    want_iters = {"stage2_resumed": 4}
    assert [(r["stage"], r["iter"]) for r in out["val"]] == [(s, want_iters.get(s, 2)) for s in stages]
    assert all(math.isfinite(r["val_psnr"]) and r["img_per_s"] > 0 for r in out["val"])
    assert [r["stage"] for r in out["test"]] == stages
    assert all(r["test"]["images"] == 1 and math.isfinite(r["test"]["psnr"]) for r in out["test"])
    raw = {"refusion": ["stage2", "stage2_resumed"], "bokeh": [], "stereo": ["stereo_sr"], "deraining": ["ir-sde"]}
    assert [r["stage"] for r in out["test"] if "raw_test" in r] == raw[demo]  # where an EMA is kept
    assert all(math.isfinite(r["raw_test"]["psnr"]) for r in out["test"] if "raw_test" in r)
    assert sorted(out["baseline"]) == sorted(stages)
    assert all(b["images"] == 1 and math.isfinite(b["psnr"]) for b in out["baseline"].values())
    assert records[-1]["demo"] == demo and records[-1]["baseline"] == out["baseline"]
    base = tmp_path / demo
    for label, _, changes in chip_learn.DEMOS[demo][1]:
        opt = options.parse(str(base / "yml" / f"{label}.yml"), is_train=True)
        if "compressor" in changes:  # the YAML's spelling: {iter}_G, loaded from {iter}_G.pth
            spelled = opt["path"]["pretrain_model_L"]
            assert os.path.basename(spelled) == "2_G" and not os.path.exists(spelled)
            assert os.path.exists(spelled + ".pth")
        if "resume" in changes:
            assert opt["path"]["resume_state"].endswith(os.path.join("training_state", "2.state"))
            log = (base / f"{label}.log").read_text()
            assert "Resuming training from epoch" in log and "iter 2" in log
            assert os.path.exists(os.path.join(opt["path"]["models"], "4_G.pth"))


def test_params_path_resolves_the_missing_suffix(tmp_path):
    """``{iter}_G`` loads ``{iter}_G.pth`` where only that exists; a path
    that is there loads as given; neither raises, naming the path."""
    sd = {"w": torch.arange(3.0)}
    torch.save(sd, str(tmp_path / "10_G.pth"))
    spelled = str(tmp_path / "10_G")
    assert resolve_params_path(spelled) == spelled + ".pth"
    assert torch.equal(load_params(spelled)["w"], sd["w"])
    assert resolve_params_path(spelled + ".pth") == spelled + ".pth"
    with pytest.raises(FileNotFoundError, match="20_G"):
        load_params(str(tmp_path / "20_G"))
    with pytest.raises(FileNotFoundError, match="20_G.pth"):
        load_params(str(tmp_path / "20_G.pth"))


@pytest.mark.parametrize("demo", ["refusion-two-stage", "bokeh-two-stage"])
def test_shipped_stage2_names_no_directory_stage1_writes(demo):
    """A fault of the shipped YAMLs (both packages write where these parse
    to): each stage 2's ``pretrain_model_L`` lies outside the models
    directory its stage 1 writes to, wherever the run's root is; so the
    demo scripts point it there (``chip_learn.link``)."""
    stage1, stage2 = sorted(os.listdir(os.path.join(chip_learn.DEMO_DIR, demo)))
    models = options.parse(os.path.join(chip_learn.DEMO_DIR, demo, stage1), is_train=True)["path"]["models"]
    spelled = chip_learn.load_yaml(os.path.join(chip_learn.DEMO_DIR, demo, stage2))["path"]["pretrain_model_L"]
    assert not spelled.endswith(".pth") and os.path.dirname(spelled) != models


def test_chip_learn_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert chip_learn.main(["--demo", "stereo"]) == 2
    assert "needs an NVIDIA GPU" in capsys.readouterr().err
