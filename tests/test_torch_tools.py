"""PyTorch port, the remaining tools on the CPU: ``interpolation`` against
the JAX package's ``forward_sde`` with the same injected noise, and its
PNGs; ``app``'s restore callable with ``gradio`` stubbed (as
``tests/test_app_smoke.py`` does) and without it; ``eval_parity`` on a
tiny net and a synthetic pair, by its targets; ``trace_summary`` on a CPU
capture and on a card's trace written by hand."""

import json
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from image_restoration_sde_tpu.sde import IRSDE as JaxIRSDE
from image_restoration_sde_tpu.sde import samplers as jsamplers
from image_restoration_sde_tpu_torch import app, eval_parity, interpolation, trace_summary
from image_restoration_sde_tpu_torch.data.io_utils import read_img, save_img
from image_restoration_sde_tpu_torch.data.synthetic import write_pairs
from image_restoration_sde_tpu_torch.models import ConditionalUNet, init_params_
from image_restoration_sde_tpu_torch.utils import lpips, profiling


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs several workers on the machine's
    cores, and the nets are tiny."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pngs(tmp_path, hw=(24, 20)):
    r = np.random.default_rng(0)
    paths = []
    for name in ("src", "tgt"):
        path = str(tmp_path / f"{name}.png")
        save_img((r.random((*hw, 3)) * 255).astype(np.uint8), path)
        paths.append(path)
    return paths


def test_interpolation_matches_jax_forward_sde(tmp_path):
    """T = 7 states of the forward SDE from the source to the target with
    injected numpy noise: within 1e-6 of max|state| of the JAX package's
    ``forward_sde`` (float32, the same steps); the entry point writes T
    PNGs from its own generator."""
    src_path, tgt_path = _pngs(tmp_path)
    src, tgt = read_img(src_path), read_img(tgt_path)
    T = 7
    noise = np.random.default_rng(1).standard_normal((T, 1, *src.shape)).astype(np.float32)
    jsde = JaxIRSDE.create(max_sigma=1.0, T=T, schedule="cosine", eps=0.01)
    _, want = jsamplers.forward_sde(jsde, jnp.asarray(src)[None], jnp.asarray(tgt)[None], return_all=True,
                                    noise_seq=jnp.asarray(noise))
    want = np.asarray(want)[:, 0]
    got = interpolation.interpolate(src, tgt, T=T, device="cpu", noise_seq=torch.from_numpy(noise)).numpy()
    assert got.shape == (T, *src.shape)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    out = tmp_path / "states"
    assert interpolation.main(["-s", src_path, "-t", tgt_path, "--save", str(out), "-T", str(T),
                               "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == sorted(f"state_{t}.png" for t in range(1, T + 1))
    with pytest.raises(ValueError, match="must match"):
        interpolation.interpolate(src, tgt[:-1], device="cpu")


def _app_yaml(tmp_path) -> str:
    cfg = {"name": "app-smoke", "model": "denoising", "distortion": "derain",
           "sde": {"max_sigma": 10, "T": 3, "schedule": "cosine", "eps": 0.005, "sampling_mode": "sde"},
           "degradation": {"sigma": 25, "noise_type": "G", "scale": 4}, "datasets": {},
           "network_G": {"which_model_G": "ConditionalUNet", "setting": {"in_nc": 3, "out_nc": 3, "nf": 8, "depth": 2}},
           "path": {"root": str(tmp_path)}}
    path = tmp_path / "app.yml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def test_app_restore_callable_with_gradio_stubbed_and_without(tmp_path, monkeypatch):
    """``main`` builds the interface over the restore callable and launches
    it on the port given (``gradio`` a stub); the callable restores a uint8
    image to a uint8 image of its shape, the same bits each call (its
    generator seeded), and builds without ``gradio``."""
    captured = {}

    class _Interface:
        def __init__(self, fn=None, **kw):
            captured.update(fn=fn, kw=kw)

        def launch(self, **kw):
            captured["launched"] = kw

    stub = types.ModuleType("gradio")
    stub.Interface, stub.Image = _Interface, lambda **kw: None
    monkeypatch.setitem(sys.modules, "gradio", stub)
    yml = _app_yaml(tmp_path)
    app.main([f"-opt={yml}", "--port", "7999", "--device", "cpu"])
    assert captured["launched"] == {"server_port": 7999} and "app-smoke" in captured["kw"]["title"]
    img = (np.random.default_rng(0).random((40, 56, 3)) * 255).astype(np.uint8)
    out = captured["fn"](img)
    assert out.shape == img.shape and out.dtype == np.uint8
    monkeypatch.delitem(sys.modules, "gradio")
    restore = app.make_restore(yml, "cpu")
    np.testing.assert_array_equal(restore(img), out)


@pytest.fixture(scope="module")
def parity_assets(tmp_path_factory):
    """A seeded ConditionalUNet (nf 8, depth 2) saved as a ``.pth``, two
    64 px synthetic pairs, seeded LPIPS weights."""
    root = tmp_path_factory.mktemp("parity")
    setting = {"in_nc": 3, "out_nc": 3, "nf": 8, "depth": 2}
    pth = root / "seeded_G.pth"
    torch.save(init_params_(ConditionalUNet(**setting), torch.Generator().manual_seed(0)).state_dict(), pth)
    write_pairs(str(root / "data"), 2, seed=1, shape=(64, 64))
    lp = root / "lpips.pth"
    torch.save(lpips.seeded_state_dict("alex", seed=1), lp)
    return root, setting, str(pth), str(lp)


@pytest.mark.parametrize("target,rc", [(3.0, 0), (None, 1)], ids=["reachable", "published"])
def test_eval_parity_prints_the_metric_rows_and_exits_by_its_targets(parity_assets, capsys, target, rc):
    """4 posterior steps in float32 on the CPU: a row per image and the
    table (LPIPS through the port's module and the seeded weights), the
    restored PNGs written; exit 0 against a reachable PSNR target, 1
    against the published Rain100H one (a seeded net is far below it)."""
    root, setting, pth, lp = parity_assets
    out_dir = root / f"out_{rc}"
    argv = ["--data", str(root / "data"), "--pth", pth, "--setting", json.dumps(setting), "--T", "4",
            "--dtype", "f32", "--device", "cpu", "--lpips-pth", lp, "--save-dir", str(out_dir)]
    assert eval_parity.main(argv + ([] if target is None else ["--target-psnr", str(target)])) == rc
    out = capsys.readouterr().out
    rows = [line for line in out.splitlines() if line.strip().startswith(("1 ", "2 "))]
    assert len(rows) == 2 and "parity vs reference (2 images, posterior sampling, 4 steps, f32, cpu)" in out
    psnrs = [float(row.split("PSNR")[1].split()[0]) for row in rows]
    lpips_values = [float(row.split("LPIPS")[1].split()[0]) for row in rows]
    avg = [line for line in out.splitlines() if line.startswith("PSNR ")][0]
    assert np.isclose(float(avg.split()[1]), np.mean(psnrs), atol=5e-4) and all(v >= 0 for v in lpips_values)
    assert ("PASS" in out) == (rc == 0) and ("FAIL" in out) == (rc == 1)
    assert len(os.listdir(out_dir)) == 2


def test_trace_summary_on_a_cpu_capture_and_a_card_trace(tmp_path, capsys):
    """A ``utils.profiling.trace`` capture of a tiny UNet forward on the
    CPU: the host operators by self time (``cpu``), shares at most 100%,
    a convolution among the top ops.  A card's trace written by hand (two
    cards, a parent operator holding a child): kernels summed per card,
    the parent's self time its duration less its child's."""
    net = ConditionalUNet(in_nc=3, out_nc=3, nf=8, depth=2)
    x = torch.rand(1, 16, 16, 3)
    with torch.inference_mode(), profiling.trace(str(tmp_path / "cap")):
        net(x, x, torch.tensor([3.0]))
    assert trace_summary.main([str(tmp_path / "cap"), "--top", "8"]) == 0
    out = capsys.readouterr().out
    assert "== cpu" in out and "conv" in out
    shares = [float(line.split()[1]) for line in out.splitlines()[4:] if line.strip()]
    assert 0 < sum(shares) <= 100.5

    events = [
        {"ph": "X", "cat": "kernel", "name": "irsde_layernorm", "ts": 0, "dur": 30, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "irsde_layernorm", "ts": 40, "dur": 10, "args": {"device": 0}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 60, "dur": 60, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm", "ts": 0, "dur": 25, "args": {"device": 1}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0, "dur": 100, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 10, "dur": 30, "pid": 1, "tid": 1},
    ]
    path = tmp_path / "card.json"
    path.write_text(json.dumps({"traceEvents": events}))
    totals = trace_summary.summarize(trace_summary.load_events(str(path)))
    assert totals["cuda:0"] == {"irsde_layernorm": [40.0, 2], "Memcpy HtoD": [60.0, 1]}
    assert totals["cuda:1"] == {"sm90_xmma_gemm": [25.0, 1]}
    host = trace_summary.host_totals(events)
    assert host == {"aten::conv2d": [70.0, 1], "aten::add": [30.0, 1]}
    assert trace_summary.main([str(path), "--device", "cuda:1"]) == 0
    out = capsys.readouterr().out
    assert "== cuda:1" in out and "matmul 100.0%" in out and "cuda:0" not in out
