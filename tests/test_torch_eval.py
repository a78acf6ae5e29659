"""PyTorch port, evaluation: the test entry point against the JAX package's
``tools/test.py`` on the deterministic tasks with the same ``.pth``; the
runners' ``infer`` preparation and ``sample_batch`` through the tiled entry
points; stereo metrics per eye; every test YAML's task; the entry points'
default device; TLSC (``local_avg_pool`` and ``CNAFNetLocal``) against
flax."""

import glob
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_sde_tpu import runners as jrunners
from image_restoration_sde_tpu import sampling as jsampling
from image_restoration_sde_tpu.models import modules as jmodules
from image_restoration_sde_tpu.models.nafnet import ConditionalNAFNet as FlaxNAFNet
from image_restoration_sde_tpu.ops import naf_stack as jns
from image_restoration_sde_tpu_torch import inference, restore, runners, test, tiling
from image_restoration_sde_tpu_torch.data.io_utils import read_img_uint8
from image_restoration_sde_tpu_torch.data.synthetic import write_masks, write_pairs, write_stereo
from image_restoration_sde_tpu_torch.models import build_network, modules
from image_restoration_sde_tpu_torch.models import nafnet as pnafnet
from image_restoration_sde_tpu_torch.sde import rng
from image_restoration_sde_tpu_torch.utils import nafnet_flax_keys, options, state_dict_from_flax
from test_torch_nafnet import randomize
from test_torch_unet import flatten, unflatten

REPO = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*", "test", "*.yml")))
UNET_DENOISE = "{which_model_G: ConditionalUNet, setting: {in_nc: 3, out_nc: 3, nf: 8, depth: 2}}"
COMPRESSOR = "{which_model_G: UNet, setting: {in_ch: 3, out_ch: 3, ch: 4, ch_mult: [1, 2], embed_dim: 4}}"
# the deterministic tasks the two test drivers run on the same .pth: the
# compressor's cross decode (configs/unet-latent/test/test_latent.yml at a
# tiny width) and Gaussian denoising with the noisy LQ given (the reverse
# ODE from sigma 25's optimal timestep, 22 steps of T 100)
DRIVER_CASES = {
    "compressor": ("latent", "dehazing", COMPRESSOR, "{max_sigma: 50, T: 100, schedule: cosine, eps: 0.005}"),
    "denoising": ("denoising", "denoising", UNET_DENOISE, "{max_sigma: 70, T: 100, schedule: cosine}"),
}
AVG_LINE = re.compile(r"avg over (\d+): PSNR (\S+) SSIM (\S+) PSNR-Y (\S+) SSIM-Y (\S+)")
IMAGE_LINE = re.compile(r"- (\S+)\s+\| PSNR (\S+) SSIM (\S+) \| PSNR-Y (\S+) SSIM-Y (\S+)")

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread in this module: the suite runs several workers on
    the machine's cores, where many threads a worker spin on tiny ops."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _test_yaml(path, root, model, distortion, network, sde, dataset, extra=""):
    with open(path, "w") as f:
        f.write(f"""name: tiny
suffix: null
model: {model}
distortion: {distortion}
gpu_ids: [0]
sde: {sde}
degradation: {{sigma: 25, noise_type: G, scale: 4}}
datasets:
  test1: {dataset}
network_G: {network}
path: {{root: {root}, pretrain_model_G: {root}/net.pth}}
{extra}""")
    return str(path)


def _seeded_pth(yml, path, seed=3):
    """The YAML's task's net as the train entry point initialises it from
    ``seed``, saved as the reference's ``.pth``."""
    opt = options.dict_to_nonedict(options.parse(yml, is_train=False))
    opt["path"]["pretrain_model_G"] = None
    torch.save(runners.build_task(opt, seed, "cpu").net.state_dict(), path)


def _log_lines(root):
    """(per-image metric rows, the set's average row) of a test log under
    ``root``."""
    (log,) = glob.glob(os.path.join(root, "results", "*", "tiny", "test_tiny_*.log"))
    text = open(log).read()
    images = [tuple(float(v) for v in m.groups()[1:]) for m in IMAGE_LINE.finditer(text)]
    (avg,) = AVG_LINE.findall(text)
    return images, tuple(float(v) for v in avg)


@pytest.fixture(scope="module")
def jax_driver_runs(tmp_path_factory):
    """Per case of DRIVER_CASES: its directory, with a YAML a side, the
    ``.pth`` and two LQ/GT pairs of odd sizes, and ``tools/test.py`` (JAX,
    CPU, float32 convolutions) started on it; both cases run at once."""
    runs = {}
    for case, (model, distortion, network, sde) in sorted(DRIVER_CASES.items()):
        root = tmp_path_factory.mktemp(case)
        data = write_pairs(str(root / "data"), 2, seed=5, min_size=21, max_size=30)
        dataset = f"{{name: pairs, mode: LQGT, dataroot_GT: {data}/GT, dataroot_LQ: {data}/LQ}}"
        ymls = {side: _test_yaml(root / f"{side}.yml", root / side, model, distortion, network, sde, dataset)
                for side in ("jax", "port")}
        os.makedirs(root / "jax")
        os.makedirs(root / "port")
        _seeded_pth(ymls["port"], root / "port" / "net.pth")
        os.link(root / "port" / "net.pth", root / "jax" / "net.pth")
        env = {**os.environ, "IRSDE_PLATFORM": "cpu", "JAX_DEFAULT_MATMUL_PRECISION": "highest",
               "JAX_COMPILATION_CACHE_DIR": str(root / "jax_cache"), "OMP_NUM_THREADS": "1",
               "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1",
               "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
        proc = subprocess.Popen([sys.executable, os.path.join(REPO, "tools", "test.py"), f"-opt={ymls['jax']}"],
                                cwd=str(root), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        runs[case] = (root, ymls["port"], proc)
    yield runs
    for _, _, proc in runs.values():
        proc.kill()
        proc.communicate()


@pytest.mark.parametrize("case", sorted(DRIVER_CASES))
def test_test_entry_point_matches_the_jax_driver(jax_driver_runs, case):
    """``python -m image_restoration_sde_tpu_torch.test`` and ``tools/test.py``
    on one YAML and one ``.pth``, two LQ/GT pairs of odd sizes: every
    output, LQ and GT PNG within 1 level of 255, and each logged PSNR,
    SSIM, PSNR-Y and SSIM-Y within 1e-3 (the image rows and the set's
    average)."""
    tmp_path, yml, proc = jax_driver_runs[case]
    assert test.main([f"-opt={yml}", "--device", "cpu"]) == 0
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]

    pngs = {side: sorted(glob.glob(str(tmp_path / side / "results" / "*" / "tiny" / "pairs" / "*.png")))
            for side in ("jax", "port")}
    names = [os.path.basename(p) for p in pngs["port"]]
    assert names == [os.path.basename(p) for p in pngs["jax"]] and len(names) == 6  # output, LQ, GT a pair
    for a, b in zip(pngs["jax"], pngs["port"]):
        want, got = read_img_uint8(a).astype(int), read_img_uint8(b).astype(int)
        assert got.shape == want.shape and np.abs(got - want).max() <= 1, os.path.basename(b)
    (j_images, j_avg), (p_images, p_avg) = _log_lines(str(tmp_path / "jax")), _log_lines(str(tmp_path / "port"))
    assert len(p_images) == len(j_images) == 2 and j_avg[0] == p_avg[0] == 2
    np.testing.assert_allclose(np.array(p_images), np.array(j_images), rtol=0, atol=1e-3)
    np.testing.assert_allclose(np.array(p_avg[1:]), np.array(j_avg[1:]), rtol=0, atol=1e-3)


# ------------------------------------------------- infer and sample_batch
def _pixel_task(tmp_path, distortion="derain", extra="", dataset_mode="LQGT", seed=0):
    data = write_pairs(str(tmp_path / "data"), 1, seed=2, min_size=17, max_size=23)
    lq = f", dataroot_LQ: {data}/LQ" if dataset_mode == "LQGT" else ""
    dataset = f"{{name: pairs, mode: {dataset_mode}, dataroot_GT: {data}/GT{lq}}}"
    sde = "{max_sigma: 10, T: 100, schedule: cosine, eps: 0.005, sample_T: 3, sampling_mode: sde}"
    yml = _test_yaml(tmp_path / "t.yml", tmp_path, "denoising", distortion, UNET_DENOISE, sde, dataset, extra)
    opt = options.dict_to_nonedict(options.parse(yml, is_train=False))
    return runners.build_task(opt, seed, "cpu"), opt


class _JaxTaskView:
    """What the JAX task's ``prepare_pair`` reads of its task: the options
    and the degradation generator (seeded as both packages seed it)."""

    def __init__(self, opt, seed):
        self.opt, self.deg_rng = opt, np.random.default_rng(seed + 77)


@pytest.mark.parametrize("distortion", ["derain", "sr", "inpainting"])
def test_infer_prepares_the_pair_as_the_jax_task(tmp_path, distortion):
    """``prepare_lq`` against the JAX ``PixelDiffusionTask.prepare_pair``
    (the same generator seed: the same inpainting masks), to float32
    rounding (1e-6): the LQ as given, SR bicubic-upscaled x4, the GT
    masked; ``infer`` hands its sampler that LQ reflect-padded to the 64
    bucket (the JAX ``pad_to_bucket``) and crops the result back."""
    extra = ""
    if distortion == "inpainting":
        extra = f"degradation: {{sigma: 25, noise_type: G, scale: 4, mask_root: {write_masks(str(tmp_path / 'm'), 4, 0, 32)}}}\n"
    task, opt = _pixel_task(tmp_path, distortion, extra, "GT" if distortion == "inpainting" else "LQGT")
    r = np.random.default_rng(0)
    batch = {"GT": r.random((1, 20, 24, 3), np.float32)}
    if distortion != "inpainting":
        batch["LQ"] = r.random((1, 5, 6, 3) if distortion == "sr" else (1, 20, 24, 3), np.float32)
    want = jrunners.PixelDiffusionTask.prepare_pair(_JaxTaskView(opt, 0), batch)[0]
    np.testing.assert_allclose(task.prepare_lq(batch), want, rtol=0, atol=1e-6)

    seen = []

    def sampler(lq, gen):
        seen.append(lq.numpy())
        return lq * 2

    task.sampler = sampler
    task.deg_rng = np.random.default_rng(77)  # the same masks again
    out, lq = task.infer(batch, None)
    padded, hw = jsampling.pad_to_bucket(np.asarray(want), 64)
    assert hw == (20, 24) and seen[0].shape == (1, 64, 64, 3)
    np.testing.assert_allclose(seen[0], padded, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out, 2 * np.asarray(want), rtol=0, atol=2e-6)
    np.testing.assert_allclose(lq, want, rtol=0, atol=1e-6)


def test_gaussian_denoising_infer_uses_the_lq_or_noises_the_gt(tmp_path):
    """With an LQ the reverse ODE starts from it, as the JAX task's
    ``infer``; a GT-only batch gets GT plus N(0, (sigma/255)^2) noise from
    the generator (std within 5% of 25/255 on 3 x 64 x 64 draws)."""
    data = write_pairs(str(tmp_path / "data"), 1, seed=2, min_size=17, max_size=23)
    yml = _test_yaml(tmp_path / "t.yml", tmp_path, "denoising", "denoising", UNET_DENOISE,
                     "{max_sigma: 70, T: 100, schedule: cosine}", f"{{name: gt, mode: GT, dataroot_GT: {data}/GT}}")
    task = runners.build_task(options.dict_to_nonedict(options.parse(yml, is_train=False)), 0, "cpu")
    gt = np.full((1, 64, 64, 3), 0.5, np.float32)
    lq = task.prepare_lq({"GT": gt, "LQ": gt + 0.1}, None)
    np.testing.assert_array_equal(lq, gt + 0.1)
    noisy = task.prepare_lq({"GT": gt}, rng.generator(1, "cpu"))
    assert abs((noisy - gt).std() / (25 / 255) - 1) < 0.05
    out, used = task.infer({"GT": gt}, rng.generator(1, "cpu"))
    np.testing.assert_array_equal(used, noisy)
    assert out.shape == gt.shape and np.isfinite(out).all()


@pytest.mark.parametrize("tiler", [tiling.tiled_restore, tiling.tiled_restore_device], ids=lambda f: f.__name__)
def test_sample_batch_through_the_tiled_entry_points_matches_a_direct_call(tmp_path, tiler):
    """One tile covering the image: the tiled result equals ``sample_batch``
    on the image with tile 0's generator (seeded from (seed, 0)), to the
    blend's float32 rounding (1e-6); two tiles: each tile's own noise."""
    task, _ = _pixel_task(tmp_path)
    task.net.eval()
    lq = np.random.default_rng(3).random((1, 16, 24, 3), np.float32)
    direct = task.sample_batch(torch.from_numpy(lq), [rng.generator(rng.fold_seed(9, 0), "cpu")]).numpy()
    whole = tiler(task.sample_batch, lq, 9, tile=32, overlap=8, device="cpu")
    np.testing.assert_allclose(whole, direct, rtol=0, atol=1e-6)
    halves = tiler(task.sample_batch, lq, 9, tile=16, overlap=8, tile_batch=1, device="cpu")
    assert halves.shape == lq.shape and np.isfinite(halves).all() and not np.allclose(halves, whole)


def test_test_entry_point_restores_by_tiles_where_the_yaml_says(tmp_path, monkeypatch):
    """``tile``, ``tile_overlap``, ``tile_batch`` and ``tile_device`` route
    each image through ``sample_batch`` into the tiler the YAML names, with
    the image's seed."""
    calls = []

    def fake(name):
        def tiler(sample_fn, lq, seed, tile, overlap, tile_batch, device):
            calls.append((name, lq.shape, seed, tile, overlap, tile_batch))
            return lq
        return tiler

    monkeypatch.setattr(test, "tiled_restore", fake("host"))
    monkeypatch.setattr(test, "tiled_restore_device", fake("device"))
    for device_flag in ("false", "true"):
        task, _ = _pixel_task(tmp_path, extra=f"tile: 16\ntile_overlap: 4\ntile_batch: 2\ntile_device: {device_flag}\n")
        torch.save(task.net.state_dict(), tmp_path / "net.pth")
        test.evaluate(str(tmp_path / "t.yml"), "cpu")
    (h, w) = read_img_uint8(glob.glob(str(tmp_path / "data" / "LQ" / "*.png"))[0]).shape[:2]
    assert calls == [(name, (1, h, w, 3), rng.fold_seed(0, 0), 16, 4, 2) for name in ("host", "device")]


# ------------------------------------------------------------ stereo, YAMLs
def test_stereo_pairs_are_scored_and_saved_per_eye(tmp_path):
    """A stereo SR test set (two pairs, tiny SCAM NAFNet, 3 posterior
    steps): output, LQ and GT PNGs per eye, and each pair's PSNR and SSIM
    the mean of its eyes' (``image_metrics`` on the 6-channel images against
    each eye alone)."""
    data = write_stereo(str(tmp_path / "data"), 2, seed=4, min_size=32, max_size=40)
    net = ("{which_model_G: ConditionalNAFNet, setting: {width: 8, enc_blk_nums: [1, 1], middle_blk_num: 1, "
           "dec_blk_nums: [1, 1]}}")
    dataset = f"{{name: stereo, mode: SteLQGT, dataroot_GT: {data}/HR, dataroot_LQ: {data}/LR_x4}}"
    sde = "{max_sigma: 50, T: 100, schedule: cosine, eps: 0.005, sample_T: 3, sampling_mode: posterior}"
    yml = _test_yaml(tmp_path / "s.yml", tmp_path, "denoising", "sr", net, sde, dataset)
    _seeded_pth(yml, tmp_path / "net.pth")
    result = test.evaluate(yml, "cpu")["stereo"]
    out_dir = glob.glob(str(tmp_path / "results" / "*" / "tiny" / "stereo"))[0]
    assert sorted(os.listdir(out_dir)) == sorted(
        f"{n}{kind}_{eye}.png" for n in ("0000", "0002") for kind in ("", "_LQ", "_GT") for eye in "LR")
    assert len(result["images"]) == 2 and all(np.isfinite(r["psnr"]) for r in result["images"])
    r = np.random.default_rng(6)
    out, gt = (r.integers(0, 256, (24, 28, 6), dtype=np.uint8) for _ in range(2))
    both = test.image_metrics(out, gt, 4, None, None)
    eyes = [test.image_metrics(out[..., s], gt[..., s], 4, None, None) for s in (slice(0, 3), slice(3, 6))]
    for k in ("psnr", "ssim", "psnr_y", "ssim_y"):
        assert both[k] == pytest.approx((eyes[0][k] + eyes[1][k]) / 2, rel=1e-12)


@pytest.mark.parametrize("yml", CONFIGS, ids=lambda p: "/".join(p.split(os.sep)[-3::2]))
def test_every_test_yaml_builds_its_task(yml):
    """Each of the 16 test YAMLs parses and builds its task on the CPU (its
    nets at width 8: the card runs them at full width), with the sampler
    its JAX task has: ``infer`` everywhere, ``sample_batch`` where the JAX
    task restores tiles (not the compressor, not bokeh); and the entry
    point refuses it without a ``.pth`` path."""
    opt = options.dict_to_nonedict(options.parse(yml, is_train=False))
    for key in ("network_G", "network_L"):
        if opt[key]:
            setting = opt[key]["setting"]
            setting.update({k: 8 for k in ("nf", "width", "ch") if k in setting})
    task = runners.build_task(opt, 0, "cpu")
    kind = type(task).__name__
    assert callable(task.infer)
    tiles = getattr(task, "sample_batch", None) is not None
    assert tiles == (kind not in ("CompressorTask", "BokehLatentDiffusionTask")), kind
    opt["path"]["pretrain_model_G"] = opt["path"]["pretrain_model_L"] = None
    with pytest.raises(ValueError, match="pretrain_model_G"):
        test.load_task(opt, torch.device("cpu"), 0)


@pytest.mark.parametrize("main", [test.main, inference.main, restore.main], ids=lambda f: f.__module__)
def test_entry_points_default_to_the_card(main, monkeypatch):
    """No ``--device``: the card, which this machine lacks, so they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [f"-opt={CONFIGS[0]}"] + (["-i", "in.png", "-o", "out.png"] if main is restore.main else [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_inference_and_restore_entry_points_on_the_cpu(tmp_path):
    """``inference`` with ``--sigma`` writes one PNG an image; ``restore``
    writes one image, whole and by tiles."""
    task, _ = _pixel_task(tmp_path, "denoising", dataset_mode="GT")
    torch.save(task.net.state_dict(), tmp_path / "net.pth")
    yml = str(tmp_path / "t.yml")
    times = inference.infer(yml, "cpu", sigma=15)["pairs"]
    assert len(times) == 1
    assert len(glob.glob(str(tmp_path / "results" / "*" / "tiny" / "pairs" / "*.png"))) == 1
    src = glob.glob(str(tmp_path / "data" / "GT" / "*.png"))[0]
    for tile in (0, 16):
        dst = str(tmp_path / f"out{tile}.png")
        assert restore.main([f"-opt={yml}", "-i", src, "-o", dst, "--tile", str(tile), "--tile-overlap", "4",
                             "--device", "cpu"]) == 0
        assert read_img_uint8(dst).shape == read_img_uint8(src).shape


# ------------------------------------------------------------------ TLSC
@pytest.mark.parametrize("hw,window", [((9, 13), (4, 5)), ((8, 8), (3, 3)), ((6, 10), (8, 12)), ((7, 5), (1, 5))],
                         ids=str)
def test_local_avg_pool_matches_jax(hw, window):
    """The windowed mean, replicate-padded back to the map (windows past
    the map cut to it), float32: within 1e-6 (O(1) means of float32 sums)."""
    x = np.random.default_rng(1).standard_normal((2, *hw, 6)).astype(np.float32)
    want = np.asarray(jmodules.local_avg_pool(jnp.asarray(x), *window))
    got = modules.local_avg_pool(torch.from_numpy(x).permute(0, 3, 1, 2), *window).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# width 8, enc (4, 4): levels at 8 and 16 channels; TLSC windows of an 11 px
# train crop: (16, 16) at level 0, (7, 7) at level 1, (2, 2) in the middle.
# On a 16 px input (maps 16, 8, 4) level 0's window covers its map and
# fuses; level 1's does not, and runs block by block with the windowed mean
TLSC = dict(img_channel=3, width=8, enc_blk_nums=(4, 4), middle_blk_num=1, dec_blk_nums=(1, 1))
TLSC_TRAIN = 11


def test_cnafnet_local_windows_and_fusion_predicate():
    """The registry's ``CNAFNetLocal`` takes the JAX ``_sca_kernel`` windows
    per level; ``fuses`` refuses a 4-block level whose window is smaller
    than its map (K3 has only the global mean) and takes it where the
    window covers the map; ``fused_param_names`` keeps both TLSC levels'
    weights in float32 (each may fuse on some map)."""
    net = build_network("CNAFNetLocal", {**TLSC, "train_size": [1, 3, TLSC_TRAIN, TLSC_TRAIN], "fast_imp": False})
    flax_net = FlaxNAFNet(**TLSC, tlsc_train_size=(TLSC_TRAIN, TLSC_TRAIN))
    for level, blocks in enumerate(net.encoders):
        assert blocks[0].sca_kernel == flax_net._sca_kernel(level)
    assert net.middle_blks[0].sca_kernel == flax_net._sca_kernel(2)
    lvl0, lvl1 = net.encoders
    assert pnafnet.fuses(lvl0, (16, 16)) and not pnafnet.fuses(lvl0, (17, 16)) and not pnafnet.fuses(lvl0, (16, 20))
    assert pnafnet.fuses(lvl1, (7, 7)) and not pnafnet.fuses(lvl1, (8, 8))
    assert not pnafnet.fuses(net.middle_blks, (1, 1))  # one block
    names = net.fused_param_names()
    assert {n.split(".")[1] for n in names} == {"0", "1"} and all(n.startswith("encoders.") for n in names)


def test_cnafnet_local_forward_matches_flax(monkeypatch):
    """The tiny TLSC net on 16 px (level 0 fused on both sides, flax's Pallas
    kernel in interpret mode; level 1 and the middle block on the windowed
    mean), the same random weights as flax: float32 within 1e-4 of max|out|;
    exactly one fused launch on each side, at 8 channels."""
    monkeypatch.setenv("IRSDE_NAF_FUSE_INTERPRET", "1")
    fnet = FlaxNAFNet(**TLSC, tlsc_train_size=(TLSC_TRAIN, TLSC_TRAIN))
    r = np.random.default_rng(8)
    xt, cond = (r.random((2, 16, 16, 3), np.float32) for _ in range(2))
    tvec = np.array([5, 61], np.int32)
    init = jax.jit(fnet.init)(jax.random.PRNGKey(0), jnp.asarray(xt), jnp.asarray(cond), jnp.asarray(tvec))
    weights = randomize(flatten(init), seed=9)
    seen = {"jax": [], "port": []}
    j_orig, p_orig = jns.naf_stack, pnafnet.naf_stack

    def j_count(x, *a):
        seen["jax"].append(x.shape[-1])
        return j_orig(x, *a)

    def p_count(x, *a):
        seen["port"].append(x.shape[-1])
        return p_orig(x, *a)

    monkeypatch.setattr(jns, "naf_stack", j_count)
    monkeypatch.setattr(pnafnet, "naf_stack", p_count)
    want = np.asarray(jax.jit(fnet.apply)(unflatten(weights), xt, cond, tvec))
    net = build_network("CNAFNetLocal", {**TLSC, "train_size": [1, 3, TLSC_TRAIN, TLSC_TRAIN]})
    keys = nafnet_flax_keys(TLSC["enc_blk_nums"], TLSC["middle_blk_num"], TLSC["dec_blk_nums"])
    net.load_state_dict(state_dict_from_flax(weights, keys=keys))
    with torch.inference_mode():
        got = net.eval()(torch.from_numpy(xt), torch.from_numpy(cond), torch.from_numpy(tvec)).numpy()
    assert seen == {"jax": [8], "port": [8]}
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
