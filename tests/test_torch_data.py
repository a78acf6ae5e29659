"""PyTorch port, the data pipeline and the framework-free utilities it
copies from the JAX package: the datasets' crops and flips, the train
loader's batches (and its start at a resumed step), the resamplers, the
YAML options, the metrics, ``tensor2img`` and the degradations, each
against the JAX package's own on the same seed."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_sde_tpu.data import datasets as jdatasets
from image_restoration_sde_tpu.data import imresize as jimresize
from image_restoration_sde_tpu.data import loader as jloader
from image_restoration_sde_tpu.utils import degradations as jdeg
from image_restoration_sde_tpu.utils import img_utils as jimg
from image_restoration_sde_tpu.utils import metrics as jmetrics
from image_restoration_sde_tpu.utils import options as joptions
from image_restoration_sde_tpu_torch.data import datasets, imresize, loader
from image_restoration_sde_tpu_torch.data.io_utils import save_img
from image_restoration_sde_tpu_torch.data.synthetic import write_pairs
from image_restoration_sde_tpu_torch.utils import degradations, img_utils, metrics, options

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("pairs")
    write_pairs(str(root), 6, seed=3, min_size=24, max_size=40)
    return str(root)


def _opt(folders, mode="LQGT", phase="train", **kw):
    opt = {"mode": mode, "phase": phase, "dataroot_GT": os.path.join(folders, "GT"), "scale": 1,
           "data_type": "img", "GT_size": 16, "LR_size": 16, "use_flip": True, "use_rot": True, "color": "RGB"}
    if mode == "LQGT":
        opt["dataroot_LQ"] = os.path.join(folders, "LQ")
    return {**opt, **kw}


@pytest.mark.parametrize("mode,phase", [("LQGT", "train"), ("GT", "train"), ("LQGT", "val"), ("LQ", "val")])
def test_dataset_samples_equal_jax(folders, mode, phase):
    """The same (seed, epoch) and index give the same crop and flips, bit
    for bit: both draw from ``np.random.default_rng(((seed, epoch), index))``."""
    opt = _opt(folders, mode, phase)
    if mode == "LQ":
        opt["dataroot_LQ"] = os.path.join(folders, "LQ")
    want, got = jdatasets.create_dataset(opt), datasets.create_dataset(opt)
    assert len(want) == len(got) == 6
    for ds in (want, got):
        ds.set_epoch_seed((7, 2) if phase == "train" else None)
    for i in range(len(got)):
        a, b = want[i], got[i]
        assert set(a) == set(b)
        for k, v in a.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == b[k].dtype == np.float32 and np.array_equal(v, b[k]), (i, k)
            else:
                assert v == b[k]


def test_train_loader_batches_equal_jax_and_resume_where_they_stopped(folders):
    """The first batches of the port's train loader equal the JAX package's
    (seeded shuffle over the enlarged epoch, per-sample augmentation seeds);
    a loader started at step 5 yields the uninterrupted loader's sixth
    batch onwards, across an epoch boundary."""
    opt = _opt(folders)
    jds, pds = jdatasets.create_dataset(opt), datasets.create_dataset(opt)
    jl = jloader.TrainLoader(jds, batch_size=2, seed=11, ratio=1, num_workers=2)
    pl = loader.TrainLoader(pds, batch_size=2, seed=11, ratio=1, num_workers=2)
    assert pl.steps_per_epoch() == jl.steps_per_epoch() == 3

    def take(ld, n):
        it = iter(ld)
        out = [next(it) for _ in range(n)]
        it.close()
        return out

    want, got = take(jl, 8), take(pl, 8)
    for a, b in zip(want, got):
        assert np.array_equal(a["GT"], b["GT"]) and np.array_equal(a["LQ"], b["LQ"])
        assert a["GT_path"] == b["GT_path"]
    late = take(loader.TrainLoader(datasets.create_dataset(opt), batch_size=2, seed=11, ratio=1, num_workers=2,
                                   start_step=5), 3)
    for a, b in zip(got[5:], late):
        assert np.array_equal(a["GT"], b["GT"]) and a["GT_path"] == b["GT_path"]
    assert loader.process_index_and_count() == (0, 1)


def test_eval_loader_and_factory(folders):
    opt = _opt(folders, phase="val")
    ev = loader.create_dataloader(datasets.create_dataset(opt), opt)
    batches = list(ev)
    assert len(batches) == 6 and batches[0]["GT"].shape[0] == 1
    stereo = datasets.create_dataset({**opt, "mode": "SteLQGT"})  # images 2i and 2i+1 pair up
    assert type(stereo).__name__ == "StereoLQGTDataset" and len(stereo) == 3 and stereo[0]["GT"].shape[2] == 6
    with pytest.raises(NotImplementedError, match="not recognized"):
        datasets.create_dataset({**opt, "mode": "LQGT_unknown"})
    with pytest.raises(FileNotFoundError, match="meta_info.pkl"):  # an LMDB root is read through its meta file
        datasets.create_dataset({**opt, "data_type": "lmdb"})


@pytest.mark.parametrize("scale", [0.25, 0.5, 3.0, (13, 29)], ids=str)
def test_resamplers_match_jax(scale):
    """matlab imresize and torch-bicubic on (21, 34, 3): the port has the
    JAX package's numpy weights (the JAX package may take its native C++
    path, float32 sums).  Bound 1e-5 absolute on values in [0, 1]."""
    img = np.random.default_rng(4).random((21, 34, 3)).astype(np.float32)
    for jfn, pfn in ((jimresize.imresize, imresize.imresize),
                     (jimresize.torch_bicubic_resize, imresize.torch_bicubic_resize)):
        want, got = jfn(img, scale), pfn(img, scale)
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.abs(got - want).max() <= 1e-5


def test_options_parse_like_jax(tmp_path):
    """Every train YAML of configs/ parses to the JAX package's dict;
    ``check_resume`` points at the port's ``{iter}_G.pth``."""
    paths = [os.path.join(REPO, "configs", d, "train", f) for d in sorted(os.listdir(os.path.join(REPO, "configs")))
             if os.path.isdir(os.path.join(REPO, "configs", d, "train"))
             for f in sorted(os.listdir(os.path.join(REPO, "configs", d, "train")))]
    assert len(paths) >= 14
    for p in paths:
        assert options.parse(p, root=str(tmp_path)) == joptions.parse(p, root=str(tmp_path)), p
    opt = options.parse(paths[0], root=str(tmp_path))
    opt["path"]["resume_state"] = "x/12.state"
    options.check_resume(opt, 12)
    assert opt["path"]["pretrain_model_G"] == os.path.join(opt["path"]["models"], "12_G.pth")
    nd = options.dict_to_nonedict({"a": {"b": 1}})
    assert nd["a"]["missing"] is None and options.network_setting(
        {"network_G": {"which_model_G": "X", "setting": {"k": 1}}}) == ("X", {"k": 1})


def test_metrics_and_tensor2img_match_jax():
    r = np.random.default_rng(5)
    a = r.random((2, 20, 24, 3)).astype(np.float32) * 1.2 - 0.1
    b = np.clip(a + 0.05 * r.standard_normal(a.shape).astype(np.float32), 0, 1)
    ia, ib = img_utils.tensor2img(torch.from_numpy(a[0])), img_utils.tensor2img(b[0])
    assert np.array_equal(ia, jimg.tensor2img(a[0])) and np.array_equal(img_utils.tensor2img(a), jimg.tensor2img(a))
    assert metrics.calculate_psnr(ia, ib) == jmetrics.calculate_psnr(ia, ib)
    assert metrics.calculate_ssim(ia, ib) == jmetrics.calculate_ssim(ia, ib)
    assert [e for e, _ in img_utils.split_eyes(np.zeros((4, 4, 6)))] == ["_L", "_R"]


def test_degradations_match_jax(tmp_path):
    """``mask_to`` and ``upscale`` equal the JAX package's for the same
    numpy generator; ``add_noise`` adds sigma/255-scaled draws of its
    torch generator (the JAX package draws from threefry)."""
    for i in range(3):
        m = np.zeros((12, 12, 3), np.uint8)
        m[: 4 * (i + 1)] = 255
        save_img(m, str(tmp_path / f"{i:06d}.png"))
    x = np.random.default_rng(6).random((4, 9, 11, 3)).astype(np.float32)
    want = jdeg.mask_to(x, str(tmp_path), rng=np.random.default_rng(1))
    got = degradations.mask_to(x, str(tmp_path), rng=np.random.default_rng(1))
    assert np.array_equal(got, want)
    assert np.array_equal(degradations.mask_to(x, str(tmp_path), mask_id=4), jdeg.mask_to(x, str(tmp_path), mask_id=4))
    assert np.abs(degradations.upscale(x[:, :5, :6], 4) - jdeg.upscale(x[:, :5, :6], 4)).max() <= 1e-5
    xt = torch.from_numpy(x)
    noisy = degradations.add_noise(xt, torch.Generator().manual_seed(3), 25)
    draws = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
    assert torch.equal(noisy, xt + draws * (25 / 255.0))
    jnoisy = np.asarray(jdeg.add_noise(jnp.asarray(x), __import__("jax").random.PRNGKey(0), 25))
    assert abs(float(np.std(jnoisy - x)) - float((noisy - xt).std())) <= 0.02
