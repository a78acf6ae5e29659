"""PyTorch port, LMDB datasets: the port's own pure-Python MDB writer and
reader (``data/mdb.py``) against the JAX package's, byte for byte both ways;
``create_lmdb`` against ``tools/create_lmdb.py``; the LQGT, GT, LQ and
stereo datasets from LMDB roots against the same class from image folders
and against the JAX package's datasets on the same LMDB; and a YAML whose
dataroots end in ``lmdb`` reaching ``data_type: lmdb``."""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from image_restoration_sde_tpu.data import datasets as jdatasets
from image_restoration_sde_tpu.data import mdb as jmdb
from image_restoration_sde_tpu_torch import create_lmdb
from image_restoration_sde_tpu_torch.data import datasets, mdb, stereo_datasets
from image_restoration_sde_tpu_torch.data.synthetic import write_pairs, write_stereo
from image_restoration_sde_tpu_torch.utils import options

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import create_lmdb as tools_create_lmdb  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _items(kind):
    """Items that give: one inline leaf; inline values, overflow chains
    (F_BIGDATA) of one and several pages and a branch level; three levels
    (small pages, many keys)."""
    rs = np.random.RandomState(0)
    if kind == "single":
        return [(b"a", b"hello")], 4096
    if kind == "overflow":
        return [(f"k{i:04d}".encode(), rs.bytes(int(rs.choice([10, 100, 1500, 5000, 9000]))))
                for i in range(300)], 4096
    return [(f"key{i:05d}".encode(), rs.bytes(100)) for i in range(2000)], 512


def _read_all(env, items):
    with env.begin(write=False) as txn:
        got = [txn.get(k) for k, _ in items]
        missing = txn.get(b"missing")
    return got, missing


@pytest.mark.parametrize("kind", ["single", "overflow", "depth3"])
def test_writer_bytes_equal_jax(tmp_path, kind):
    """The port's writer makes the JAX writer's ``data.mdb`` byte for byte,
    and each package's reader reads the other's file."""
    items, psize = _items(kind)
    mdb.write_items(str(tmp_path / "port"), items, psize=psize)
    jmdb.write_items(str(tmp_path / "jax"), items, psize=psize)
    raw = (tmp_path / "port" / "data.mdb").read_bytes()
    assert raw == (tmp_path / "jax" / "data.mdb").read_bytes()
    want = [v for _, v in items]
    for Env, other in ((mdb.MdbEnv, "jax"), (jmdb.MdbEnv, "port")):
        env = Env(str(tmp_path / other))
        assert _read_all(env, items) == (want, None)
        stat = env.stat()
        env.close()
        assert stat["entries"] == len(items)
        assert stat["psize"] == psize
        if kind == "overflow":
            assert stat["depth"] >= 2 and stat["overflow_pages"] > 0, stat
        if kind == "depth3":
            assert stat["depth"] >= 3, stat


def test_writer_refuses_what_liblmdb_refuses(tmp_path):
    w = mdb.MdbWriter(str(tmp_path / "x"))
    with pytest.raises(ValueError, match="key size"):
        w.put(b"k" * 512, b"v")
    mdb.write_items(str(tmp_path / "y"), [(b"a", b"b")])
    env = mdb.MdbEnv(str(tmp_path / "y"))
    with pytest.raises(NotImplementedError, match="read-only"):
        env.begin(write=True)
    env.close()


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Image folders (pairs of 24-40 px, stereo pairs at x4) and their LMDB
    roots, built by the port's create_lmdb."""
    root = tmp_path_factory.mktemp("lmdb")
    write_pairs(str(root / "pairs"), 5, seed=3, min_size=24, max_size=40)
    write_stereo(str(root / "stereo"), 3, seed=4, min_size=32, max_size=48, scale=4)
    for sub in ("pairs/GT", "pairs/LQ", "stereo/HR", "stereo/LR_x4"):
        assert create_lmdb.build_lmdb(str(root / sub), str(root / f"{sub}.lmdb")) in (5, 6)
    return root


def test_create_lmdb_equal_tools(roots, tmp_path, capsys):
    """The port's create_lmdb writes the JAX tool's meta_info.pkl and
    data.mdb, byte for byte; its CLI reports the count."""
    src = str(roots / "pairs" / "GT")
    assert tools_create_lmdb.build_lmdb(src, str(tmp_path / "jax.lmdb"), name="GT") == 5
    assert create_lmdb.main(["--input", src, "--output", str(tmp_path / "port.lmdb"), "--name", "GT"]) == 0
    assert "wrote 5 images" in capsys.readouterr().out
    for name in ("data.mdb", "meta_info.pkl"):
        assert (tmp_path / "port.lmdb" / name).read_bytes() == (tmp_path / "jax.lmdb" / name).read_bytes(), name
    with open(tmp_path / "port.lmdb" / "meta_info.pkl", "rb") as f:
        meta = pickle.load(f)
    assert meta["name"] == "GT" and meta["keys"] == [f"{i:04d}" for i in range(5)]
    assert all(r.startswith("3_") for r in meta["resolution"])


def _pair_opt(roots, mode, phase, lmdb):
    ext = ".lmdb" if lmdb else ""
    opt = {"mode": mode, "phase": phase, "scale": 1, "data_type": "lmdb" if lmdb else "img",
           "GT_size": 16, "LR_size": 16, "use_flip": True, "use_rot": True, "color": "RGB"}
    if mode in ("LQGT", "GT"):
        opt["dataroot_GT"] = str(roots / "pairs" / f"GT{ext}")
    if mode in ("LQGT", "LQ"):
        opt["dataroot_LQ"] = str(roots / "pairs" / f"LQ{ext}")
    return opt


def _stereo_opt(roots, mode, phase, lmdb):
    ext = ".lmdb" if lmdb else ""
    opt = {"mode": mode, "phase": phase, "scale": 4, "data_type": "lmdb" if lmdb else "img",
           "GT_size": 16, "LR_size": 4, "use_flip": True, "use_rot": True, "use_swap": True,
           "dataroot_LQ": str(roots / "stereo" / f"LR_x4{ext}")}
    if mode == "SteLQGT":
        opt["dataroot_GT"] = str(roots / "stereo" / f"HR{ext}")
    return opt


def _samples(ds, seed):
    ds.set_epoch_seed(seed)
    return [ds[i] for i in range(len(ds))]


def _assert_same(a, b, paths=True):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert set(x) == set(y)
        for k, v in x.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == y[k].dtype == np.float32 and np.array_equal(v, y[k]), (i, k)
            elif paths:
                assert v == y[k], (i, k)


@pytest.mark.parametrize("mode,phase", [("LQGT", "train"), ("GT", "train"), ("LQGT", "val"), ("LQ", "val"),
                                        ("SteLQGT", "train"), ("SteLQ", "val")])
def test_lmdb_datasets_equal_folders_and_jax(roots, mode, phase):
    """From LMDB roots, the port's dataset yields the folder dataset's
    samples and the JAX package's LMDB samples, bit for bit, at the same
    (seed, epoch); paths are the LMDB keys, as in the JAX package."""
    make = _stereo_opt if mode.startswith("Ste") else _pair_opt
    seed = (7, 2) if phase == "train" else None
    lmdb_opt, img_opt = make(roots, mode, phase, True), make(roots, mode, phase, False)
    got = datasets.create_dataset(lmdb_opt)
    assert type(got).__module__ == (stereo_datasets if mode.startswith("Ste") else datasets).__name__
    assert len(got) == (3 if mode.startswith("Ste") else 5)
    port = _samples(got, seed)
    _assert_same(_samples(datasets.create_dataset(img_opt), seed), port, paths=False)
    _assert_same(_samples(jdatasets.create_dataset(lmdb_opt), seed), port)
    assert len(got._envs) == (2 if mode in ("LQGT", "SteLQGT") else 1)  # one environment a root


def test_lmdb_yaml_reaches_the_datasets(roots, tmp_path):
    """A YAML whose dataroots end in ``lmdb`` parses to ``data_type: lmdb``
    (as the JAX package's), and its datasets read the LMDB roots."""
    import yaml

    yml = {"name": "lmdb", "model": "denoising", "distortion": "derain", "gpu_ids": [0],
           "datasets": {"train": {"name": "t", "mode": "LQGT", "dataroot_GT": str(roots / "pairs" / "GT.lmdb"),
                                  "dataroot_LQ": str(roots / "pairs" / "LQ.lmdb"), "GT_size": 16, "LR_size": 16,
                                  "use_flip": True, "use_rot": True, "color": "RGB"},
                        "val": {"name": "v", "mode": "LQGT", "dataroot_GT": str(roots / "pairs" / "GT.lmdb"),
                                "dataroot_LQ": str(roots / "pairs" / "LQ")}},
           "path": {"root": str(tmp_path)}}
    path = tmp_path / "lmdb.yml"
    path.write_text(yaml.safe_dump(yml))
    from image_restoration_sde_tpu.utils import options as joptions

    opt = options.parse(str(path), root=str(tmp_path))
    assert opt == joptions.parse(str(path), root=str(tmp_path))
    train, val = opt["datasets"]["train"], opt["datasets"]["val"]
    assert train["data_type"] == val["data_type"] == "lmdb"
    ds = datasets.create_dataset(train)
    sample = _samples(ds, (1, 0))[0]
    assert sample["GT"].shape == sample["LQ"].shape == (16, 16, 3) and sample["GT_path"] == "0000"
