"""Dataset classes producing numpy HWC RGB float32 samples.

A copy of the image-folder part of
``image_restoration_sde_tpu/data/datasets.py``: the crops and flips come
from the same numpy generators, so both packages yield the same samples.
The LMDB readers are not in the port (ROADMAP, Queue 1): an LMDB root
raises ``NotImplementedError``.

Parity: the reference's seven Dataset classes (``data/__init__.py:36-68``)
built on the option-dict schema (dataroot_GT/dataroot_LQ, GT_size/LR_size,
use_flip/use_rot/use_swap, color, phase, scale, data_type).  NHWC numpy out
(the framework is NHWC end-to-end; the reference emits CHW torch tensors).

Implemented here: LQGT, GT, LQ (stereo/bokeh variants live in
``stereo_datasets.py`` / ``bokeh_datasets.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from . import io_utils, transforms
from .imresize import imresize


def create_dataset(dataset_opt: Dict[str, Any]):
    """mode string -> Dataset (ref data/__init__.py:36-68)."""
    mode = dataset_opt["mode"]
    if mode == "LQGT":
        return LQGTDataset(dataset_opt)
    if mode == "GT":
        return GTDataset(dataset_opt)
    if mode == "LQ":
        return LQDataset(dataset_opt)
    if mode in ("SteLQGT", "SteLQ"):
        from .stereo_datasets import StereoLQDataset, StereoLQGTDataset

        return StereoLQGTDataset(dataset_opt) if mode == "SteLQGT" else StereoLQDataset(dataset_opt)
    if mode in ("BokehLQGT", "BokehLQ"):
        from .bokeh_datasets import BokehLQDataset, BokehLQGTDataset

        return BokehLQGTDataset(dataset_opt) if mode == "BokehLQGT" else BokehLQDataset(dataset_opt)
    raise NotImplementedError(f"Dataset mode {mode!r} is not recognized")


class _Base:
    def __init__(self, opt: Dict[str, Any]):
        self.opt = dict(opt)
        self.phase = opt.get("phase", "train")
        self.scale = int(opt.get("scale") or 1)
        self.data_type = opt.get("data_type", "img")

    def _paths(self, key: str):
        if self.data_type == "mc":
            raise NotImplementedError(
                "memcached ('_mc' modes) is not supported in this build; "
                "use image folders or lmdb"
            )
        return io_utils.get_image_paths(self.data_type, self.opt.get(key))

    def _read(self, root_key: str, paths, sizes, index: int) -> np.ndarray:
        # uint8 until after the crop/augment: converting full-size HR
        # sources to f32 before cropping dominated the loader (io_utils)
        return io_utils.read_img_uint8(paths[index])

    def rng(self, index: int) -> np.random.Generator:
        # per-sample deterministic stream: seed + epoch-folded index is set
        # by the loader via `set_epoch_seed`; default is unseeded entropy
        base = getattr(self, "_epoch_seed", None)
        if base is None:
            return np.random.default_rng()
        return np.random.default_rng((base, index))

    def set_epoch_seed(self, seed: Optional[int]):
        self._epoch_seed = seed


class LQGTDataset(_Base):
    """Paired LQ/GT reader (pairing by sorted filename), on-the-fly matlab
    downscale when LQ is absent.  Ref: data/LQGT_dataset.py:18-194."""

    def __init__(self, opt):
        super().__init__(opt)
        self.GT_paths, self.GT_sizes = self._paths("dataroot_GT"), None
        self.LQ_paths, self.LQ_sizes = self._paths("dataroot_LQ"), None
        if not self.GT_paths:
            raise ValueError("GT paths are empty")
        if self.LQ_paths and len(self.LQ_paths) != len(self.GT_paths):
            raise ValueError(
                f"GT and LQ datasets have different sizes: {len(self.GT_paths)} vs {len(self.LQ_paths)}"
            )

    def __len__(self):
        return len(self.GT_paths)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        opt = self.opt
        rng = self.rng(index)
        GT_size, LQ_size = opt.get("GT_size"), opt.get("LR_size")

        img_GT = self._read("dataroot_GT", self.GT_paths, self.GT_sizes, index)
        if self.phase != "train":
            img_GT = transforms.modcrop(img_GT, self.scale)

        if self.LQ_paths:
            img_LQ = self._read("dataroot_LQ", self.LQ_paths, self.LQ_sizes, index)
            LQ_path = self.LQ_paths[index]
        else:
            # on-the-fly matlab downscale needs float math (full-size by
            # construction — the resize consumes every source pixel)
            img_GT = io_utils.to_float01(img_GT)
            img_LQ = imresize(img_GT, 1.0 / self.scale, antialias=True)
            if img_LQ.ndim == 2:
                img_LQ = img_LQ[:, :, None]
            LQ_path = self.GT_paths[index]

        if self.phase == "train":
            if LQ_size != GT_size // self.scale:
                raise ValueError("GT size does not match LR size")
            img_LQ, img_GT = transforms.paired_random_crop(
                img_LQ, img_GT, LQ_size, self.scale, rng
            )
            img_LQ, img_GT = transforms.augment(
                [img_LQ, img_GT],
                bool(opt.get("use_flip")),
                bool(opt.get("use_rot")),
                bool(opt.get("use_swap")),
                rng,
            )
        elif LQ_size is not None:
            img_LQ, img_GT = transforms.paired_center_crop(
                img_LQ, img_GT, LQ_size, self.scale
            )

        if opt.get("color"):
            img_LQ, img_GT = io_utils.to_float01(img_LQ), io_utils.to_float01(img_GT)
            img_LQ = transforms.channel_convert(img_LQ.shape[2], opt["color"], [img_LQ])[0]
            img_GT = transforms.channel_convert(img_GT.shape[2], opt["color"], [img_GT])[0]

        return {
            "LQ": io_utils.to_float01(img_LQ),
            "GT": io_utils.to_float01(img_GT),
            "LQ_path": LQ_path,
            "GT_path": self.GT_paths[index],
        }


class GTDataset(_Base):
    """GT-only (degradation synthesized in the driver).  Ref: data/GT_dataset.py."""

    def __init__(self, opt):
        super().__init__(opt)
        self.GT_paths, self.GT_sizes = self._paths("dataroot_GT"), None

    def __len__(self):
        return len(self.GT_paths)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        opt = self.opt
        rng = self.rng(index)
        img_GT = self._read("dataroot_GT", self.GT_paths, self.GT_sizes, index)
        if self.phase == "train":
            img_GT = transforms.random_crop(img_GT, opt["GT_size"], rng)
            img_GT = transforms.augment(
                [img_GT], bool(opt.get("use_flip")), bool(opt.get("use_rot")), False, rng
            )[0]
        if opt.get("color"):
            img_GT = transforms.channel_convert(
                img_GT.shape[2], opt["color"], [io_utils.to_float01(img_GT)])[0]
        return {
            "GT": io_utils.to_float01(img_GT),
            "GT_path": self.GT_paths[index],
        }


class LQDataset(_Base):
    """LQ-only (blind test sets).  Ref: data/LQ_dataset.py."""

    def __init__(self, opt):
        super().__init__(opt)
        self.LQ_paths, self.LQ_sizes = self._paths("dataroot_LQ"), None

    def __len__(self):
        return len(self.LQ_paths)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        img_LQ = self._read("dataroot_LQ", self.LQ_paths, self.LQ_sizes, index)
        if self.opt.get("color"):
            img_LQ = transforms.channel_convert(
                img_LQ.shape[2], self.opt["color"], [io_utils.to_float01(img_LQ)])[0]
        return {
            "LQ": io_utils.to_float01(img_LQ),
            "LQ_path": self.LQ_paths[index],
        }
