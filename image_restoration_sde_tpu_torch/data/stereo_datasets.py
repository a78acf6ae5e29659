"""Stereo datasets: L/R pairs concatenated to 6-channel samples.

A copy of the image-folder part of
``image_restoration_sde_tpu/data/stereo_datasets.py``; LMDB roots raise in
``io_utils.get_image_paths``, as in the other datasets of the port.

Parity: ref ``data/StereoLQGT_dataset.py`` / ``StereoLQ_dataset.py`` —
images at indices 2i / 2i+1 form a pair, joint crop + augment, channel
concat, ``len = N // 2``.  (The reference's ``read_img(..., scale=4)`` call
is a latent TypeError upstream — SURVEY §2.4; not replicated.)
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from . import io_utils, transforms
from .datasets import _Base


class StereoLQGTDataset(_Base):
    def __init__(self, opt):
        super().__init__(opt)
        self.GT_paths, self.GT_sizes = self._paths("dataroot_GT"), None
        self.LQ_paths, self.LQ_sizes = self._paths("dataroot_LQ"), None
        if not self.GT_paths:
            raise ValueError("GT paths are empty")

    def __len__(self):
        return len(self.GT_paths) // 2

    def __getitem__(self, index: int) -> Dict[str, Any]:
        opt = self.opt
        rng = self.rng(index)
        GT_size, LQ_size = opt.get("GT_size"), opt.get("LR_size")

        gl = self._read("dataroot_GT", self.GT_paths, self.GT_sizes, index * 2)
        gr = self._read("dataroot_GT", self.GT_paths, self.GT_sizes, index * 2 + 1)
        if self.phase != "train":
            gl = transforms.modcrop(gl, self.scale)
            gr = transforms.modcrop(gr, self.scale)
        ll = self._read("dataroot_LQ", self.LQ_paths, self.LQ_sizes, index * 2)
        lr = self._read("dataroot_LQ", self.LQ_paths, self.LQ_sizes, index * 2 + 1)

        if self.phase == "train":
            if LQ_size != GT_size // self.scale:
                raise ValueError("GT size does not match LR size")
            H, W = ll.shape[:2]
            rnd_h = int(rng.integers(0, max(0, H - LQ_size) + 1))
            rnd_w = int(rng.integers(0, max(0, W - LQ_size) + 1))
            ll = ll[rnd_h : rnd_h + LQ_size, rnd_w : rnd_w + LQ_size]
            lr = lr[rnd_h : rnd_h + LQ_size, rnd_w : rnd_w + LQ_size]
            gh, gw = rnd_h * self.scale, rnd_w * self.scale
            gl = gl[gh : gh + GT_size, gw : gw + GT_size]
            gr = gr[gh : gh + GT_size, gw : gw + GT_size]
            ll, lr, gl, gr = transforms.augment(
                [ll, lr, gl, gr], bool(opt.get("use_flip")), bool(opt.get("use_rot")), False, rng
            )
        elif LQ_size is not None:
            ll, gl = transforms.paired_center_crop(ll, gl, LQ_size, self.scale)
            lr, gr = transforms.paired_center_crop(lr, gr, LQ_size, self.scale)

        img_GT = np.concatenate([gl, gr], axis=2)
        img_LQ = np.concatenate([ll, lr], axis=2)
        return {
            "LQ": io_utils.to_float01(img_LQ),
            "GT": io_utils.to_float01(img_GT),
            "LQ_path": self.LQ_paths[index * 2],
            "GT_path": self.GT_paths[index * 2],
        }


class StereoLQDataset(_Base):
    """LQ-only stereo pairs (blind test).  Ref: data/StereoLQ_dataset.py."""

    def __init__(self, opt):
        super().__init__(opt)
        self.LQ_paths, self.LQ_sizes = self._paths("dataroot_LQ"), None

    def __len__(self):
        return len(self.LQ_paths) // 2

    def __getitem__(self, index: int) -> Dict[str, Any]:
        ll = self._read("dataroot_LQ", self.LQ_paths, self.LQ_sizes, index * 2)
        lr = self._read("dataroot_LQ", self.LQ_paths, self.LQ_sizes, index * 2 + 1)
        img_LQ = np.concatenate([ll, lr], axis=2)
        return {
            "LQ": io_utils.to_float01(img_LQ),
            "LQ_path": self.LQ_paths[index * 2],
        }
