"""Bokeh-transformation datasets: LQ/GT/alpha triplets + lens metadata.

A copy of ``image_restoration_sde_tpu/data/bokeh_datasets.py``: the crops,
flips and the lens swap come from the same numpy generators, so both
packages yield the same samples.

Parity: ref ``data/BokehLQGT_dataset.py`` / ``BokehLQ_dataset.py`` — a CSV
meta file of ``id, src_lens, tgt_lens, disparity``; lens strings map to
signed floats (``Canon50mmf*`` negative, ``Sony50mmf*`` positive, x10);
train-time optional LQ<->GT swap with lens swap when the aperture is wide
(lens value > 100 after scaling).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from . import transforms
from .datasets import _Base
from .io_utils import read_img


def lenstr2float(lenstr: str, scale: float = 1.0) -> float:
    """Ref: BokehLQGT_dataset.py:75-80."""
    lenstr = lenstr.replace("Canon50mmf", "-").replace("Sony50mmf", "").replace("BS", "")
    return float(lenstr) * scale


def read_meta_file(path: str) -> Dict[str, tuple]:
    """``id -> (src, tgt, disparity)`` strings from the meta file."""
    if not os.path.isfile(path):
        raise ValueError(f"Meta file missing under {path}.")
    meta = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            id_, src, tgt, disp = [p.strip() for p in line.split(",")]
            meta[id_] = (src, tgt, disp)
    return meta


def _lens_values(metas: Dict[str, tuple], alpha_path: str) -> tuple:
    """(src_lens, tgt_lens, disparity) of the sample whose alpha map is
    ``alpha_path``: its file stem is the meta file's id."""
    src, tgt, disp = metas[os.path.basename(alpha_path).split(".")[0]]
    return lenstr2float(src, 10.0), lenstr2float(tgt, 10.0), lenstr2float(disp, 1.0)


class BokehLQGTDataset(_Base):
    def __init__(self, opt):
        super().__init__(opt)
        self.GT_paths = self._paths("dataroot_GT")
        self.LQ_paths = self._paths("dataroot_LQ")
        self.alpha_paths = self._paths("dataroot_alpha")
        self.metas = read_meta_file(opt["dataroot_meta"])
        if not self.GT_paths:
            raise ValueError("GT paths are empty")
        if len(self.LQ_paths) != len(self.GT_paths):
            raise ValueError("GT and LQ datasets have different sizes")

    def __len__(self):
        return len(self.GT_paths)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        opt = self.opt
        rng = self.rng(index)
        GT_size, LQ_size = opt.get("GT_size"), opt.get("LR_size")

        img_GT = read_img(self.GT_paths[index])
        img_LQ = read_img(self.LQ_paths[index])
        img_alpha = read_img(self.alpha_paths[index])
        src_lens, tgt_lens, disparity = _lens_values(self.metas, self.alpha_paths[index])

        if self.phase == "train":
            if LQ_size != GT_size:
                raise ValueError("GT size does not match LR size (bokeh is same-res)")
            H, W = img_LQ.shape[:2]
            rnd_h = int(rng.integers(0, max(0, H - LQ_size) + 1))
            rnd_w = int(rng.integers(0, max(0, W - LQ_size) + 1))
            img_LQ = img_LQ[rnd_h : rnd_h + LQ_size, rnd_w : rnd_w + LQ_size]
            img_GT = img_GT[rnd_h : rnd_h + GT_size, rnd_w : rnd_w + GT_size]
            img_alpha = img_alpha[rnd_h : rnd_h + GT_size, rnd_w : rnd_w + GT_size]
            img_LQ, img_GT, img_alpha = transforms.augment(
                [img_LQ, img_GT, img_alpha],
                bool(opt.get("use_flip")), bool(opt.get("use_rot")), False, rng,
            )
        elif LQ_size is not None:
            H, W = img_LQ.shape[:2]
            if LQ_size < H and LQ_size < W:
                rnd_h = H // 2 - LQ_size // 2
                rnd_w = W // 2 - LQ_size // 2
                img_LQ = img_LQ[rnd_h : rnd_h + LQ_size, rnd_w : rnd_w + LQ_size]
                img_GT = img_GT[rnd_h : rnd_h + GT_size, rnd_w : rnd_w + GT_size]
                img_alpha = img_alpha[rnd_h : rnd_h + GT_size, rnd_w : rnd_w + GT_size]

        sample = {
            "LQ": np.ascontiguousarray(img_LQ, dtype=np.float32),
            "GT": np.ascontiguousarray(img_GT, dtype=np.float32),
            "alpha": np.ascontiguousarray(img_alpha, dtype=np.float32),
            "src_lens": np.float32(src_lens),
            "tgt_lens": np.float32(tgt_lens),
            "disparity": np.float32(disparity),
            "LQ_path": self.LQ_paths[index],
            "GT_path": self.GT_paths[index],
        }
        # wide-aperture swap (ref BokehLQGT_dataset.py:161-175)
        if (
            self.phase == "train"
            and opt.get("use_swap")
            and rng.random() < 0.5
            and (src_lens > 100 or tgt_lens > 100)
        ):
            sample.update(
                LQ=sample["GT"], GT=sample["LQ"],
                src_lens=np.float32(tgt_lens), tgt_lens=np.float32(src_lens),
                LQ_path=self.GT_paths[index], GT_path=self.LQ_paths[index],
            )
        return sample


class BokehLQDataset(_Base):
    """Blind bokeh test set (LQ + alpha + meta, no GT).  Ref: BokehLQ_dataset.py."""

    def __init__(self, opt):
        super().__init__(opt)
        self.LQ_paths = self._paths("dataroot_LQ")
        self.alpha_paths = self._paths("dataroot_alpha")
        self.metas = read_meta_file(opt["dataroot_meta"])

    def __len__(self):
        return len(self.LQ_paths)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        src_lens, tgt_lens, disparity = _lens_values(self.metas, self.alpha_paths[index])
        return {
            "LQ": np.ascontiguousarray(read_img(self.LQ_paths[index]), dtype=np.float32),
            "alpha": np.ascontiguousarray(read_img(self.alpha_paths[index]), dtype=np.float32),
            "src_lens": np.float32(src_lens),
            "tgt_lens": np.float32(tgt_lens),
            "disparity": np.float32(disparity),
            "LQ_path": self.LQ_paths[index],
        }
