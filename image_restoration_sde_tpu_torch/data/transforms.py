"""Numpy image transforms with reference-parity semantics.

A copy of ``image_restoration_sde_tpu/data/transforms.py``.

Parity: ref ``data/util.py:84-103`` (augment: independent hflip/vflip/rot90
coin flips + optional LQ<->GT swap), ``data/util.py:221-234`` (modcrop),
``data/LQGT_dataset.py:132-165`` (paired random / center crops),
``data/util.py:139-218`` (matlab-exact color conversions).

Randomness is explicit (numpy Generator) so the pipeline is reproducible
and shardable per host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def augment(
    imgs: List[np.ndarray],
    use_flip: bool = True,
    use_rot: bool = True,
    use_swap: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> List[np.ndarray]:
    """hflip / vflip / rot90 coin flips applied jointly to all images; with
    ``use_swap`` the list order is reversed with p=0.5 (LQ<->GT swap)."""
    rng = rng or np.random.default_rng()
    hflip = use_flip and rng.random() < 0.5
    vflip = use_rot and rng.random() < 0.5
    rot90 = use_rot and rng.random() < 0.5
    if use_swap and rng.random() < 0.5:
        imgs = imgs[::-1]

    def _aug(img):
        if hflip:
            img = img[:, ::-1, :]
        if vflip:
            img = img[::-1, :, :]
        if rot90:
            img = img.transpose(1, 0, 2)
        return np.ascontiguousarray(img)

    return [_aug(im) for im in imgs]


def modcrop(img: np.ndarray, scale: int) -> np.ndarray:
    if scale <= 1:
        return img
    H, W = img.shape[:2]
    return img[: H - H % scale, : W - W % scale]


def paired_random_crop(
    img_lq: np.ndarray,
    img_gt: np.ndarray,
    lq_size: int,
    scale: int,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    rng = rng or np.random.default_rng()
    H, W = img_lq.shape[:2]
    rnd_h = int(rng.integers(0, max(0, H - lq_size) + 1))
    rnd_w = int(rng.integers(0, max(0, W - lq_size) + 1))
    lq = img_lq[rnd_h : rnd_h + lq_size, rnd_w : rnd_w + lq_size]
    gt = img_gt[
        rnd_h * scale : (rnd_h + lq_size) * scale,
        rnd_w * scale : (rnd_w + lq_size) * scale,
    ]
    return lq, gt


def paired_center_crop(
    img_lq: np.ndarray, img_gt: np.ndarray, lq_size: int, scale: int
) -> Tuple[np.ndarray, np.ndarray]:
    H, W = img_lq.shape[:2]
    if lq_size >= H or lq_size >= W:
        return img_lq, img_gt
    rnd_h = H // 2 - lq_size // 2
    rnd_w = W // 2 - lq_size // 2
    lq = img_lq[rnd_h : rnd_h + lq_size, rnd_w : rnd_w + lq_size]
    gt = img_gt[
        rnd_h * scale : (rnd_h + lq_size) * scale,
        rnd_w * scale : (rnd_w + lq_size) * scale,
    ]
    return lq, gt


def random_crop(
    img: np.ndarray, size: int, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    rng = rng or np.random.default_rng()
    H, W = img.shape[:2]
    rnd_h = int(rng.integers(0, max(0, H - size) + 1))
    rnd_w = int(rng.integers(0, max(0, W - size) + 1))
    return img[rnd_h : rnd_h + size, rnd_w : rnd_w + size]


# ------------------------------------------------------------ color spaces
def rgb2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """matlab-exact rgb2ycbcr (ref data/util.py:139-166, bgr variant).

    Input float [0,1] or uint8; output same range, Y (or YCbCr) channels.
    """
    in_img_type = img.dtype
    img = img.astype(np.float64)
    if in_img_type != np.uint8:
        img *= 255.0
    if only_y:
        rlt = np.dot(img, [65.481, 128.553, 24.966]) / 255.0 + 16.0
    else:
        rlt = (
            np.matmul(
                img,
                [
                    [65.481, -37.797, 112.0],
                    [128.553, -74.203, -93.786],
                    [24.966, 112.0, -18.214],
                ],
            )
            / 255.0
            + [16, 128, 128]
        )
    if in_img_type == np.uint8:
        rlt = rlt.round()
    else:
        rlt /= 255.0
    return rlt.astype(in_img_type)


def bgr2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """matlab-exact bgr2ycbcr (ref data/util.py:172-199)."""
    return rgb2ycbcr(img[..., ::-1], only_y=only_y)


def channel_convert(in_c: int, tar_type: Optional[str], img_list: Sequence[np.ndarray]):
    """Ref data/util.py:129-137 (gray/y/RGB conversions; RGB inputs here)."""
    if in_c == 3 and tar_type == "gray":
        return [np.dot(im, [0.299, 0.587, 0.114])[:, :, None].astype(im.dtype) for im in img_list]
    if in_c == 3 and tar_type == "y":
        return [rgb2ycbcr(im, only_y=True)[:, :, None] for im in img_list]
    if in_c == 1 and tar_type == "RGB":
        return [np.repeat(im, 3, axis=2) for im in img_list]
    return list(img_list)


def augment_flow(
    img_list: List[np.ndarray],
    flow_list: List[np.ndarray],
    use_flip: bool = True,
    use_rot: bool = True,
    rng: Optional[np.random.Generator] = None,
):
    """Joint image+optical-flow augmentation (ref data/util.py:106-137):
    flips negate the matching flow component, rot90 swaps flow channels."""
    rng = rng or np.random.default_rng()
    hflip = use_flip and rng.random() < 0.5
    vflip = use_rot and rng.random() < 0.5
    rot90 = use_rot and rng.random() < 0.5

    def _img(img):
        if hflip:
            img = img[:, ::-1, :]
        if vflip:
            img = img[::-1, :, :]
        if rot90:
            img = img.transpose(1, 0, 2)
        return np.ascontiguousarray(img)

    def _flow(flow):
        flow = flow.copy()
        if hflip:
            flow = flow[:, ::-1, :]
            flow[:, :, 0] *= -1
        if vflip:
            flow = flow[::-1, :, :]
            flow[:, :, 1] *= -1
        if rot90:
            flow = flow.transpose(1, 0, 2)
            flow = flow[:, :, [1, 0]]
        return np.ascontiguousarray(flow)

    return [_img(i) for i in img_list], [_flow(f) for f in flow_list]
