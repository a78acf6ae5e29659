"""Image file IO for the data pipeline.

A copy of ``image_restoration_sde_tpu/data/io_utils.py`` without its LMDB
readers (ROADMAP, Queue 1: LMDB in the port).

Parity: ref ``data/util.py:12-78`` — recursive sorted folder walk, cv2
decode to float32 HWC in [0,1].  We standardize on RGB channel order
end-to-end (the reference keeps BGR internally and swaps at tensor-ization,
LQGT_dataset.py:177-180); a PIL fallback covers environments without cv2.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

IMG_EXTENSIONS = (
    ".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG",
    ".ppm", ".PPM", ".bmp", ".BMP", ".tif", ".TIF",
)

try:
    import cv2

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False


def is_image_file(filename: str) -> bool:
    return filename.endswith(IMG_EXTENSIONS)


def get_paths_from_images(path: str) -> List[str]:
    if not os.path.isdir(path):
        raise NotADirectoryError(f"{path} is not a valid directory")
    images = []
    for dirpath, _, fnames in sorted(os.walk(path)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                images.append(os.path.join(dirpath, fname))
    if not images:
        raise FileNotFoundError(f"{path} has no valid image file")
    return images


def get_image_paths(data_type: str, dataroot: Optional[str]):
    if dataroot is None:
        return None
    if data_type == "lmdb":
        raise NotImplementedError("LMDB datasets are not in the port yet (ROADMAP, Queue 1); use image folders")
    if data_type == "img":
        return sorted(get_paths_from_images(dataroot))
    raise NotImplementedError(f"data_type {data_type!r} is not recognized")


def read_img_uint8(path: str) -> np.ndarray:
    """Read an image file -> uint8 HWC **RGB** (no float pass).

    The train datasets crop BEFORE converting to float: a full-size f32
    normalization of HR sources costs more than the entire crop pipeline
    (measured: 2x loader throughput at 1024px crops from 1440px images)."""
    if _HAS_CV2:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise IOError(f"failed to read image {path}")
        if img.ndim == 3 and img.shape[2] >= 3:
            img = cv2.cvtColor(img[:, :, :3], cv2.COLOR_BGR2RGB)
    else:  # pragma: no cover
        from PIL import Image

        img = np.asarray(Image.open(path))
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] > 3:
        img = img[:, :, :3]
    return img


def read_img(path: str) -> np.ndarray:
    """Read an image file -> float32 HWC **RGB** in [0,1]."""
    return to_float01(read_img_uint8(path))


def to_float01(img: np.ndarray) -> np.ndarray:
    """Contiguous float32 [0,1]: uint8 inputs divide by 255, float inputs
    pass through (bitwise identical to converting before the crop)."""
    if img.dtype == np.uint8:
        return np.ascontiguousarray(img, dtype=np.float32) / 255.0
    return np.ascontiguousarray(img, dtype=np.float32)


def save_img(img: np.ndarray, img_path: str) -> None:
    """Save a uint8 HWC RGB (or HW) image."""
    os.makedirs(os.path.dirname(img_path) or ".", exist_ok=True)
    if _HAS_CV2:
        to_write = img[:, :, ::-1] if img.ndim == 3 else img
        cv2.imwrite(img_path, to_write)
    else:  # pragma: no cover
        from PIL import Image

        Image.fromarray(img).save(img_path)
