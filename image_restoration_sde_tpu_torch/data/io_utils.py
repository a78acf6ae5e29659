"""Image file IO for the data pipeline.

A copy of ``image_restoration_sde_tpu/data/io_utils.py``.  LMDB roots are
read through the ``lmdb`` package where it is importable, else through the
port's own pure-Python reader (``mdb.MdbEnv``).

Parity: ref ``data/util.py:12-78`` — recursive sorted folder walk, cv2
decode to float32 HWC in [0,1].  We standardize on RGB channel order
end-to-end (the reference keeps BGR internally and swaps at tensor-ization,
LQGT_dataset.py:177-180); a PIL fallback covers environments without cv2.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional, Tuple

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


def get_paths_from_lmdb(dataroot: str) -> Tuple[list, list]:
    """(keys, ``C_H_W`` resolutions) from the root's ``meta_info.pkl``; one
    resolution stands for every key."""
    with open(os.path.join(dataroot, "meta_info.pkl"), "rb") as f:
        meta_info = pickle.load(f)
    paths = meta_info["keys"]
    sizes = meta_info["resolution"]
    if len(sizes) == 1:
        sizes = sizes * len(paths)
    return paths, sizes


def get_image_paths(data_type: str, dataroot: Optional[str]):
    """Sorted image paths of a folder (``img``), or ``(keys, sizes)`` of an
    LMDB root (``lmdb``)."""
    if dataroot is None:
        return None
    if data_type == "lmdb":
        return get_paths_from_lmdb(dataroot)
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


def read_img_lmdb_uint8(env, key: str, size: Tuple[int, int, int]) -> np.ndarray:
    """Read uint8 HWC RGB from an lmdb record (size = (C, H, W)).

    The channel flip (reference lmdb blobs are BGR) is a VIEW — the copy
    happens crop-sized at the caller's final float conversion."""
    with env.begin(write=False) as txn:
        buf = txn.get(key.encode("ascii"))
    C, H, W = size
    img = np.frombuffer(buf, dtype=np.uint8).reshape(H, W, C)
    if C >= 3:
        img = img[:, :, ::-1]
    return img


def open_lmdb(dataroot: str):
    """A read-only environment of an LMDB root: the ``lmdb`` package's where
    it is importable, else :class:`mdb.MdbEnv`."""
    try:
        import lmdb  # optional: the C extension when present
    except ImportError:
        from .mdb import MdbEnv  # pure-Python MDB-format fallback

        return MdbEnv(dataroot)
    return lmdb.open(dataroot, readonly=True, lock=False, readahead=False, meminit=False)


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


def decode_img_bytes(data: bytes) -> np.ndarray:
    """An encoded image (PNG, JPEG, ...) -> uint8 HWC **RGB** (HW1 for grey),
    as :func:`read_img_uint8` reads a file."""
    if _HAS_CV2:
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
        if img is None:
            raise ValueError("not a decodable image")
        if img.ndim == 3 and img.shape[2] >= 3:
            img = cv2.cvtColor(img[:, :, :3], cv2.COLOR_BGR2RGB)
    else:  # pragma: no cover
        import io

        from PIL import Image, UnidentifiedImageError

        try:
            img = np.asarray(Image.open(io.BytesIO(data)))
        except UnidentifiedImageError as e:
            raise ValueError("not a decodable image") from e
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def encode_png(img: np.ndarray) -> bytes:
    """A uint8 HWC RGB (or HW, HW1) image -> PNG bytes."""
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if _HAS_CV2:
        ok, buf = cv2.imencode(".png", img[:, :, ::-1] if img.ndim == 3 else img)
        if not ok:
            raise ValueError("PNG encoding failed")
        return buf.tobytes()
    else:  # pragma: no cover
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        return buf.getvalue()
