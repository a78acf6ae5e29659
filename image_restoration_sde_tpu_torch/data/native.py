"""The native C++ resampler (``csrc/resize.cpp``) through ctypes.

Counterpart of ``image_restoration_sde_tpu/data/native.py``.  The library
builds with ``g++`` at its first use into ``_build/native/<hash of the
source and flags>/`` inside the package (listed in ``.gitignore``), with
the JAX package's flags, so the two give the same bits.
:func:`data.imresize._resize` takes this path wherever ``g++`` is found
(:func:`available`); there a failed build or a failed call raises rather
than falling back to numpy.  Only where no ``g++`` exists does the numpy
path run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SRC = PKG_DIR / "csrc" / "resize.cpp"
FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
LIB_NAME = "libirsde_resize.so"
BOUNDARY = {"symmetric": 0, "replicate": 1}

_LIB = None
_LOCK = threading.Lock()


def compiler():
    """The ``g++`` on the path, or None."""
    return shutil.which("g++")


def available() -> bool:
    """Whether the native path is in use: ``g++`` is found (the library
    then builds at first use, or the call raises)."""
    return compiler() is not None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return PKG_DIR / "_build" / "native" / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the library unless the current source has one: into a file
    of this process's, then renamed into place (processes that build at
    once each write their own)."""
    lib = library_path()
    if lib.is_file():
        return lib
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("native resampler: no g++ on the path")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    run = subprocess.run([cxx, *FLAGS, str(SRC), "-o", str(tmp)], capture_output=True, text=True, timeout=300)
    if run.returncode != 0:
        raise RuntimeError(f"native resampler: g++ exited {run.returncode}: {run.stderr[-2000:]}")
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.resize_cubic_f32.restype = ctypes.c_int
            lib.resize_cubic_f32.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
            ]
            _LIB = lib
    return _LIB


def resize_cubic_native(img: np.ndarray, out_hw, scales, a: float, antialias: bool, boundary: str) -> np.ndarray:
    """(H, W, C) float32 -> (OH, OW, C) float32, the kernel placed by
    ``scales`` (matlab's rule: the requested scale, not OH / H)."""
    if boundary not in BOUNDARY:
        raise ValueError(f"native resampler: boundary {boundary!r}; options: {sorted(BOUNDARY)}")
    img = np.ascontiguousarray(img, dtype=np.float32)
    H, W, C = img.shape
    OH, OW = out_hw
    dst = np.empty((OH, OW, C), dtype=np.float32)
    rc = load_library().resize_cubic_f32(img.ctypes.data, H, W, C, dst.ctypes.data, OH, OW, float(scales[0]),
                                         float(scales[1]), float(a), int(bool(antialias)), BOUNDARY[boundary])
    if rc != 0:
        raise RuntimeError(f"native resampler: resize_cubic_f32 returned {rc}")
    return dst
