"""PyTorch port, the native C++ resampler (``data/native.py``, its copy of
``native/resize.cpp``): bit-equal to the JAX package's native resampler on
matlab's antialiased x1/4, x2 and both boundaries; ``imresize`` equal to
the JAX package's and taking the native path where ``g++`` exists; a
failed build raises; without ``g++`` the numpy weights."""

import numpy as np
import pytest

from image_restoration_sde_tpu.data import imresize as jimresize
from image_restoration_sde_tpu.data import native as jnative
from image_restoration_sde_tpu_torch.data import imresize, native

pytestmark = pytest.mark.skipif(not native.available(), reason="no g++: the port's resampler takes numpy")

CASES = {  # (scale, a, antialias, boundary): matlab imresize and torch bicubic
    "matlab_quarter_aa": (0.25, -0.5, True, "symmetric"),
    "matlab_x2": (2.0, -0.5, True, "symmetric"),
    "bicubic_quarter": (0.25, -0.75, False, "replicate"),
    "bicubic_x2": (2.0, -0.75, False, "replicate"),
    "bicubic_to_shape": ((13, 29), -0.75, False, "replicate"),
}


def _img(seed=0, hw=(37, 52), c=3):
    return np.random.default_rng(seed).random((*hw, c)).astype(np.float32)


@pytest.mark.parametrize("case", CASES)
def test_native_resize_is_bit_equal_to_the_jax_packages(case):
    scale, a, aa, boundary = CASES[case]
    img = _img()
    H, W = img.shape[:2]
    if isinstance(scale, tuple):
        out_hw, scales = scale, (scale[0] / H, scale[1] / W)
    else:
        out_hw, scales = (int(np.ceil(H * scale)), int(np.ceil(W * scale))), (scale, scale)
    want = jnative.resize_cubic_native(img, out_hw, scales, a, aa, boundary)
    assert want is not None  # the JAX package built its library too
    got = native.resize_cubic_native(img, out_hw, scales, a, aa, boundary)
    assert got.dtype == np.float32 and got.shape == (*out_hw, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", [0.25, 0.5, 3.0, (13, 29)], ids=str)
def test_imresize_takes_the_native_path_and_equals_the_jax_packages(scale, monkeypatch):
    """matlab imresize and torch bicubic on (21, 34, 3) and a 2-D image:
    bit-equal to the JAX package's (both native), one native call each,
    within 1e-6 of the numpy weights (float64 sums in another order)."""
    calls = []
    orig = native.resize_cubic_native

    def counted(*args):
        calls.append(args[1])
        return orig(*args)

    monkeypatch.setattr(native, "resize_cubic_native", counted)
    for img in (_img(4, (21, 34)), _img(5, (21, 34), 1)[..., 0]):
        for jfn, pfn, a, aa, boundary in ((jimresize.imresize, imresize.imresize, -0.5, True, "symmetric"),
                                          (jimresize.torch_bicubic_resize, imresize.torch_bicubic_resize, -0.75,
                                           False, "replicate")):
            want, got = jfn(img, scale), pfn(img, scale)
            assert got.shape == want.shape and got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
            h, w = img.shape[:2]
            s = (scale[0] / h, scale[1] / w) if isinstance(scale, tuple) else (scale, scale)
            plain = img if img.ndim == 3 else img[..., None]
            plain = jimresize._resize_axis(plain, got.shape[0], s[0], 0, a, aa, boundary)
            plain = jimresize._resize_axis(plain, got.shape[1], s[1], 1, a, aa, boundary).astype(np.float32)
            assert np.abs(got - plain.reshape(got.shape)).max() <= 1e-6
    assert len(calls) == 4


def test_a_failed_build_raises_and_no_compiler_takes_numpy(tmp_path, monkeypatch):
    """A source g++ cannot compile raises (no quiet fallback); with no g++
    on the path ``available()`` says so and ``imresize`` takes the numpy
    weights, which the native path matches within 1e-6."""
    broken = tmp_path / "resize.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "PKG_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ exited"):
        imresize.imresize(_img(), 0.5)
    monkeypatch.setattr(native, "compiler", lambda: None)
    assert not native.available()
    img = _img(6)
    got = imresize.imresize(img, 0.5)
    monkeypatch.undo()
    assert native.available()
    assert np.abs(got - imresize.imresize(img, 0.5)).max() <= 1e-6
