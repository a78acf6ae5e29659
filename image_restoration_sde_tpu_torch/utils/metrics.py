"""Evaluation metrics: PSNR and matlab-style SSIM.

A copy of ``image_restoration_sde_tpu/utils/metrics.py`` (numpy and scipy).

Parity: ref ``utils/img_utils.py:182-234``.  The reference's
``calculate_ssim`` has a channel-loop bug (it computes the same full-image
SSIM three times, img_utils.py:226-230); numerically that equals computing
SSIM over the HxWx3 array once, which is what we do — same outputs, no dead
loop.  Inputs are uint8-scale [0,255] arrays (HW or HWC), matching the
reference convention.
"""

from __future__ import annotations

import math

import numpy as np


def calculate_psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(255.0 / math.sqrt(mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    # cv2.getGaussianKernel parity
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    k /= k.sum()
    return np.outer(k, k)


def _filter2d_valid(img: np.ndarray, window: np.ndarray) -> np.ndarray:
    """'same' correlation then crop 5 px per side — matches the reference's
    cv2.filter2D(...)[5:-5, 5:-5] on each channel."""
    from scipy.ndimage import correlate

    if img.ndim == 2:
        out = correlate(img, window, mode="reflect")
        return out[5:-5, 5:-5]
    chans = [correlate(img[:, :, c], window, mode="reflect") for c in range(img.shape[2])]
    return np.stack(chans, axis=2)[5:-5, 5:-5]


def ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """Gaussian-window SSIM, valid region (ref img_utils.py:192-218)."""
    C1 = (0.01 * 255) ** 2
    C2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    window = _gaussian_window()

    mu1 = _filter2d_valid(img1, window)
    mu2 = _filter2d_valid(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = _filter2d_valid(img1**2, window) - mu1_sq
    sigma2_sq = _filter2d_valid(img2**2, window) - mu2_sq
    sigma12 = _filter2d_valid(img1 * img2, window) - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    return float(ssim_map.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    if img1.ndim == 2:
        return ssim(img1, img2)
    if img1.ndim == 3:
        if img1.shape[2] == 3:
            return ssim(img1, img2)
        if img1.shape[2] == 1:
            return ssim(img1[:, :, 0], img2[:, :, 0])
    raise ValueError("Wrong input image dimensions.")
