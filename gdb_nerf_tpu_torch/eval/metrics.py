"""Image quality metrics with skimage's semantics.

A copy of ``gdb_nerf_tpu/eval/metrics.py``: PSNR as
``skimage.metrics.peak_signal_noise_ratio`` on masked pixel sets, SSIM as
``skimage.metrics.structural_similarity`` with its defaults (win_size=7,
uniform windows, K1=0.01/K2=0.03, border crop of the ssim map), with
scipy's uniform_filter, the primitive skimage uses.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def psnr(gt: np.ndarray, pred: np.ndarray, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio over any-shape arrays (masked sets OK)."""
    mse = np.mean((gt.astype(np.float64) - pred.astype(np.float64)) ** 2)
    return float(10.0 * np.log10((data_range**2) / mse))


def _ssim_single(im1: np.ndarray, im2: np.ndarray, data_range: float, win: int):
    NP = win * win
    cov_norm = NP / (NP - 1)
    f = lambda x: uniform_filter(x, size=win)
    ux, uy = f(im1), f(im2)
    uxx, uyy, uxy = f(im1 * im1), f(im2 * im2), f(im1 * im2)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    K1, K2 = 0.01, 0.03
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    A1 = 2 * ux * uy + C1
    A2 = 2 * vxy + C2
    B1 = ux * ux + uy * uy + C1
    B2 = vx + vy + C2
    S = (A1 * A2) / (B1 * B2)
    pad = (win - 1) // 2
    return S[pad:-pad, pad:-pad].mean()


def ssim(
    im1: np.ndarray,
    im2: np.ndarray,
    data_range: float = 1.0,
    win_size: int = 7,
    channel_axis: int | None = -1,
) -> float:
    """Structural similarity with skimage-default semantics."""
    im1 = im1.astype(np.float64)
    im2 = im2.astype(np.float64)
    if channel_axis is not None:
        im1 = np.moveaxis(im1, channel_axis, -1)
        im2 = np.moveaxis(im2, channel_axis, -1)
        vals = [
            _ssim_single(im1[..., c], im2[..., c], data_range, win_size)
            for c in range(im1.shape[-1])
        ]
        return float(np.mean(vals))
    return float(_ssim_single(im1, im2, data_range, win_size))
