"""Training losses of the plain reference: photometric (MSE + SSIM + VGG) and depth Smooth-L1.

A frozen copy of the measured program's losses; the VGG16 weights are
handed in as tensors (``vgg``: ten (weight OIHW, bias) pairs) instead of
being read from a workspace file:
  * ``ssim``: windowed SSIM with a 7x7 gaussian (sigma 1.5) window, the
    filter a depthwise ``F.conv2d`` with zero padding 3;
  * ``vgg_perceptual``: L1 between frozen VGG16 features at the 4 standard
    blocks, ImageNet-normalized;
  * ``photometric_loss``: alpha*MSE + beta*(1-SSIM) + gamma*perceptual with
    weights (1.0, 0.1, 0.05);
  * ``smooth_l1_depth``: masked multiscale Smooth-L1 depth (monitoring).

Images are channels-last (B, H, W, 3) tensors, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_window(size: int = 7, sigma: float = 1.5) -> np.ndarray:
    g = np.arange(size, dtype=np.float64)
    g = np.exp(-((g - size // 2) ** 2) / (2 * sigma**2))
    g /= g.sum()
    w = np.outer(g, g)
    return w.astype(np.float32)


_WINDOW = _gaussian_window()


def _filter(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise 2D filter of (B, H, W, C) with a (k, k) window, zero padding k//2."""
    k = window.shape[0]
    C = img.shape[-1]
    weight = window.to(img)[None, None].expand(C, 1, k, k)
    out = F.conv2d(img.permute(0, 3, 1, 2), weight, padding=k // 2, groups=C)
    return out.permute(0, 2, 3, 1)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 7) -> torch.Tensor:
    """Mean SSIM over a batch of (B, H, W, C) images (train-loss variant)."""
    w = torch.from_numpy(_WINDOW if window_size == 7 else _gaussian_window(window_size))
    mu1 = _filter(img1, w)
    mu2 = _filter(img2, w)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _filter(img1 * img1, w) - mu1_sq
    s2 = _filter(img2 * img2, w) - mu2_sq
    s12 = _filter(img1 * img2, w) - mu12
    C1, C2 = 0.01**2, 0.03**2
    smap = ((2 * mu12 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return smap.mean()


_VGG_MEAN = (0.485, 0.456, 0.406)
_VGG_STD = (0.229, 0.224, 0.225)
# Conv counts of the four feature blocks [:4], [4:9], [9:16], [16:23].
_VGG_BLOCKS = [2, 2, 3, 3]


def vgg_perceptual(img1: torch.Tensor, img2: torch.Tensor, vgg) -> torch.Tensor:
    """L1 feature distance over the VGG16 blocks, batch mean."""
    mean = torch.tensor(_VGG_MEAN, dtype=img1.dtype, device=img1.device)[:, None, None]
    std = torch.tensor(_VGG_STD, dtype=img1.dtype, device=img1.device)[:, None, None]

    def conv(li):
        return vgg[li][0].to(img1), vgg[li][1].to(img1)

    def features(x):
        h = (x.permute(0, 3, 1, 2) - mean) / std
        taps, li = [], 0
        for bi, n_convs in enumerate(_VGG_BLOCKS):
            for _ in range(n_convs):
                h = torch.relu(F.conv2d(h, *conv(li), padding=1))
                li += 1
            taps.append(h)
            if bi < len(_VGG_BLOCKS) - 1:
                h = F.max_pool2d(h, 2, 2)
        return taps

    acc = torch.zeros((), dtype=img1.dtype, device=img1.device)
    for a, b in zip(features(img1), features(img2)):
        acc = acc + (a - b).abs().mean()
    return acc


def photometric_loss(gt: torch.Tensor, pred: torch.Tensor, vgg,
                     weights: tuple[float, float, float] = (1.0, 0.1, 0.05)):
    """Returns (total, mse, ssim_value, perceptual); ``vgg`` None leaves the
    perceptual term out."""
    alpha, beta, gamma = weights
    mse = torch.square(gt - pred).mean()
    s = ssim(gt, pred)
    p = (vgg_perceptual(gt, pred, vgg) if gamma > 0 and vgg is not None
         else torch.zeros((), device=gt.device))
    total = alpha * mse + beta * (1.0 - s) + gamma * p
    return total, mse, s, p


def smooth_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d = torch.abs(x - y)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def smooth_l1_depth(depth_est, depth_gt, masks, rates):
    """Masked multiscale Smooth-L1 depth error (monitoring only)."""
    loss = 0.0
    stats = {}
    for i, rate in enumerate(rates):
        m = masks[i] > 0.5
        denom = torch.clamp_min(m.sum(), 1)
        li = (smooth_l1(depth_est[i], depth_gt[i]) * m).sum() / denom
        stats[f"depth_loss{i}"] = li
        loss = loss + rate * li
    return loss, stats
