"""Training losses: photometric (MSE + SSIM + VGG-perceptual) and depth Smooth-L1.

Port of ``gdb_nerf_tpu/train/losses.py``:
  * ``ssim``: windowed SSIM with a 7x7 gaussian (sigma 1.5) window, the
    filter a depthwise ``F.conv2d`` with zero padding 3;
  * ``vgg_perceptual``: L1 between frozen VGG16 features at the 4 standard
    blocks, ImageNet-normalized, from ``$workspace/weights/vgg16.npz`` (the
    JAX package's file, HWIO kernels ``conv{i}_w`` and biases ``conv{i}_b``);
    0 with a one-time notice when the file is absent;
  * ``photometric_loss``: alpha*MSE + beta*(1-SSIM) + gamma*perceptual with
    weights (1.0, 0.1, 0.05);
  * ``smooth_l1_depth``: masked multiscale Smooth-L1 depth (monitoring).

The VGG16 weights, the ImageNet constants and the SSIM window are copied
from host memory at every call; on a CUDA device each copy is a host wait,
recorded by ``runtime/tracing.py`` as ``sync.vgg_weights``,
``sync.vgg_norm`` and ``sync.ssim_window``.

Images are channels-last (B, H, W, 3) tensors, as in the JAX package.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from gdb_nerf_tpu_torch.runtime import tracing


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
    with tracing.host_wait("ssim_window", img.device):
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


@lru_cache(maxsize=1)
def _vgg_weights():
    ws = os.environ.get("workspace", os.path.join(os.getcwd(), "workspace"))
    path = os.path.join(ws, "weights", "vgg16.npz")
    if not os.path.exists(path):
        print(f"[losses] VGG16 weights not found at {path}; perceptual term off")
        return None
    data = dict(np.load(path))
    # All-zero biases are the fingerprint of the random-weights fallback of
    # tools/export_vgg.py, not of pretrained VGG16: say so every run.
    if all(np.all(data[f"conv{i}_b"] == 0.0) for i in range(10)):
        print(
            "[losses] WARNING: vgg16.npz is the RANDOM-weights fallback "
            "(fixed random features, not pretrained VGG16). Export real "
            "weights with tools/export_vgg.py on a machine with "
            "torchvision and replace the file. See WEIGHTS.md."
        )
    return data


_VGG_MEAN = (0.485, 0.456, 0.406)
_VGG_STD = (0.229, 0.224, 0.225)
# Conv counts of the four feature blocks [:4], [4:9], [9:16], [16:23].
_VGG_BLOCKS = [2, 2, 3, 3]


def vgg_perceptual(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """L1 feature distance over the VGG16 blocks; 0 if the weights are absent.

    The JAX package maps the loss over the batch one sample at a time under
    ``jax.checkpoint``, a TPU memory measure; the whole-batch mean here is
    the same value (equal-size samples)."""
    w = _vgg_weights()
    if w is None:
        return torch.zeros((), dtype=img1.dtype, device=img1.device)
    with tracing.host_wait("vgg_norm", img1.device, 2):
        mean = torch.tensor(_VGG_MEAN, dtype=img1.dtype, device=img1.device)[:, None, None]
        std = torch.tensor(_VGG_STD, dtype=img1.dtype, device=img1.device)[:, None, None]

    def conv(li):
        kernel = torch.from_numpy(w[f"conv{li}_w"].transpose(3, 2, 0, 1).copy())
        bias = torch.from_numpy(w[f"conv{li}_b"])
        with tracing.host_wait("vgg_weights", img1.device, 2):
            return kernel.to(img1), bias.to(img1)

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


def photometric_loss(gt: torch.Tensor, pred: torch.Tensor,
                     weights: tuple[float, float, float] = (1.0, 0.1, 0.05)):
    """Returns (total, mse, ssim_value, perceptual)."""
    alpha, beta, gamma = weights
    mse = torch.square(gt - pred).mean()
    s = ssim(gt, pred)
    p = vgg_perceptual(gt, pred) if gamma > 0 else torch.zeros((), device=gt.device)
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
