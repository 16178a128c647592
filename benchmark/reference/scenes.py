"""Synthetic DTU-like scenes made from a seed: the inputs both sides read.

A frozen copy of the measured program's synthetic dataset, made in bulk on
a device and driven by the seed.  Each scene is a procedurally textured
fronto-parallel plane at depth 600 seen by five DTU-like cameras (focal
~2900 px at 640 wide, translated by up to 40 units); the first V views are
a request's sources and the fifth is its target.  Near and far are DTU's
425 and 905.  Every seed gives the same sizes: only the camera offsets, and
so the pixels, change with it.
"""

from __future__ import annotations

import numpy as np
import torch

NEAR, FAR = 425.0, 905.0
PLANE_Z = 600.0
VIEWS_PER_SCENE = 5
SPREAD = 40.0


def intrinsics(hw) -> np.ndarray:
    """DTU-like intrinsics scaled with the frame width, so the field of view
    stays constant."""
    H, W = hw
    s = W / 640.0
    K = np.array([[2892.33 * s, 0, 0], [0, 2883.18 * s, 0], [0, 0, 1]], np.float32)
    K[0, 2], K[1, 2] = W / 2, H / 2
    return K


def extrinsics(seed: int, n: int) -> np.ndarray:
    """(n, 5, 4, 4) float32 world-to-camera matrices: identity rotation,
    translations uniform in [-40, 40] from ``seed``."""
    offs = np.random.default_rng(seed).uniform(-SPREAD, SPREAD, size=(n, VIEWS_PER_SCENE, 2))
    ext = np.tile(np.eye(4, dtype=np.float32), (n, VIEWS_PER_SCENE, 1, 1))
    ext[..., 0, 3], ext[..., 1, 3] = offs[..., 0], offs[..., 1]
    return ext


def texture(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        0.5 + 0.5 * torch.sin(0.05 * x) * torch.cos(0.07 * y),
        0.5 + 0.5 * torch.cos(0.04 * x + 0.06 * y),
        0.5 + 0.5 * torch.sin(0.03 * x - 0.05 * y),
    ], dim=-1).float()


def render(exts: np.ndarray, K: np.ndarray, hw, device) -> torch.Tensor:
    """Exact renders of the textured plane, (..., H, W, 3) float32 on
    ``device``, for world-to-camera matrices (..., 4, 4); float64 geometry."""
    H, W = hw
    dt = torch.float64
    lead = exts.shape[:-2]
    c2w = torch.linalg.inv(torch.as_tensor(exts, dtype=dt, device=device).reshape(-1, 4, 4))
    inv_K = torch.linalg.inv(torch.as_tensor(K, dtype=dt, device=device))
    y, x = torch.meshgrid(torch.arange(H, dtype=dt, device=device) + 0.5,
                          torch.arange(W, dtype=dt, device=device) + 0.5, indexing="ij")
    pix = torch.stack([x, y, torch.ones_like(x)], -1)  # (H, W, 3)
    out = []
    for m in c2w:  # one camera at a time keeps the float64 planes small
        dirs = pix @ (m[:3, :3] @ inv_K).T
        t = (PLANE_Z - m[2, 3]) / dirs[..., 2]
        pts = m[:3, 3] + dirs * t[..., None]
        out.append(texture(pts[..., 0], pts[..., 1]))
    return torch.stack(out).reshape(*lead, H, W, 3)


def request_inputs(images: torch.Tensor, exts: np.ndarray, K: np.ndarray, views: int) -> dict:
    """One scene as a network request of batch 1: the first ``views`` images
    are the sources, the fifth camera is the target.  ``images`` (5, H, W, 3)."""
    f32 = torch.float32
    src = torch.as_tensor(exts[:views], dtype=f32)
    return {
        "src_views": {"rgb": images[:views][None].to(f32),
                      "extrinsics": src[None],
                      "intrinsics": torch.as_tensor(np.stack([K] * views), dtype=f32)[None]},
        "tar_views": {"extrinsics": torch.as_tensor(exts[-1], dtype=f32)[None],
                      "intrinsics": torch.as_tensor(K, dtype=f32)[None]},
        "near_far": torch.tensor([[NEAR, FAR]], dtype=f32),
    }


def train_item(images: np.ndarray, exts: np.ndarray, K: np.ndarray, views: int,
               vol_scales) -> dict:
    """One training sample, as the measured program's synthetic dataset
    gives it: numpy, channels-last, the target's images at each MVS stage's
    scale (strided), constant depth and mask.  ``images`` (5, H, W, 3)."""
    H, W = images.shape[1:3]
    tar = images[-1]
    dpt = np.full((H, W), PLANE_Z, np.float32)
    mask = np.ones((H, W), np.uint8)
    gt = {"rgb": [], "mask": [], "depth": []}
    for s in vol_scales:
        h, w, k = int(H * s), int(W * s), int(1 / s)
        gt["rgb"].append(tar[::k, ::k][:h, :w])
        gt["mask"].append(mask[::k, ::k][:h, :w])
        gt["depth"].append(dpt[::k, ::k][:h, :w])
    return {
        "src_views": {"rgb": images[:views], "extrinsics": exts[:views],
                      "intrinsics": np.stack([K] * views)},
        "tar_views": {"extrinsics": exts[-1], "intrinsics": K.copy(), "rgb": tar,
                      "mask": mask, "depth": dpt},
        "near_far": np.array([NEAR, FAR], np.float32),
        "tar_gt_ms": gt,
    }
