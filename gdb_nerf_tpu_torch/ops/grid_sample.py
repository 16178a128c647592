"""Bilinear / trilinear grid sampling with the reference's conventions.

Port of the plain semantics of ``gdb_nerf_tpu/ops/grid_sample.py``
(``grid_sample_2d`` / ``grid_sample_3d``): normalized coordinates in
[-1, 1] with align_corners=False (-1/+1 are the outer edges of the corner
pixels), and 'border' (clamped) or 'zeros' padding.  That is exactly
``F.grid_sample(mode="bilinear", align_corners=False)``.  The packed,
paired and patch gather tables of the JAX module are TPU gather
workarounds and have no counterpart here.

Channels-last like the JAX functions, with a leading batch axis written
out: ``img`` (N, H, W, C) and ``grid`` (N, ..., 2) give (N, ..., C).
``grid_sample_2d_nchw`` / ``grid_sample_3d_ncdhw`` take the NC(D)HW tables
the port keeps its feature maps in, and return channels-last samples.

The grid and the table must share a dtype in ``F.grid_sample``; callers
sample bf16-valued tables through float32 copies, because a bf16 grid
would lose sub-pixel precision.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d_nchw(
    img: torch.Tensor, grid: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """Sample (N, C, H, W) at grid (N, ..., 2) -> (N, ..., C)."""
    N, C = img.shape[:2]
    lead = grid.shape[1:-1]
    g = grid.reshape(N, -1, 1, 2)
    out = F.grid_sample(
        img, g, mode="bilinear", padding_mode=padding_mode, align_corners=False
    )  # (N, C, P, 1)
    return out[..., 0].transpose(1, 2).reshape(N, *lead, C)


def grid_sample_3d_ncdhw(
    vol: torch.Tensor, grid: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """Sample (N, C, D, H, W) at grid (N, ..., 3) (x=W, y=H, z=D) -> (N, ..., C)."""
    N, C = vol.shape[:2]
    lead = grid.shape[1:-1]
    g = grid.reshape(N, -1, 1, 1, 3)
    out = F.grid_sample(
        vol, g, mode="bilinear", padding_mode=padding_mode, align_corners=False
    )  # (N, C, P, 1, 1)
    return out[..., 0, 0].transpose(1, 2).reshape(N, *lead, C)


def grid_sample_2d(
    img: torch.Tensor, grid: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """Bilinear sample of channels-last images (N, H, W, C) at grid (N, ..., 2)."""
    return grid_sample_2d_nchw(img.permute(0, 3, 1, 2), grid, padding_mode)


def grid_sample_3d(
    vol: torch.Tensor, grid: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """Trilinear sample of channels-last volumes (N, D, H, W, C) at grid (N, ..., 3)."""
    return grid_sample_3d_ncdhw(vol.permute(0, 4, 1, 2, 3), grid, padding_mode)
