"""Bilinear / trilinear grid sampling, plain ``F.grid_sample``.

Normalized coordinates in [-1, 1] with align_corners=False (-1/+1 are the
outer edges of the corner pixels), and 'border' (clamped) or 'zeros'
padding.  The tables are NC(D)HW; the samples come back channels-last.
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
