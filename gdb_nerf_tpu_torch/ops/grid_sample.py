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

``F.grid_sample``'s CUDA backward adds into the table's gradient with
atomics, so a training run on the card is not bit-reproducible.  Under
``torch.use_deterministic_algorithms(True)`` (where that backward raises),
a sample that needs a gradient goes through ``_sample_by_taps`` instead:
the same bilinear/trilinear taps as row lookups, whose backward
(``index_put_`` with accumulation) is deterministic on the card.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F


def _deterministic_grad(*tensors: torch.Tensor) -> bool:
    return (torch.are_deterministic_algorithms_enabled() and torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors))


def _axis_taps(coord: torch.Tensor, size: int, padding_mode: str):
    """The two taps along one axis of normalized ``coord``: (index, weight)
    pairs, the index clamped into the table and the weight zero where the
    tap lies outside it (``F.grid_sample``'s unnormalization and padding)."""
    x = ((coord + 1.0) * size - 1.0) * 0.5
    if padding_mode == "border":
        x = torch.clamp(x, 0.0, float(size - 1))
    x0 = torch.floor(x)
    frac = x - x0
    i0 = x0.long()
    taps = []
    for i, w in ((i0, 1.0 - frac), (i0 + 1, frac)):
        inside = (i >= 0) & (i < size)
        taps.append((torch.clamp(i, 0, size - 1), w * inside))
    return taps


def _sample_by_taps(table: torch.Tensor, grid: torch.Tensor, padding_mode: str) -> torch.Tensor:
    """``F.grid_sample`` (bilinear, align_corners=False) of (N, C, *sizes)
    at grid (N, ..., len(sizes)) as weighted row lookups -> (N, P, C)."""
    N, C, *sizes = table.shape
    g = grid.reshape(N, -1, len(sizes))
    # grid[..., k] indexes the k-th spatial axis from the last (x = W).
    axes = [_axis_taps(g[..., k], sizes[-1 - k], padding_mode) for k in range(len(sizes))]
    rows = table.reshape(N, C, -1).transpose(1, 2)  # (N, prod(sizes), C)
    batch = torch.arange(N, device=table.device)[:, None]
    out = None
    for combo in itertools.product(*axes):
        index, weight, stride = 0, 1.0, 1
        for (i, w), size in zip(combo, reversed(sizes)):
            index, weight, stride = index + i * stride, weight * w, stride * size
        tap = rows[batch, index] * weight[..., None]
        out = tap if out is None else out + tap
    return out


def grid_sample_2d_nchw(
    img: torch.Tensor, grid: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """Sample (N, C, H, W) at grid (N, ..., 2) -> (N, ..., C)."""
    N, C = img.shape[:2]
    lead = grid.shape[1:-1]
    if _deterministic_grad(img, grid):
        return _sample_by_taps(img, grid, padding_mode).reshape(N, *lead, C)
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
    if _deterministic_grad(vol, grid):
        return _sample_by_taps(vol, grid, padding_mode).reshape(N, *lead, C)
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
