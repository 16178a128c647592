"""Volumetric compositing over dense masked samples.

Port of ``gdb_nerf_tpu/ops/render.py``: the reference's nerfacc compositing
with per-bundle L1 weight normalization, on a dense (..., S) sample layout
with a validity mask.
"""

from __future__ import annotations

import torch


def weights_from_sigma(sigma: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Normalized compositing weights (..., S) from densities (..., S).

    alpha_i = 1 - exp(-sigma_i), zero for invalid samples;
    T_i = prod_{j<i} (1 - alpha_j + 1e-10); w_i = alpha_i T_i, then
    L1-normalized per ray with a 1e-6 floor.
    """
    alpha = (1.0 - torch.exp(-sigma)) * valid.to(sigma.dtype)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    weights = alpha * trans
    wsum = torch.clamp_min(weights.sum(dim=-1, keepdim=True), 1e-6)
    return weights / wsum


def composite(weights: torch.Tensor, feat: torch.Tensor, z_vals: torch.Tensor):
    """Accumulate features (..., S, C), depth and opacity along the sample axis.

    Returns feat_map (..., C) in float32, depth_map (...,), opacity (...,).
    """
    feat_map = (weights[..., None] * feat.float()).sum(dim=-2)
    depth_map = (weights * z_vals).sum(dim=-1)
    opacity = weights.sum(dim=-1)
    return feat_map, depth_map, opacity
