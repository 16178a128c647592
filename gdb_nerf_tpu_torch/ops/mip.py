"""Mipmapped texture sampling, the reference's nvdiffrast texture call.

Port of ``build_pyramid`` and the semantics of ``mip_texture_fetch`` from
``gdb_nerf_tpu/ops/mip.py``: a 2x2 box-filtered pyramid, bilinear taps at
the fractional level's two neighbours with clamped boundaries, blended by
the fraction.  Texture coordinates follow nvdiffrast: uv in [0, 1] with
texel centers at (i + 0.5) / size.  The JAX module's packed pyramid tables
are TPU gather layouts and are not ported.

The clamp boundary is taken as ``F.grid_sample(padding_mode="border")``,
which clips the continuous coordinate to [0, size - 1] before the taps;
that equals clamping the integer tap indices (``mip.py::_bilinear_clamp``).

Layout: NCHW tables, (N, P, 2) coordinates, (N, P, C) results.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gdb_nerf_tpu_torch.ops.grid_sample import grid_sample_2d_nchw


def build_pyramid(img: torch.Tensor, max_level: int) -> list[torch.Tensor]:
    """Box-filter pyramid of (N, C, H, W); H and W divisible by 2**max_level.

    Returns max_level + 1 tensors, level 0 being ``img``.
    """
    levels = [img]
    for _ in range(max_level):
        levels.append(F.avg_pool2d(levels[-1], 2))
    return levels


def mip_texture_fetch(
    levels: list[torch.Tensor],
    uv: torch.Tensor,
    lod: torch.Tensor,
    max_level: int,
) -> torch.Tensor:
    """Trilinear fetch at fractional level ``lod`` (N, P), clamped to [0, max_level].

    Args: levels from ``build_pyramid``; uv (N, P, 2) in [0, 1].
    Returns (N, P, C) in the tables' dtype.
    """
    lod = torch.clamp(lod, 0.0, float(max_level))
    grid = 2.0 * uv - 1.0
    out = None
    for lvl in range(max_level + 1):
        # Tent weight: nonzero only at floor(lod) and floor(lod) + 1.
        w = torch.clamp_min(1.0 - torch.abs(lod - float(lvl)), 0.0)[..., None]
        tap = grid_sample_2d_nchw(levels[lvl], grid, padding_mode="border") * w
        out = tap if out is None else out + tap
    return out
