"""Image resizing with torch's ``F.interpolate`` semantics, plain.

  * bilinear: ``F.interpolate(mode="bilinear", align_corners=False,
    antialias=False)``: dst pixel i samples src ``(i + 0.5) * scale - 0.5``
    with edge clamping.
  * nearest: torch's legacy ``"nearest"``: src index ``floor(i * in / out)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_nchw(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NCHW tensor to (out_h, out_w)."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(
        x, size=tuple(out_hw), mode="bilinear", align_corners=False, antialias=False
    )


def resize_nearest(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Legacy-nearest resize of (..., H, W) maps."""
    if tuple(img.shape[-2:]) == tuple(out_hw):
        return img
    lead = img.shape[:-2]
    x = img.reshape(-1, 1, *img.shape[-2:])
    return F.interpolate(x, size=tuple(out_hw), mode="nearest").reshape(*lead, *out_hw)
