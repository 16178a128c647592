"""Image resizing with the reference's ``F.interpolate`` semantics.

Port of ``gdb_nerf_tpu/ops/resize.py``.  The JAX package re-implements
torch's conventions; here they are torch's own operators:

  * bilinear: ``F.interpolate(mode="bilinear", align_corners=False,
    antialias=False)`` — dst pixel i samples src ``(i + 0.5) * scale - 0.5``
    with edge clamping.
  * nearest: torch's legacy ``"nearest"`` — src index ``floor(i * in / out)``.
  * pixel shuffle: ``F.pixel_shuffle`` on NCHW.

The public functions keep the JAX channels-last layout (..., H, W, C) and
permute to NCHW at the call into torch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _to_nchw(img: torch.Tensor):
    lead = img.shape[:-3]
    return img.reshape(-1, *img.shape[-3:]).permute(0, 3, 1, 2), lead


def _from_nchw(x: torch.Tensor, lead) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(*lead, *x.shape[2:], x.shape[1])


def resize_bilinear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) to (..., out_h, out_w, C)."""
    if tuple(img.shape[-3:-1]) == tuple(out_hw):
        return img
    x, lead = _to_nchw(img)
    return _from_nchw(resize_bilinear_nchw(x, out_hw), lead)


def resize_bilinear_nchw(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """``resize_bilinear`` on an NCHW tensor."""
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


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(..., H, W, C*r*r) -> (..., H*r, W*r, C), channel-major block order."""
    y, lead = _to_nchw(x)
    return _from_nchw(F.pixel_shuffle(y, r), lead)
