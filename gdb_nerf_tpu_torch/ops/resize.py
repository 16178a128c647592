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

The bilinear resize's CUDA backward adds with atomics; under
``torch.use_deterministic_algorithms(True)`` (where it raises) a resize
that needs a gradient takes the same taps by ``index_select`` along each
axis, whose backward is deterministic there.
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
    if torch.are_deterministic_algorithms_enabled() and torch.is_grad_enabled() and x.requires_grad:
        return _bilinear_by_taps(x, out_hw)
    return F.interpolate(
        x, size=tuple(out_hw), mode="bilinear", align_corners=False, antialias=False
    )


def _bilinear_by_taps(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """``F.interpolate``'s bilinear taps, along W and then H: dst i samples
    src max((i + 0.5) * in / out - 0.5, 0) between floor and floor + 1
    (clamped to the last row)."""
    for dim, out in ((-1, out_hw[1]), (-2, out_hw[0])):
        size = x.shape[dim]
        dst = torch.arange(out, device=x.device, dtype=torch.promote_types(x.dtype, torch.float32))
        src = torch.clamp_min((dst + 0.5) * (size / out) - 0.5, 0.0)
        i0 = src.long()
        frac = (src - i0).to(x.dtype).reshape([out] + [1] * (-dim - 1))
        i1 = torch.clamp_max(i0 + 1, size - 1)
        x = x.index_select(dim, i0) * (1.0 - frac) + x.index_select(dim, i1) * frac
    return x


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
