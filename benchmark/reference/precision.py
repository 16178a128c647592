"""The reference computed in a lower precision: the controls of ``correct``,
and the yardstick of bfloat16's own rounding.

``fp8``: every conv, transposed conv and linear layer of the reference
computes on float8 (e4m3) values, each tensor scaled by its largest
magnitude over 448 and rounded, weights once and the layer's input at every
call; the NeRF heads take every input rounded (the payload they blend too),
and their own functional products read the rounded weights.  It stands for
the step below bfloat16, where the program runs its feature path.  ``bf16``:
the same roundings to bfloat16, the configuration's own precision: how far
rounding alone moves this seed's network.  ``tf32``: matmuls and cuDNN
convolutions in TF32, the step below float32 with TF32 off.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

E4M3_MAX = 448.0
_WEIGHTED = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d, nn.Linear)
_HEADS = ("BundleNeRF", "StageNeRF")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in its dtype."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, back in its dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def rounded(network: nn.Module, rnd) -> list:
    """Round every weighted layer's weights in place with ``rnd`` and round
    its input at each call; returns the hook handles."""
    handles = []
    with torch.no_grad():
        for m in network.modules():
            if isinstance(m, _WEIGHTED):
                m.weight.copy_(rnd(m.weight))
                if m.bias is not None:
                    m.bias.copy_(rnd(m.bias))
                handles.append(m.register_forward_pre_hook(
                    lambda mod, args: (rnd(args[0]), *args[1:])))
            elif type(m).__name__ in _HEADS:
                handles.append(m.register_forward_pre_hook(
                    lambda mod, args: tuple(rnd(a) if torch.is_tensor(a) else a for a in args)))
    return handles


def to_fp8(network: nn.Module) -> list:
    return rounded(network, fp8_round)


def to_bf16(network: nn.Module) -> list:
    return rounded(network, bf16_round)


@contextlib.contextmanager
def tf32():
    """Matmuls and cuDNN convolutions in TF32 inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@contextlib.contextmanager
def float32_exact():
    """Matmuls and cuDNN convolutions in full float32 inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
