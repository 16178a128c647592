"""Conv building blocks with the reference's module layout.

Port of ``ConvBlock`` / ``DeconvBlock`` from ``gdb_nerf_tpu/models/layers.py``
as the reference builds them: ``Sequential(Conv(bias=False), BatchNorm,
ReLU)``, so a block's parameters are ``<name>.0.weight`` and
``<name>.1.{weight,bias,running_mean,running_var}``.  The transposed conv is
``ConvTranspose3d(k=3, s=2, p=1, output_padding=1)`` (out = 2 * in).

Dtype: a network whose feature path runs in bf16 holds that path's conv and
linear weights in bf16 (``cast_weights``, once, when it is built), so every
layer computes in its weights' dtype with no cast per call.  BatchNorm
parameters and statistics stay float32; BatchNorm normalizes a bf16 input
with them and returns bf16.
"""

from __future__ import annotations

import torch
import torch.nn as nn

_WEIGHTED = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d, nn.Linear)


def cast_weights(module: nn.Module, dtype: torch.dtype, keep=()) -> nn.Module:
    """Cast, in place, the weights and biases of every conv and linear layer
    under ``module`` to ``dtype``, except the layers in ``keep``, which stay
    float32.  A state dict loaded afterwards is cast into these dtypes."""
    kept = {id(m) for m in keep}
    for m in module.modules():
        if isinstance(m, _WEIGHTED) and id(m) not in kept:
            m.to(dtype)
    return module


class ConvBlock(nn.Sequential):
    """Conv (bias-free) + BatchNorm + ReLU, 2D or 3D."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1,
                 padding: int = 0, ndim: int = 2):
        conv, bn = (nn.Conv2d, nn.BatchNorm2d) if ndim == 2 else (nn.Conv3d, nn.BatchNorm3d)
        super().__init__(
            conv(c_in, c_out, kernel, stride, padding, bias=False),
            bn(c_out, eps=1e-5, momentum=0.1),
            nn.ReLU(),
        )


class DeconvBlock(nn.Sequential):
    """ConvTranspose3d(k=3, s=2, p=1, op=1) + BatchNorm3d + ReLU."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__(
            nn.ConvTranspose3d(c_in, c_out, 3, 2, 1, output_padding=1, bias=False),
            nn.BatchNorm3d(c_out, eps=1e-5, momentum=0.1),
            nn.ReLU(),
        )
