"""Conv building blocks of the plain reference, in the published module layout.

``Sequential(Conv(bias=False), BatchNorm, ReLU)``, so a block's parameters
are ``<name>.0.weight`` and ``<name>.1.{weight,bias,running_mean,running_var}``,
the names the measured program's state dict uses.  The transposed conv is
``ConvTranspose3d(k=3, s=2, p=1, output_padding=1)`` (out = 2 * in).
BatchNorm is torch's own: batch moments in ``.train()``, running statistics
in ``.eval()``.
"""

from __future__ import annotations

import torch.nn as nn


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
