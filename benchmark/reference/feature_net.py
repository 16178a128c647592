"""2D feature pyramid network over source images.

Port of ``gdb_nerf_tpu/models/feature_net.py::FeatureNet``: stride-2
downsamples to 1/2 and 1/4, nearest-upsample + 1x1 lateral top-down
merging, and per-level heads.  NCHW; BatchNorm uses its running statistics
(eval).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.layers import ConvBlock


class FeatureNet(nn.Module):
    def __init__(self, base_channels: int = 8, out_channels: Sequence[int] = (32, 16, 8)):
        super().__init__()
        bc = base_channels
        self.conv0 = nn.Sequential(ConvBlock(3, bc, 3, 1, 1), ConvBlock(bc, bc, 3, 1, 1))
        self.conv1 = nn.Sequential(
            ConvBlock(bc, bc * 2, 5, 2, 2), ConvBlock(bc * 2, bc * 2, 3, 1, 1)
        )
        self.conv2 = nn.Sequential(
            ConvBlock(bc * 2, bc * 4, 5, 2, 2), ConvBlock(bc * 4, bc * 4, 3, 1, 1)
        )
        self.out0 = nn.Conv2d(bc * 4, out_channels[0], 1)
        self.inner1 = nn.Conv2d(bc * 2, bc * 4, 1)
        self.inner2 = nn.Conv2d(bc, bc * 4, 1)
        self.out1 = nn.Conv2d(bc * 4, out_channels[1], 3, padding=1, bias=False)
        self.out2 = nn.Conv2d(bc * 4, out_channels[2], 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x (N, 3, H, W) -> [coarse (1/4), mid (1/2), fine (1)] NCHW maps."""
        c0 = self.conv0(x)
        c1 = self.conv1(c0)
        c2 = self.conv2(c1)
        out0 = self.out0(c2)
        intra = F.interpolate(c2, scale_factor=2, mode="nearest") + self.inner1(c1)
        out1 = self.out1(intra)
        intra = F.interpolate(intra, scale_factor=2, mode="nearest") + self.inner2(c0)
        out2 = self.out2(intra)
        return [out0, out1, out2]
