"""Residual-dense-network decoder: bundle feature map -> full-resolution RGB.

Port of ``gdb_nerf_tpu/models/decoder_rdn.py::Decoder``: an input conv, a
stack of residual dense blocks with squeeze-and-excitation, log2(b)
conv + pixel-shuffle upsampling stages, and a 1x1 output conv that runs in
float32 whatever the feature dtype.  NCHW.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn


class SEBlock(nn.Module):
    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(channels, channels // reduction, bias=False), nn.ReLU(),
            nn.Linear(channels // reduction, channels, bias=False), nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class ResidualDenseBlock(nn.Module):
    def __init__(self, num_feats: int, growth_rate: int = 32):
        super().__init__()
        self.conv1 = nn.Conv2d(num_feats, growth_rate, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(num_feats + growth_rate, growth_rate, 3, padding=1, bias=False)
        self.conv3 = nn.Conv2d(num_feats + 2 * growth_rate, num_feats, 3, padding=1, bias=False)
        self.se = SEBlock(num_feats)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = torch.relu(self.conv1(x))
        x2 = torch.relu(self.conv2(torch.cat([x, x1], dim=1)))
        x3 = self.conv3(torch.cat([x, x1, x2], dim=1))
        return x + self.se(x3)


class Decoder(nn.Module):
    def __init__(self, in_channels: int, out_channels: int = 3, num_feats: int = 64,
                 num_layers: int = 3, upscale_factor: int = 2):
        super().__init__()
        if upscale_factor <= 0 or upscale_factor & (upscale_factor - 1):
            raise ValueError("upscale_factor must be a power of 2")
        self.in_conv = nn.Conv2d(in_channels, num_feats, 3, padding=1)
        self.blocks = nn.Sequential(*[ResidualDenseBlock(num_feats) for _ in range(num_layers)])
        ups = []
        for _ in range(int(round(math.log2(upscale_factor)))):
            ups += [nn.Conv2d(num_feats, 4 * num_feats, 3, padding=1), nn.PixelShuffle(2)]
        self.up = nn.Sequential(*ups)
        self.out_conv = nn.Conv2d(num_feats, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C_in, H, W) -> (B, out, H*b, W*b) float32."""
        shallow = self.in_conv(x)
        h = self.up(shallow + self.blocks(shallow))
        return self.out_conv(h.float())
