"""3D U-Nets that regularize the cost volumes.

Port of ``gdb_nerf_tpu/models/cost_reg_net.py``: stride-2 Conv3d encoder,
ConvTranspose3d decoder with additive skips, a voxel-feature head and a
softmax depth-probability head.  NCDHW.  The JAX module's depth-folded
lowerings are TPU conv layouts; cuDNN runs the 3D convs directly.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gdb_nerf_tpu_torch.models.layers import ConvBlock, DeconvBlock


def _block(c_in: int, c_out: int, stride: int = 1) -> ConvBlock:
    return ConvBlock(c_in, c_out, 3, stride, 1, ndim=3)


class CostRegNet(nn.Module):
    """3-down / 3-up variant (the fine stage)."""

    def __init__(self, in_channels: int, out_channels: int, base_channels: int):
        super().__init__()
        bc = base_channels
        self.conv0 = _block(in_channels, bc)
        self.conv1 = _block(bc, bc * 2, 2)
        self.conv2 = _block(bc * 2, bc * 2)
        self.conv3 = _block(bc * 2, bc * 4, 2)
        self.conv4 = _block(bc * 4, bc * 4)
        self.conv5 = _block(bc * 4, bc * 8, 2)
        self.conv6 = _block(bc * 8, bc * 8)
        self.conv7 = DeconvBlock(bc * 8, bc * 4)
        self.conv8 = DeconvBlock(bc * 4, bc * 2)
        self.conv9 = DeconvBlock(bc * 2, bc)
        self.feat_head = nn.Conv3d(bc, out_channels, 3, padding=1, bias=False)
        self.prob_head = nn.Conv3d(bc, 1, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor):
        """x (B, C, D, H, W) -> feat (B, out, D, H, W), prob (B, D, H, W) float32."""
        c0 = self.conv0(x)
        c2 = self.conv2(self.conv1(c0))
        c4 = self.conv4(self.conv3(c2))
        up = c4 + self.conv7(self.conv6(self.conv5(c4)))
        up = c2 + self.conv8(up)
        up = c0 + self.conv9(up)
        prob = torch.softmax(self.prob_head(up)[:, 0].float(), dim=1)
        return self.feat_head(up), prob


class CostRegNetSmall(nn.Module):
    """2-down / 2-up variant (the coarse stage)."""

    def __init__(self, in_channels: int, out_channels: int, base_channels: int):
        super().__init__()
        bc = base_channels
        self.conv0 = _block(in_channels, bc)
        self.conv1 = _block(bc, bc * 2, 2)
        self.conv2 = _block(bc * 2, bc * 2)
        self.conv3 = _block(bc * 2, bc * 4, 2)
        self.conv4 = _block(bc * 4, bc * 4)
        self.conv5 = DeconvBlock(bc * 4, bc * 2)
        self.conv6 = DeconvBlock(bc * 2, bc)
        self.feat_head = nn.Conv3d(bc, out_channels, 3, padding=1, bias=False)
        self.prob_head = nn.Conv3d(bc, 1, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor):
        c0 = self.conv0(x)
        c2 = self.conv2(self.conv1(c0))
        up = c2 + self.conv5(self.conv4(self.conv3(c2)))
        up = c0 + self.conv6(up)
        prob = torch.softmax(self.prob_head(up)[:, 0].float(), dim=1)
        return self.feat_head(up), prob
