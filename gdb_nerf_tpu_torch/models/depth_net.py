"""Cascaded plane-sweep MVS depth estimation (eval path).

Port of the eval branch of ``gdb_nerf_tpu/models/depth_net.py::DepthNet``:
per stage a variance cost volume over depth (or disparity) hypotheses, a 3D
U-Net, and a regressed depth with a confidence interval that seeds the next
stage.  ``vol_range`` values exchanged between stages are metric depth.
The training-only stage NeRFs are declared (``nerfs``) so reference
checkpoints load strictly; their forward comes with the training path.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from gdb_nerf_tpu_torch.models.cost_reg_net import CostRegNet, CostRegNetSmall
from gdb_nerf_tpu_torch.models.nerf_head import StageNeRF
from gdb_nerf_tpu_torch.ops import camera, cost_volume
from gdb_nerf_tpu_torch.ops.resize import resize_bilinear_nchw


class DepthNet(nn.Module):
    def __init__(
        self,
        base_channels: int = 8,
        vol_levels: Sequence[int] = (0, 1),
        vol_scales: Sequence[float] = (0.125, 0.5),
        feat_scales: Sequence[float] = (0.25, 0.5),
        feat_dims: Sequence[int] = (32, 16),
        ci_scales: Sequence[float] = (1.0, 1.0),
        voxel_dim: int = 8,
        num_depth: Sequence[int] = (64, 8),
        inv_depth: Sequence[bool] = (True, False),
        nerf_hidden_dims: int = 64,
        viewdir_agg: bool = True,
    ):
        super().__init__()
        self.vol_levels = tuple(vol_levels)
        self.vol_scales = tuple(vol_scales)
        self.feat_scales = tuple(feat_scales)
        self.ci_scales = tuple(ci_scales)
        self.num_depth = tuple(num_depth)
        self.inv_depth = tuple(inv_depth)
        n = len(self.vol_levels)
        self.cost_regs = nn.ModuleList(
            [CostRegNetSmall(feat_dims[0], voxel_dim, base_channels)]
            + [CostRegNet(feat_dims[i], voxel_dim, base_channels) for i in range(1, n)]
        )
        self.nerfs = nn.ModuleList(
            [StageNeRF(nerf_hidden_dims, feat_dims[i], voxel_dim, viewdir_agg)
             for i in range(n - 1)]
        )

    def forward(self, src_hw, ms_feats, src_exts, src_ints, tar_exts, tar_ints, near_far):
        """Run the cascade.

        Args:
          src_hw: (H, W) of the source images.
          ms_feats: FPN levels [(B, V, c, h, w)], coarsest first, in the
            compute dtype.
          src_exts (B, V, 4, 4), src_ints (B, V, 3, 3), tar_exts (B, 4, 4),
          tar_ints (B, 3, 3), near_far (B, 2).

        Returns per-stage lists: depths (B, Hi, Wi); depth_ranges and
        vol_ranges (B, 2, Hi, Wi) metric; volumes (B, voxel, D, Hi, Wi).
        """
        H_orig, W_orig = src_hw
        out = {"depths": [], "depth_ranges": [], "vol_ranges": [], "volumes": []}
        depth_range = near_far[:, :, None, None]
        for idx in range(len(self.vol_levels)):
            feats = ms_feats[self.vol_levels[idx]]
            src_ints_stage = camera.scale_intrinsics(src_ints, self.feat_scales[idx])
            tar_ints_stage = camera.scale_intrinsics(tar_ints, self.vol_scales[idx])
            Hi = int(H_orig * self.vol_scales[idx])
            Wi = int(W_orig * self.vol_scales[idx])
            inv = bool(self.inv_depth[idx])
            dr = depth_range.expand(-1, 2, Hi, Wi)
            depth_values = cost_volume.get_depth_values(dr, self.num_depth[idx], inv)
            volume = cost_volume.build_cost_volume(
                feats, src_exts, src_ints_stage, tar_exts, tar_ints_stage, depth_values, inv
            )
            feat_volume, depth_prob = self.cost_regs[idx](volume)
            depth, ci = cost_volume.depth_regression(
                depth_values, depth_prob, self.ci_scales[idx], inv
            )
            first, last = depth_values[:, 0], depth_values[:, -1]
            vol_range = torch.stack([1.0 / first, 1.0 / last] if inv else [first, last], dim=1)
            out["depths"].append(depth)
            out["depth_ranges"].append(ci)
            out["vol_ranges"].append(vol_range)
            out["volumes"].append(feat_volume)
            depth_range = ci
            if idx < len(self.vol_levels) - 1:
                up = self.vol_scales[idx + 1] / self.vol_scales[idx]
                depth_range = resize_bilinear_nchw(ci, (int(Hi * up), int(Wi * up)))
        return out
