"""Cascaded plane-sweep MVS depth estimation.

Port of ``gdb_nerf_tpu/models/depth_net.py::DepthNet``: per stage a
variance cost volume over depth (or disparity) hypotheses, a 3D U-Net, and
a regressed depth with a confidence interval that seeds the next stage.
``vol_range`` values exchanged between stages are metric depth.  In
training every stage but the last also renders its full stage-resolution
image with a small NeRF (``nerfs``), so that depth is supervised
photometrically (``blend_rgbs``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from gdb_nerf_tpu_torch.models.cost_reg_net import CostRegNet, CostRegNetSmall
from gdb_nerf_tpu_torch.models.nerf_head import StageNeRF
from gdb_nerf_tpu_torch.ops import camera, cost_volume, render
from gdb_nerf_tpu_torch.ops.bundles import l2norm
from gdb_nerf_tpu_torch.ops.grid_sample import grid_sample_2d_nchw, grid_sample_3d_ncdhw
from gdb_nerf_tpu_torch.ops.resize import resize_bilinear_nchw
from gdb_nerf_tpu_torch.runtime.tracing import spanned


def _stage_sample_features(feat_volume, img_feat_rgb, world, uvd, src_exts, src_ints_stage,
                           tar_exts):
    """Voxel and per-view image features of the stage NeRF's samples.

    Args:
      feat_volume: (B, C, D, Hv, Wv) regularized volume.
      img_feat_rgb: (B, V, F, Hf, Wf) per-view feature ++ rgb maps, float32
        (bf16 features beside float32 rgb, as the JAX concat promotes them).
      world: (B, N, S, 3) sample positions; uvd: (B, N, S, 3) normalized
        volume coordinates.
      src_exts (B, V, 4, 4), src_ints_stage (B, V, 3, 3) at feature
        resolution; tar_exts (B, 4, 4).

    Returns vox_feat (B, N, S, C) and feat_rgb_dir (V, B, N, S, F + 4),
    float32: both tables are sampled in float32 (a bf16 volume from its
    bf16 values), and the stage NeRF casts them to its compute dtype.
    """
    B, V, _, Hf, Wf = img_feat_rgb.shape
    N, S = world.shape[1:3]
    vox_feat = grid_sample_3d_ncdhw(feat_volume.float(), uvd, padding_mode="border")
    tar_cam = camera.invert_extrinsics(tar_exts)[:, None, None, :3, 3]
    pts = world.reshape(B, N * S, 3)
    per_view = []
    for v in range(V):
        pix, depth, _ = camera.project_points(pts, src_exts[:, v], src_ints_stage[:, v])
        # Samples behind the camera are pushed far outside (border-clamped).
        bad = depth < 1e-8
        gx = torch.where(bad, -99.0, 2.0 * pix[..., 0] / Wf - 1.0)
        gy = torch.where(bad, -99.0, 2.0 * pix[..., 1] / Hf - 1.0)
        feats = grid_sample_2d_nchw(img_feat_rgb[:, v], torch.stack([gx, gy], dim=-1),
                                    padding_mode="border").reshape(B, N, S, -1)
        cam = camera.invert_extrinsics(src_exts[:, v])[:, None, None, :3, 3]
        tar_diff = l2norm(world - tar_cam)
        src_diff = l2norm(world - cam)
        direction = l2norm(tar_diff - src_diff)
        dot = (tar_diff * src_diff).sum(dim=-1, keepdim=True)
        per_view.append(torch.cat([feats, direction, dot], dim=-1))
    return vox_feat, torch.stack(per_view)


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
        num_samples: Sequence[int] = (8,),
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
        self.num_samples = tuple(num_samples)
        n = len(self.vol_levels)
        self.cost_regs = nn.ModuleList(
            [CostRegNetSmall(feat_dims[0], voxel_dim, base_channels)]
            + [CostRegNet(feat_dims[i], voxel_dim, base_channels) for i in range(1, n)]
        )
        self.nerfs = nn.ModuleList(
            [StageNeRF(nerf_hidden_dims, feat_dims[i], voxel_dim, viewdir_agg)
             for i in range(n - 1)]
        )

    def forward(self, src_images, ms_feats, src_exts, src_ints, tar_exts, tar_ints, near_far,
                train: bool = False):
        """Run the cascade.

        Args:
          src_images: (B, V, 3, H, W) source images.
          ms_feats: FPN levels [(B, V, c, h, w)], coarsest first, in the
            compute dtype.
          src_exts (B, V, 4, 4), src_ints (B, V, 3, 3), tar_exts (B, 4, 4),
          tar_ints (B, 3, 3), near_far (B, 2).
          train: render every stage but the last with its stage NeRF.

        Returns per-stage lists: depths (B, Hi, Wi); depth_ranges and
        vol_ranges (B, 2, Hi, Wi) metric; volumes (B, voxel, D, Hi, Wi);
        blend_rgbs (B, Hi, Wi, 3), the stage renders (train only, else []).
        """
        B, V, _, H_orig, W_orig = src_images.shape
        out = {"depths": [], "depth_ranges": [], "vol_ranges": [], "volumes": [],
               "blend_rgbs": []}
        depth_range = near_far[:, :, None, None]
        for idx in range(len(self.vol_levels)):
            depth_values, volume = self.stage_volume(
                idx, ms_feats, src_exts, src_ints, tar_exts, tar_ints, depth_range,
                (H_orig, W_orig))
            feat_volume, depth, ci, vol_range = self.stage_regularize(idx, volume, depth_values)
            out["depths"].append(depth)
            out["depth_ranges"].append(ci)
            out["vol_ranges"].append(vol_range)
            out["volumes"].append(feat_volume)
            if idx < len(self.vol_levels) - 1:
                if train:
                    feats = ms_feats[self.vol_levels[idx]]
                    hf, wf = feats.shape[-2:]
                    small = resize_bilinear_nchw(src_images.reshape(B * V, 3, H_orig, W_orig),
                                                 (hf, wf)).reshape(B, V, 3, hf, wf)
                    out["blend_rgbs"].append(self._render_stage(
                        idx, feat_volume, torch.cat([feats.float(), small], dim=2),
                        src_exts, camera.scale_intrinsics(src_ints, self.feat_scales[idx]),
                        tar_exts, camera.scale_intrinsics(tar_ints, self.vol_scales[idx]), ci,
                        vol_range,
                    ))
                depth_range = self.next_depth_range(idx, ci)
        return out

    @spanned("model.cost_volume")
    def stage_volume(self, idx, ms_feats, src_exts, src_ints, tar_exts, tar_ints, depth_range,
                     hw):
        """Stage ``idx``'s hypotheses (B, D, Hi, Wi) and its variance cost
        volume (B, C, D, Hi, Wi) inside ``depth_range`` (B, 2, Hi, Wi), or
        (B, 2, 1, 1) for the first stage; ``hw`` is the source image size."""
        Hi, Wi = int(hw[0] * self.vol_scales[idx]), int(hw[1] * self.vol_scales[idx])
        inv = bool(self.inv_depth[idx])
        dr = depth_range.expand(-1, 2, Hi, Wi)
        depth_values = cost_volume.get_depth_values(dr, self.num_depth[idx], inv)
        volume = cost_volume.build_cost_volume(
            ms_feats[self.vol_levels[idx]], src_exts,
            camera.scale_intrinsics(src_ints, self.feat_scales[idx]), tar_exts,
            camera.scale_intrinsics(tar_ints, self.vol_scales[idx]), depth_values, inv,
        )
        return depth_values, volume

    @spanned("model.cost_reg")
    def stage_regularize(self, idx, volume, depth_values):
        """Stage ``idx``'s U-Net over ``volume`` and the depth it regresses:
        feat_volume (B, voxel, D, Hi, Wi), depth (B, Hi, Wi), ci and vol_range
        (B, 2, Hi, Wi) metric."""
        inv = bool(self.inv_depth[idx])
        feat_volume, depth_prob = self.cost_regs[idx](volume)
        depth, ci = cost_volume.depth_regression(
            depth_values, depth_prob, self.ci_scales[idx], inv
        )
        first, last = depth_values[:, 0], depth_values[:, -1]
        vol_range = torch.stack([1.0 / first, 1.0 / last] if inv else [first, last], dim=1)
        return feat_volume, depth, ci, vol_range

    def next_depth_range(self, idx, ci):
        """Stage ``idx``'s interval ``ci`` resized to the next stage's grid."""
        Hi, Wi = ci.shape[-2:]
        up = self.vol_scales[idx + 1] / self.vol_scales[idx]
        return resize_bilinear_nchw(ci, (int(Hi * up), int(Wi * up)))

    def _render_stage(self, idx, feat_volume, img_feat_rgb, src_exts, src_ints_stage, tar_exts,
                      tar_ints_stage, ci, vol_range):
        """The stage-resolution image (B, Hi, Wi, 3) rendered by stage NeRF
        ``idx``: S uniform samples inside each pixel's interval ``ci``, the
        voxel and image features at them, and unnormalized alpha compositing."""
        B, _, Hi, Wi = ci.shape
        S = self.num_samples[idx]
        inv = bool(self.inv_depth[idx])
        rays_o, rays_d, _, _ = camera.build_rays(tar_exts, tar_ints_stage, Hi, Wi)
        ray_near, ray_far = ci[:, 0].reshape(B, -1), ci[:, 1].reshape(B, -1)
        vol_near, vol_far = vol_range[:, 0].reshape(B, -1), vol_range[:, 1].reshape(B, -1)
        if inv:
            ray_near, ray_far = 1.0 / ray_far, 1.0 / ray_near
            vol_near, vol_far = 1.0 / vol_near, 1.0 / vol_far
        steps = cost_volume.unit_steps(S + 1, ci.device, ci.dtype)
        t_vals = ray_near[..., None] + (ray_far - ray_near)[..., None] * steps
        z_vals = 0.5 * (t_vals[..., :-1] + t_vals[..., 1:])  # (B, N, S)
        d = 2.0 * (z_vals - vol_near[..., None]) / (vol_far - vol_near)[..., None] - 1.0
        x, y = camera.pixel_centers(Hi, Wi, ci.device, ci.dtype)
        uv = torch.stack([(2.0 * x / Wi - 1.0).reshape(-1), (2.0 * y / Hi - 1.0).reshape(-1)], -1)
        uvd = torch.cat([uv[None, :, None].expand(B, Hi * Wi, S, 2), d[..., None]], dim=-1)
        z_metric = 1.0 / z_vals if inv else z_vals
        world = rays_o[:, None, None] + rays_d.reshape(B, -1, 1, 3) * z_metric[..., None]
        vox_feat, feat_rgb_dir = _stage_sample_features(
            feat_volume, img_feat_rgb, world, uvd, src_exts, src_ints_stage, tar_exts)
        sigma, rgb = self.nerfs[idx](vox_feat, feat_rgb_dir)
        alpha = 1.0 - torch.exp(-sigma)  # (B, N, S)
        rgb_map = ((alpha * render.transmittance(alpha))[..., None] * rgb).sum(dim=-2)
        return rgb_map.reshape(B, Hi, Wi, 3)
