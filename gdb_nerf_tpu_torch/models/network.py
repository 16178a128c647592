"""Top-level GDB-NeRF network, eval forward: FPN -> MVS -> bundles -> decode.

Port of the eval branch of ``gdb_nerf_tpu/models/network.py::Network``.
Submodule and parameter names are the reference's torch names, so a
reference state dict (and the golden fixture's ``sd/*``) loads with
``load_state_dict(strict=True)``.

Dtypes: ``compute_dtype`` bfloat16 runs the feature path (FPN, cost-volume
features, U-Nets, encoded samples, NeRF head, decoder) in bf16, with that
path's conv and linear weights cast to bf16 once, when the network is
built; geometry, cost-volume moments, depth regression, compositing
weights, sigma and the decoder's final conv stay float32, as do the
BatchNorm parameters and statistics.  Tables that are bilinearly sampled (source images, mip pyramid,
volumes) are sampled in float32 from their bf16 values.

Layout at the boundary matches the JAX Network: the batch holds
channels-last images ``src_views.rgb`` (B, V, H, W, 3), and ``rgb`` comes
back as (B, H, W, 3).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn as nn

from gdb_nerf_tpu_torch.models.decoder_rdn import Decoder
from gdb_nerf_tpu_torch.models.depth_net import DepthNet
from gdb_nerf_tpu_torch.models.feature_net import FeatureNet
from gdb_nerf_tpu_torch.models.layers import cast_weights
from gdb_nerf_tpu_torch.models.nerf_head import BundleNeRF
from gdb_nerf_tpu_torch.ops import bundles, mip, render
from gdb_nerf_tpu_torch.ops.resize import resize_bilinear_nchw, resize_nearest


class Network(nn.Module):
    def __init__(
        self,
        fpn_base_channels: int = 8,
        fpn_feat_dims: Sequence[int] = (32, 16, 8),
        fpn_feat_scales: Sequence[float] = (0.25, 0.5, 1.0),
        mvs_vol_levels: Sequence[int] = (0, 1),
        mvs_vol_scales: Sequence[float] = (0.125, 0.5),
        mvs_ci_scales: Sequence[float] = (1.0, 1.0),
        mvs_voxel_dim: int = 8,
        mvs_num_depth: Sequence[int] = (64, 8),
        mvs_inv_depth: Sequence[bool] = (True, False),
        bundle_size: int = 2,
        global_num_depth: int = 64,
        max_num_samples: int = 6,
        max_mipmap_level: int = 3,
        nerf_hidden_dims: int = 64,
        is_adaptive: bool = False,
        viewdir_agg: bool = True,
        nerf_chunk_size: int = 1_000_000,
        dec_layers: int = 3,
        reweighting: bool = False,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        b = bundle_size
        if b <= 0 or b & (b - 1):
            raise ValueError("bundle_size must be a power of 2")
        self.bundle_size = b
        self.mvs_inv_depth = tuple(mvs_inv_depth)
        self.global_num_depth = global_num_depth
        self.max_num_samples = max_num_samples
        self.max_mipmap_level = max_mipmap_level
        self.is_adaptive = is_adaptive
        self.nerf_chunk_size = nerf_chunk_size
        self.reweighting = reweighting
        self.compute_dtype = compute_dtype
        # First FPN level whose scale reaches the bundle-grid resolution.
        lvl = 0
        while lvl < len(fpn_feat_scales) and fpn_feat_scales[lvl] < 1.0 / b:
            lvl += 1
        self.feat_level = lvl
        feat_dim = fpn_feat_dims[lvl]

        self.feature_net = FeatureNet(fpn_base_channels, fpn_feat_dims)
        self.depth_net = DepthNet(
            base_channels=fpn_base_channels,
            vol_levels=mvs_vol_levels,
            vol_scales=mvs_vol_scales,
            feat_scales=tuple(fpn_feat_scales[l] for l in mvs_vol_levels),
            feat_dims=tuple(fpn_feat_dims[l] for l in mvs_vol_levels),
            ci_scales=mvs_ci_scales,
            voxel_dim=mvs_voxel_dim,
            num_depth=mvs_num_depth,
            inv_depth=mvs_inv_depth,
            nerf_hidden_dims=nerf_hidden_dims,
            viewdir_agg=viewdir_agg,
        )
        self.nerf = BundleNeRF(nerf_hidden_dims, feat_dim, mvs_voxel_dim, viewdir_agg)
        self.upsampler = Decoder(feat_dim + 3 + mvs_voxel_dim, 3, 64, dec_layers, b)
        if compute_dtype != torch.float32:
            cast_weights(self, compute_dtype, keep=(self.nerf.sigma[0], self.upsampler.out_conv))

    @classmethod
    def from_config(cls, cfg: Any) -> "Network":
        """Build from a config namespace with fpn / mvs / nerf sections."""
        return cls(
            fpn_base_channels=cfg.fpn.base_channels,
            fpn_feat_dims=tuple(cfg.fpn.feat_dims),
            fpn_feat_scales=tuple(cfg.fpn.feat_scales),
            mvs_vol_levels=tuple(cfg.mvs.vol_levels),
            mvs_vol_scales=tuple(cfg.mvs.vol_scales),
            mvs_ci_scales=tuple(cfg.mvs.ci_scales),
            mvs_voxel_dim=cfg.mvs.voxel_dim,
            mvs_num_depth=tuple(cfg.mvs.num_depth),
            mvs_inv_depth=tuple(cfg.mvs.inv_depth),
            bundle_size=cfg.nerf.bundle_size,
            global_num_depth=cfg.nerf.global_num_depth,
            max_num_samples=cfg.nerf.max_num_samples,
            max_mipmap_level=cfg.nerf.max_mipmap_level,
            nerf_hidden_dims=cfg.nerf.nerf_hidden_dims,
            is_adaptive=cfg.nerf.is_adaptive,
            viewdir_agg=cfg.nerf.viewdir_agg,
            nerf_chunk_size=int(cfg.nerf.chunk_size),
            dec_layers=cfg.nerf.dec_layers,
            reweighting=cfg.nerf.reweighting,
            compute_dtype=getattr(torch, getattr(cfg, "compute_dtype", "float32")),
        )

    def num_chunks(self, H: int, W: int) -> int:
        """Row slabs the bundle grid renders in: the smallest divisor of H
        that keeps a slab at or under ``nerf_chunk_size`` bundles."""
        if not self.nerf_chunk_size or H * W <= self.nerf_chunk_size:
            return 1
        target = -(-H * W // self.nerf_chunk_size)
        for n in range(min(target, H), H + 1):
            if H % n == 0:
                return n
        return 1

    def forward(self, batch: dict):
        """Render the target view (eval).

        Args:
          batch: {'src_views': {'rgb': (B, V, H, W, 3), 'extrinsics':
            (B, V, 4, 4), 'intrinsics': (B, V, 3, 3)}, 'tar_views':
            {'extrinsics': (B, 4, 4), 'intrinsics': (B, 3, 3)},
            'near_far': (B, 2)}, float32 tensors on one device.

        Returns:
          ret: {'rgb': (B, H, W, 3), 'nerf_depth': (B, H, W), 'mvs_depth':
            (B, H/b, W/b), 'opacity': (B, H, W)}, float32.
          mvs_depths: the per-stage MVS depths.
        """
        b = self.bundle_size
        dt = self.compute_dtype
        src = batch["src_views"]
        src_images = src["rgb"]
        B, V, H_orig, W_orig, _ = src_images.shape
        src_exts, src_ints = src["extrinsics"], src["intrinsics"]
        tar_exts = batch["tar_views"]["extrinsics"]
        tar_ints = batch["tar_views"]["intrinsics"]
        near_far = batch["near_far"]
        src_nchw = src_images.reshape(B * V, H_orig, W_orig, 3).permute(0, 3, 1, 2)

        # 1. FPN over all source images.
        ms_feats = [
            f.reshape(B, V, *f.shape[1:]) for f in self.feature_net(src_nchw.to(dt))
        ]

        # 2. Cascaded MVS.
        mvs = self.depth_net(
            (H_orig, W_orig), ms_feats, src_exts, src_ints, tar_exts, tar_ints, near_far
        )
        depth_range = mvs["depth_ranges"][-1]
        vol_range = mvs["vol_ranges"][-1]
        feat_volume = mvs["volumes"][-1]
        mvs_depth = mvs["depths"][-1]

        # 3. Bundle grid and per-bundle depth windows.
        H, W = H_orig // b, W_orig // b
        if tuple(depth_range.shape[2:]) != (H, W):
            depth_range = resize_bilinear_nchw(depth_range, (H, W))
            vol_range = resize_bilinear_nchw(vol_range, (H, W))
            mvs_depth = resize_nearest(mvs_depth, (H, W))
        rb = bundles.make_ray_bundles(
            tar_exts, tar_ints, (H_orig, W_orig), near_far[:, 0], near_far[:, 1], b
        )
        inv = bool(self.mvs_inv_depth[-1])

        # 4. Source feature ++ rgb maps at bundle resolution and their mip
        # pyramid, shared by every row slab.
        img_feat = ms_feats[self.feat_level].reshape(B * V, -1, *ms_feats[self.feat_level].shape[-2:])
        img_feat = resize_bilinear_nchw(img_feat, (H, W))
        src_small = resize_bilinear_nchw(src_nchw, (H, W))
        tex = torch.cat([img_feat, src_small.to(img_feat.dtype)], dim=1).to(dt)
        pyramid = mip.build_pyramid(tex.float(), self.max_mipmap_level)

        # 5-6. Sample, encode, NeRF head, composite, per row slab.
        n_chunks = self.num_chunks(H, W)
        rows = H // n_chunks
        outs = []
        for ci in range(n_chunks):
            sl = slice(ci * rows, (ci + 1) * rows)
            rb_c = rb._replace(bundle_d=rb.bundle_d[:, sl], uv=rb.uv[sl], cos=rb.cos[:, sl])
            outs.append(self._render_rows(
                rb_c, depth_range[:, :, sl], vol_range[:, :, sl], src_images, pyramid,
                feat_volume, src_exts, src_ints, inv,
            ))
        feat_map, depth_map, opacity = (torch.cat(t, dim=1) for t in zip(*outs))
        nerf_depth = 1.0 / depth_map if inv else depth_map

        # 7. Decode: coarse RDN path + fine member-ray RGB.  The member-RGB
        # unpack is a pure permutation: member k = i*b + j of bundle (h, w)
        # is pixel (h*b + i, w*b + j).
        bsq = b * b
        rgb_f = feat_map[..., : bsq * 3].reshape(B, H, W, b, b * 3)
        rgb_f = rgb_f.permute(0, 1, 3, 2, 4).reshape(B, H_orig, W_orig, 3)
        rgb_c = self.upsampler(feat_map[..., bsq * 3:].permute(0, 3, 1, 2).to(dt))
        img = rgb_c.permute(0, 2, 3, 1) + rgb_f
        if self.reweighting:
            img = 0.5 * (img + rgb_f)
        maps = resize_bilinear_nchw(torch.stack([nerf_depth, opacity], dim=1), (H_orig, W_orig))
        ret = {"rgb": img, "nerf_depth": maps[:, 0], "mvs_depth": mvs_depth, "opacity": maps[:, 1]}
        return ret, mvs["depths"]

    def _render_rows(self, rb, depth_range, vol_range, src_images, pyramid, feat_volume,
                     src_exts, src_ints, inv):
        """Sample, encode, run the NeRF head and composite one slab of bundle
        rows.  Returns feat_map (B, Hc, W, C) float32, depth_map and opacity
        (B, Hc, W)."""
        dt = self.compute_dtype
        samples = bundles.sample_bundles(
            rb, depth_range, vol_range, self.max_num_samples, self.global_num_depth,
            inv, self.is_adaptive,
        )
        enc = bundles.encode_samples(
            rb, samples, src_images, pyramid, feat_volume.to(dt), src_exts, src_ints,
            self.max_mipmap_level,
        )
        B, V, Hc, W, S = enc.mip_feat.shape[:5]
        mip_feat = enc.mip_feat.to(dt)
        payload = torch.cat([enc.rgbs.reshape(B, V, Hc, W, S, -1).to(dt), mip_feat], dim=-1)
        frd = torch.cat([mip_feat, enc.ray_diff.to(dt)], dim=-1)

        # The head takes (V, N, C) with N = B*Hc*W*S samples.
        def per_view(t):
            return t.transpose(0, 1).reshape(V, B * Hc * W * S, t.shape[-1])

        sigma, feat = self.nerf(
            enc.vox_feat.reshape(-1, enc.vox_feat.shape[-1]).contiguous(),
            per_view(payload), per_view(frd),
        )
        sigma = sigma.reshape(B, Hc, W, S)
        feat = feat.reshape(B, Hc, W, S, -1)
        weights = render.weights_from_sigma(sigma, samples.valid)
        return render.composite(weights, feat, samples.z_vals)
