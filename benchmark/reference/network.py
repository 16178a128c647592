"""The GDB-NeRF network in plain float32 torch: FPN -> MVS -> bundles -> decode.

A frozen copy of the measured program's forward with its CUDA kernel (the
bundle head) replaced by plain layers, its bf16 casts, row sharding and
debug outputs taken out.  Submodule and parameter names are the published
torch names, so the state dict that the benchmark makes from the seed loads
into both with ``load_state_dict(strict=True)``.

``forward(batch, train)``: ``train`` renders the MVS stages with their stage
NeRFs (for the stage losses); BatchNorm follows the module's mode.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import torch
import torch.nn as nn

from benchmark.reference.decoder_rdn import Decoder
from benchmark.reference.depth_net import DepthNet
from benchmark.reference.feature_net import FeatureNet
from benchmark.reference.nerf_head import BundleNeRF
from benchmark.reference import bundles, mip, render
from benchmark.reference.resize import resize_bilinear_nchw, resize_nearest


class Frame(NamedTuple):
    """A request's tensors as the stages read them."""

    src_images: torch.Tensor  # (B, V, H, W, 3) channels-last source images
    src_nchw: torch.Tensor  # (B*V, 3, H, W) the same, NCHW
    src_exts: torch.Tensor  # (B, V, 4, 4)
    src_ints: torch.Tensor  # (B, V, 3, 3)
    tar_exts: torch.Tensor  # (B, 4, 4)
    tar_ints: torch.Tensor  # (B, 3, 3)
    near_far: torch.Tensor  # (B, 2)


class Windows(NamedTuple):
    """Stage 3's output: the bundles and the last MVS stage at bundle
    resolution (H/b, W/b)."""

    rb: bundles.RayBundle
    depth_range: torch.Tensor  # (B, 2, H/b, W/b) metric
    vol_range: torch.Tensor  # (B, 2, H/b, W/b) metric
    feat_volume: torch.Tensor  # (B, voxel, D, Hv, Wv)
    mvs_depth: torch.Tensor  # (B, H/b, W/b)


class Slab(NamedTuple):
    """One slab of bundle rows that stages 5-6 render at once."""

    rb: bundles.RayBundle
    depth_range: torch.Tensor
    vol_range: torch.Tensor
    feat_volume: torch.Tensor


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
        mvs_num_samples: Sequence[int] = (8,),
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
        self.compute_dtype = torch.float32
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
            num_samples=mvs_num_samples,
            nerf_hidden_dims=nerf_hidden_dims,
            viewdir_agg=viewdir_agg,
        )
        self.nerf = BundleNeRF(nerf_hidden_dims, feat_dim, mvs_voxel_dim, viewdir_agg)
        self.upsampler = Decoder(feat_dim + 3 + mvs_voxel_dim, 3, 64, dec_layers, b)

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
            mvs_num_samples=tuple(cfg.mvs.num_samples),
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

    def forward(self, batch: dict, train: bool = False):
        """Render the target view.

        Args:
          batch: {'src_views': {'rgb': (B, V, H, W, 3), 'extrinsics':
            (B, V, 4, 4), 'intrinsics': (B, V, 3, 3)}, 'tar_views':
            {'extrinsics': (B, 4, 4), 'intrinsics': (B, 3, 3)},
            'near_far': (B, 2)}, float32 tensors on one device.
          train: stage-NeRF renders and the differentiable head.

        Returns:
          ret: {'rgb': (B, H, W, 3), 'nerf_depth': (B, H, W), 'mvs_depth':
            (B, H/b, W/b), 'opacity': (B, H, W)}, float32.
          mvs_depths: the per-stage MVS depths.
          blend_rgbs: the per-stage stage-NeRF renders (B, Hi, Wi, 3), train
            only, else [].
        """
        frame = self.frame(batch)
        B, V, H_orig, W_orig, _ = frame.src_images.shape
        # 1. FPN over all source images.
        ms_feats = self.features(frame)
        # 2. Cascaded MVS.
        mvs = self.depth_net(
            frame.src_nchw.reshape(B, V, 3, H_orig, W_orig), ms_feats, frame.src_exts,
            frame.src_ints, frame.tar_exts, frame.tar_ints, frame.near_far, train,
        )
        # 3. Bundle grid and per-bundle depth windows.
        windows = self.bundle_windows(frame, mvs)
        # 4. Source feature ++ rgb maps at bundle resolution and their mip
        # pyramid, shared by every row slab.
        pyramid = self.texture_pyramid(frame, ms_feats)
        # 5-6. Sample, encode, NeRF head, composite, per row slab.
        outs = [self._render_rows(frame, slab, pyramid, train)
                for slab in self.slabs(windows, 0, H_orig // self.bundle_size)]
        # 7. Decode.
        ret = self.decode(frame, windows, outs)
        return ret, mvs["depths"], mvs["blend_rgbs"]

    def frame(self, batch: dict) -> Frame:
        """The request's tensors that the stages read (see ``forward``)."""
        src = batch["src_views"]
        src_images = src["rgb"]
        B, V, H, W, _ = src_images.shape
        src_nchw = src_images.reshape(B * V, H, W, 3).permute(0, 3, 1, 2)
        return Frame(src_images, src_nchw, src["extrinsics"], src["intrinsics"],
                     batch["tar_views"]["extrinsics"], batch["tar_views"]["intrinsics"],
                     batch["near_far"])

    def features(self, frame: Frame) -> list[torch.Tensor]:
        """Stage 1: the FPN levels [(B, V, c, h, w)], coarsest first, in the
        compute dtype."""
        B, V = frame.src_images.shape[:2]
        return [f.reshape(B, V, *f.shape[1:])
                for f in self.feature_net(frame.src_nchw.to(self.compute_dtype))]

    def bundle_windows(self, frame: Frame, mvs: dict) -> Windows:
        """Stage 3: the ray bundles and the last MVS stage's depth windows,
        volume and depth at bundle resolution."""
        b = self.bundle_size
        H_orig, W_orig = frame.src_images.shape[2:4]
        depth_range = mvs["depth_ranges"][-1]
        vol_range = mvs["vol_ranges"][-1]
        mvs_depth = mvs["depths"][-1]
        H, W = H_orig // b, W_orig // b
        if tuple(depth_range.shape[2:]) != (H, W):
            depth_range = resize_bilinear_nchw(depth_range, (H, W))
            vol_range = resize_bilinear_nchw(vol_range, (H, W))
            mvs_depth = resize_nearest(mvs_depth, (H, W))
        rb = bundles.make_ray_bundles(frame.tar_exts, frame.tar_ints, (H_orig, W_orig),
                                      frame.near_far[:, 0], frame.near_far[:, 1], b)
        return Windows(rb, depth_range, vol_range, mvs["volumes"][-1], mvs_depth)

    def texture_pyramid(self, frame: Frame, ms_feats: list) -> list[torch.Tensor]:
        """Stage 4: the mip pyramid of the (B*V, F, H/b, W/b) source feature
        ++ rgb maps, float32 from compute-dtype values."""
        b = self.bundle_size
        H, W = frame.src_images.shape[2] // b, frame.src_images.shape[3] // b
        feat = ms_feats[self.feat_level]
        img_feat = resize_bilinear_nchw(feat.reshape(-1, *feat.shape[-3:]), (H, W))
        src_small = resize_bilinear_nchw(frame.src_nchw, (H, W))
        tex = torch.cat([img_feat, src_small.to(img_feat.dtype)], dim=1).to(self.compute_dtype)
        return mip.build_pyramid(tex.float(), self.max_mipmap_level)

    def slabs(self, windows: Windows, first: int, rows: int) -> list[Slab]:
        """The row slabs of bundle rows [first, first + rows) that stages 5-6
        render one at a time (``num_chunks``)."""
        rb = windows.rb
        n_chunks = self.num_chunks(rows, rb.uv.shape[1])
        step = rows // n_chunks
        out = []
        for ci in range(n_chunks):
            sl = slice(first + ci * step, first + (ci + 1) * step)
            out.append(Slab(rb._replace(bundle_d=rb.bundle_d[:, sl], uv=rb.uv[sl],
                                        cos=rb.cos[:, sl]),
                            windows.depth_range[:, :, sl], windows.vol_range[:, :, sl],
                            windows.feat_volume))
        return out

    def sample(self, slab: Slab) -> bundles.BundleSamples:
        """Stage 5a: a slab's samples inside its depth windows."""
        return bundles.sample_bundles(
            slab.rb, slab.depth_range, slab.vol_range, self.max_num_samples,
            self.global_num_depth, bool(self.mvs_inv_depth[-1]), self.is_adaptive,
        )

    def encode(self, frame: Frame, slab: Slab, samples, pyramid) -> bundles.EncodedSamples:
        """Stage 5b: the samples' features from the source views and the
        volume."""
        return bundles.encode_samples(
            slab.rb, samples, frame.src_images, pyramid, slab.feat_volume.to(self.compute_dtype),
            frame.src_exts, frame.src_ints, self.max_mipmap_level,
        )

    def head_composite(self, samples, enc, train: bool = False) -> tuple:
        """Stage 6: the NeRF head on every sample and the composite along
        each bundle.  Returns feat_map (B, Hc, W, C) float32, depth_map and
        opacity (B, Hc, W)."""
        dt = self.compute_dtype
        B, V, Hc, W, S = enc.mip_feat.shape[:5]
        mip_feat = enc.mip_feat.to(dt)
        payload = torch.cat([enc.rgbs.reshape(B, V, Hc, W, S, -1).to(dt), mip_feat], dim=-1)
        frd = torch.cat([mip_feat, enc.ray_diff.to(dt)], dim=-1)

        # The head takes (V, N, C) with N = B*Hc*W*S samples.
        def per_view(t):
            return t.transpose(0, 1).reshape(V, B * Hc * W * S, t.shape[-1])

        sigma, feat = self.nerf(
            enc.vox_feat.reshape(-1, enc.vox_feat.shape[-1]).contiguous(),
            per_view(payload), per_view(frd), train,
        )
        sigma = sigma.reshape(B, Hc, W, S)
        feat = feat.reshape(B, Hc, W, S, -1)
        weights = render.weights_from_sigma(sigma, samples.valid)
        return render.composite(weights, feat, samples.z_vals)

    def decode(self, frame: Frame, windows: Windows, outs: list) -> dict:
        """Stage 7: the slabs' bundle maps joined, the RDN's coarse path plus the member rays' RGB, and the
        depth and opacity maps at full resolution -> ret (see ``forward``)."""
        b = self.bundle_size
        B, _, H_orig, W_orig, _ = frame.src_images.shape
        H, W = H_orig // b, W_orig // b
        bundle_maps = [torch.cat(t, dim=1) for t in zip(*outs)]
        feat_map, depth_map, opacity = bundle_maps[:3]
        nerf_depth = 1.0 / depth_map if self.mvs_inv_depth[-1] else depth_map
        # The member-RGB unpack is a pure permutation: member k = i*b + j of
        # bundle (h, w) is pixel (h*b + i, w*b + j).
        bsq = b * b
        rgb_f = feat_map[..., : bsq * 3].reshape(B, H, W, b, b * 3)
        rgb_f = rgb_f.permute(0, 1, 3, 2, 4).reshape(B, H_orig, W_orig, 3)
        rgb_c = self.upsampler(feat_map[..., bsq * 3:].permute(0, 3, 1, 2).to(self.compute_dtype))
        img = rgb_c.permute(0, 2, 3, 1) + rgb_f
        if self.reweighting:
            img = 0.5 * (img + rgb_f)
        maps = resize_bilinear_nchw(torch.stack([nerf_depth, opacity], dim=1), (H_orig, W_orig))
        ret = {"rgb": img, "nerf_depth": maps[:, 0], "mvs_depth": windows.mvs_depth,
               "opacity": maps[:, 1]}
        return ret

    def _render_rows(self, frame: Frame, slab: Slab, pyramid, train: bool) -> tuple:
        """Stages 5-6 on one slab of bundle rows (``head_composite``'s
        outputs)."""
        samples = self.sample(slab)
        return self.head_composite(samples, self.encode(frame, slab, samples, pyramid), train)
