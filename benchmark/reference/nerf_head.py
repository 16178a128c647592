"""Per-sample NeRF heads with IBRNet-style multi-view aggregation, plain torch.

Parameters keep the published torch names and the concat-linear form
(``global_fc.0`` over [per-view, var, mean], ``weight.0`` over [x, vox, img,
per-view]).  ``BundleNeRF`` is the bundle head as plain layers, in eval and
in training alike: the measured program runs a fused CUDA kernel in its
place at eval, and this is what that kernel has to compute.  ``StageNeRF``
is the training-only head of the MVS cascade's stage renders.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F



class ViewAggregator(nn.Module):
    """Aggregation trunk: (V, ..., F + 4) [feature ++ rgb ++ ray-diff] -> (..., 16)."""

    def __init__(self, feat_dim: int, viewdir_agg: bool = True):
        super().__init__()
        F = feat_dim + 3
        self.feat_rgb_dim = F
        if viewdir_agg:
            self.view_fc = nn.Sequential(nn.Linear(4, F), nn.ReLU())
        self.global_fc = nn.Sequential(nn.Linear(F * 3, 32), nn.ReLU())
        self.agg_w_fc = nn.Sequential(nn.Linear(32, 1), nn.ReLU())
        self.fc = nn.Sequential(nn.Linear(32, 16), nn.ReLU())

    def aggregate(self, feat_rgb_dir: torch.Tensor) -> torch.Tensor:
        F = self.feat_rgb_dim
        x = feat_rgb_dir[..., :-4]
        if hasattr(self, "view_fc"):
            x = x + self.view_fc(feat_rgb_dir[..., -4:])
        mean = x.mean(dim=0)
        var = torch.square(x - mean).sum(dim=0) / max(x.shape[0] - 1, 1)  # unbiased
        # Split matmul of cat([per-view, var, mean]): the var/mean half is
        # shared across views.
        w, b = self.global_fc[0].weight, self.global_fc[0].bias
        shared = torch.nn.functional.linear(var, w[:, F:2 * F]) + torch.nn.functional.linear(
            mean, w[:, 2 * F:], b
        )
        gf = torch.relu(torch.nn.functional.linear(x, w[:, :F]) + shared)
        wv = torch.softmax(self.agg_w_fc(gf), dim=0)
        return self.fc((gf * wv).sum(dim=0))


class BundleNeRF(ViewAggregator):
    """Density + payload-blending head, evaluated once per bundle sample."""

    def __init__(self, hid_dim: int = 64, feat_dim: int = 16, voxel_dim: int = 8,
                 viewdir_agg: bool = True):
        super().__init__(feat_dim, viewdir_agg)
        F = feat_dim + 3
        self.hid_dim = hid_dim
        self.voxel_dim = voxel_dim
        self.lr0 = nn.Sequential(nn.Linear(voxel_dim + 16, hid_dim), nn.ReLU())
        self.sigma = nn.Sequential(nn.Linear(hid_dim, 1), nn.Softplus())
        self.weight = nn.Sequential(
            nn.Linear(hid_dim + voxel_dim + 16 + F + 4, hid_dim), nn.ReLU(),
            nn.Linear(hid_dim, 1), nn.ReLU(),
        )
        self.feat_head = nn.Sequential(nn.Linear(hid_dim, voxel_dim), nn.ReLU())

    def forward(self, vox: torch.Tensor, payload: torch.Tensor, frd: torch.Tensor,
                train: bool = False):
        """Args: vox (N, voxel_dim); payload (V, N, P); frd (V, N, F + 4).
        Returns sigma (N,) and feat (N, P + voxel_dim); ``train`` changes
        nothing here."""
        dt = payload.dtype
        img_feat = self.aggregate(frd)
        vox_img = torch.cat([vox, img_feat], dim=-1)
        x = self.lr0(vox_img)
        sigma = self.sigma(x.float())[..., 0]
        n_shared = x.shape[-1] + vox_img.shape[-1]
        w0 = self.weight[0].weight
        shared = F.linear(torch.cat([x, vox_img], dim=-1), w0[:, :n_shared], self.weight[0].bias)
        h = torch.relu(shared + F.linear(frd, w0[:, n_shared:]))
        w = self.weight[3](self.weight[2](h))
        w = torch.softmax(w.float(), dim=0).to(dt)
        blended = (payload * w).sum(dim=0)
        return sigma, torch.cat([blended, self.feat_head(x)], dim=-1)


class StageNeRF(ViewAggregator):
    """The training-only RGB head that supervises an intermediate MVS stage.

    Port of ``gdb_nerf_tpu/models/nerf_head.py::StageNeRF``: the aggregation
    trunk, density, and softmax view weights (``color`` over [x, vox, img,
    per-view]) that blend the per-view RGB.
    """

    def __init__(self, hid_dim: int = 64, feat_dim: int = 32, voxel_dim: int = 8,
                 viewdir_agg: bool = True):
        super().__init__(feat_dim, viewdir_agg)
        F = feat_dim + 3
        self.lr0 = nn.Sequential(nn.Linear(voxel_dim + 16, hid_dim), nn.ReLU())
        self.sigma = nn.Sequential(nn.Linear(hid_dim, 1), nn.Softplus())
        self.color = nn.Sequential(
            nn.Linear(hid_dim + voxel_dim + 16 + F + 4, hid_dim), nn.ReLU(),
            nn.Linear(hid_dim, 1), nn.ReLU(),
        )

    def forward(self, vox: torch.Tensor, feat_rgb_dir: torch.Tensor):
        """Args: vox (..., voxel_dim); feat_rgb_dir (V, ..., F + 4), any
        float dtype: both are cast to the head's weights' dtype, as the JAX
        head casts them to its compute dtype.  Density (its layer kept
        float32), the softmax over views and the RGB blend run in float32.
        Returns sigma (...,) and rgb (..., 3), float32."""
        dt = self.lr0[0].weight.dtype
        vox, feat_rgb_dir = vox.to(dt), feat_rgb_dir.to(dt)
        img_feat = self.aggregate(feat_rgb_dir)
        vox_img = torch.cat([vox, img_feat], dim=-1)
        x = self.lr0(vox_img)
        sigma = self.sigma(x.float())[..., 0]
        # color.0 over cat([x, vox_img] (shared), frd (per view)), split.
        n_shared = x.shape[-1] + vox_img.shape[-1]
        w0 = self.color[0].weight
        shared = F.linear(torch.cat([x, vox_img], dim=-1), w0[:, :n_shared], self.color[0].bias)
        h = torch.relu(shared + F.linear(feat_rgb_dir, w0[:, n_shared:]))
        w = torch.softmax(self.color[3](self.color[2](h)).float(), dim=0)
        return sigma, (feat_rgb_dir[..., -7:-4].float() * w).sum(dim=0)
