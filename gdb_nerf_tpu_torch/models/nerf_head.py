"""Per-sample NeRF heads with IBRNet-style multi-view aggregation.

Port of ``gdb_nerf_tpu/models/nerf_head.py``.  Parameters keep the
reference's torch names and its concat-linear form (``global_fc.0`` over
[per-view, var, mean], ``weight.0`` over [x, vox, img, per-view]); the JAX
module's split denses are column blocks of these weights.  The names sit
flat on the head (``nerf.view_fc.0.weight``), so ``ViewAggregator`` is the
base class that owns the aggregation trunk.

``BundleNeRF.forward`` goes through ``kernels.bundle_head``: the hand-written
CUDA kernel for CUDA tensors, its plain PyTorch version for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gdb_nerf_tpu_torch.kernels.bundle_head import BundleHeadKernel, pack_weights


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
        self.kernel = BundleHeadKernel()
        self._packed: tuple | None = None

    def packed_weights(self) -> torch.Tensor:
        """The head's weights packed for the CUDA kernel (float32, on the
        head's device).  Packed once and reused until a parameter changes
        (a load_state_dict or an in-place update bumps its version)."""
        params = list(self.parameters())
        key = tuple((p.device, p.data_ptr(), p._version) for p in params)
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, pack_weights(self))
        return self._packed[1]

    def forward(self, vox: torch.Tensor, payload: torch.Tensor, feat_rgb_dir: torch.Tensor):
        """Args: vox (N, voxel_dim); payload (V, N, P); feat_rgb_dir (V, N, F + 4),
        all in one dtype.  Returns sigma (N,) float32 and feat (N, P + voxel_dim)
        in the inputs' dtype."""
        return self.kernel(self, vox, payload, feat_rgb_dir)


class StageNeRF(ViewAggregator):
    """The training-only stage NeRF of the MVS cascade.

    Declared so that reference checkpoints load strictly; its forward comes
    with the training path.
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
