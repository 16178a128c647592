"""LPIPS-VGG perceptual metric in PyTorch.

Port of ``gdb_nerf_tpu/eval/lpips.py``, the architecture of the
``lpips.LPIPS(net='vgg')`` metric that the reference evaluator uses: the
shift/scale layer, VGG16 features at the 5 standard taps (relu1_2, relu2_2,
relu3_3, relu4_3, relu5_3: blocks of 2, 2, 3, 3 and 3 3x3 convs + ReLU, a
2x2 max-pool after each block but the last), unit-normalized along
channels, squared difference, nonnegative 1x1 linear heads, spatial
average, summed over taps.

Weights come from the JAX package's ``.npz`` (``tools/export_lpips.py``)
at ``$workspace/weights/lpips_vgg.npz``, with the same keys: ``conv{i}_w``
as HWIO (3, 3, Cin, Cout), turned into torch's OIHW here, ``conv{i}_b`` and
``lin{i}_w``.  ``LPIPS.load_default`` raises FileNotFoundError when the
file is absent.  The convs run in float32 with TF32 off.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

# 3x3 convs per VGG16 block; a tap after each block.
_VGG_BLOCKS = (2, 2, 3, 3, 3)

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LPIPS:
    def __init__(self, weights: dict, device="cpu"):
        """``weights``: the JAX module's dict of numpy arrays, unchanged."""
        self.device = torch.device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

        n_convs = sum(_VGG_BLOCKS)
        self.conv_w = [t(weights[f"conv{i}_w"]).permute(3, 2, 0, 1).contiguous()
                       for i in range(n_convs)]
        self.conv_b = [t(weights[f"conv{i}_b"]) for i in range(n_convs)]
        self.lin_w = [t(weights[f"lin{i}_w"]).view(1, -1, 1, 1) for i in range(len(_VGG_BLOCKS))]
        self.shift = t(_SHIFT).view(1, 3, 1, 1)
        self.scale = t(_SCALE).view(1, 3, 1, 1)

    @classmethod
    def load_default(cls, device="cpu") -> "LPIPS":
        ws = os.environ.get("workspace", os.path.join(os.getcwd(), "workspace"))
        path = os.path.join(ws, "weights", "lpips_vgg.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"LPIPS weights not found at {path}; "
                "generate with tools/export_lpips.py"
            )
        with np.load(path) as f:
            return cls(dict(f), device)

    def _vgg_features(self, h: torch.Tensor) -> list[torch.Tensor]:
        """h: (N, 3, H, W) in [-1, 1] -> the 5 tap activations."""
        h = (h - self.shift) / self.scale
        taps, li = [], 0
        for bi, n in enumerate(_VGG_BLOCKS):
            for _ in range(n):
                h = F.relu(F.conv2d(h, self.conv_w[li], self.conv_b[li], padding=1))
                li += 1
            taps.append(h)
            if bi < len(_VGG_BLOCKS) - 1:
                h = F.max_pool2d(h, 2, 2)
        return taps

    def distance(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a, b: (N, 3, H, W) float32 on the module's device, in [-1, 1] ->
        the metric, a 0-dim tensor (averaged over N and space)."""
        tf32 = torch.backends.cudnn.allow_tf32  # the switch the Renderer sets
        torch.backends.cudnn.allow_tf32 = False
        try:
            fa, fb = self._vgg_features(a), self._vgg_features(b)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        total = torch.zeros((), device=self.device)
        for xa, xb, lin in zip(fa, fb, self.lin_w):
            na = xa / xa.norm(dim=1, keepdim=True).clamp_min(1e-10)
            nb = xb / xb.norm(dim=1, keepdim=True).clamp_min(1e-10)
            total = total + ((na - nb).square() * lin).sum(dim=1).mean()
        return total

    def __call__(self, a, b) -> float:
        """a, b: (H, W, 3) images in [-1, 1] (numpy arrays or tensors)."""

        def nchw(x):
            return torch.as_tensor(x, dtype=torch.float32, device=self.device).permute(2, 0, 1)[None]

        with torch.inference_mode():
            return float(self.distance(nchw(a), nchw(b)))
