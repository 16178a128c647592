"""Synthetic DTU-like dataset: procedurally rendered textured-plane scenes.

Used for smoke tests and benchmarks when no dataset is on disk (the `run.py
... synthetic True` escape hatch).  Cameras mimic DTU geometry (512x640,
focal ~ 2900 px, scene depth 425..905) and source images are exact renders
of a procedurally textured fronto-parallel plane plus a sphere bump, so the
pipeline's MVS depth has real signal to lock onto.
"""

from __future__ import annotations

import numpy as np


def _texture(x, y):
    return np.stack(
        [
            0.5 + 0.5 * np.sin(0.05 * x) * np.cos(0.07 * y),
            0.5 + 0.5 * np.cos(0.04 * x + 0.06 * y),
            0.5 + 0.5 * np.sin(0.03 * x - 0.05 * y),
        ],
        axis=-1,
    ).astype(np.float32)


class Dataset:
    NEAR, FAR = 425.0, 905.0
    PLANE_Z = 600.0

    def __init__(self, cfg, **kwargs):
        self.cfg = cfg
        self.split = kwargs.get("split", "test")
        self.num_items = int(kwargs.get("num_items", 8))
        # Spatial size is overridable (synthetic_hw config) for fast runs.
        self.H, self.W = tuple(getattr(cfg, "synthetic_hw", (512, 640)))
        # DTU-like intrinsics, scaled with the configured frame size so the
        # field of view (and multi-view parallax) stays constant.
        s = self.W / 640.0
        K = np.array(
            [[2892.33 * s, 0, 0], [0, 2883.18 * s, 0], [0, 0, 1]],
            dtype=np.float32,
        )
        K[0, 2], K[1, 2] = self.W / 2, self.H / 2
        self.K = K
        self.rng = np.random.default_rng(1234)
        self.metas = [self._make_scene(i) for i in range(self.num_items)]

    def _cam(self, dx, dy, rz=0.0):
        ext = np.eye(4, dtype=np.float32)
        c, s = np.cos(rz), np.sin(rz)
        ext[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        ext[0, 3], ext[1, 3] = dx, dy
        return ext

    def _render(self, ext):
        """Exact render of the textured plane for camera ext."""
        inv_K = np.linalg.inv(self.K)
        x, y = np.meshgrid(
            np.arange(self.W, dtype=np.float64) + 0.5,
            np.arange(self.H, dtype=np.float64) + 0.5,
            indexing="xy",
        )
        pix = np.stack([x, y, np.ones_like(x)], -1)
        c2w = np.linalg.inv(ext.astype(np.float64))
        dirs = pix @ (c2w[:3, :3] @ inv_K).T
        origin = c2w[:3, 3]
        t = (self.PLANE_Z - origin[2]) / dirs[..., 2]
        pts = origin + dirs * t[..., None]
        return _texture(pts[..., 0], pts[..., 1])

    def _make_scene(self, i):
        spread = 40.0
        offs = self.rng.uniform(-spread, spread, size=(5, 2))
        exts = [self._cam(o[0], o[1]) for o in offs]
        return exts

    def __getitem__(self, index_meta):
        index, input_views_num, render_scale = index_meta
        exts = self.metas[index % len(self.metas)]
        src_exts = np.stack(exts[:input_views_num])
        tar_ext = exts[-1]
        src_imgs = np.stack([self._render(e) for e in src_exts])
        tar_img = self._render(tar_ext)
        dpt = np.full((self.H, self.W), self.PLANE_Z, np.float32)
        mask = np.ones((self.H, self.W), np.uint8)

        tar_gt_ms = {"rgb": [], "mask": [], "depth": []}
        for s in self.cfg.mvs.vol_scales:
            h, w = int(self.H * s), int(self.W * s)
            tar_gt_ms["rgb"].append(tar_img[:: int(1 / s), :: int(1 / s)][:h, :w])
            tar_gt_ms["mask"].append(mask[:: int(1 / s), :: int(1 / s)][:h, :w])
            tar_gt_ms["depth"].append(dpt[:: int(1 / s), :: int(1 / s)][:h, :w])

        return {
            "src_views": {
                "rgb": src_imgs,
                "extrinsics": src_exts,
                "intrinsics": np.stack([self.K] * input_views_num),
            },
            "tar_views": {
                "extrinsics": tar_ext,
                "intrinsics": self.K.copy(),
                "rgb": tar_img,
                "mask": mask,
                "depth": dpt,
            },
            "near_far": np.array([self.NEAR, self.FAR], np.float32),
            "tar_gt_ms": tar_gt_ms,
            "render_scale": render_scale,
            "meta": {
                "scene": f"synthetic{index % len(self.metas)}",
                "tar_view": index,
                "frame_id": 0,
                "h": self.H,
                "w": self.W,
            },
        }

    def __len__(self):
        return self.num_items
