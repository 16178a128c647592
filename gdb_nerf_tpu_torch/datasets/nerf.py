"""NeRF-Synthetic (Blender) dataset reader.

Behavior-equivalent of the reference loader
(the reference's datasets/dataloader/nerf.py): `transforms_train.json`
poses converted Blender->CV via diag(1,-1,-1,1), 800x800 images with focal
from `camera_angle_x`, white-background alpha compositing
``rgb * a + (1 - a)``, fixed near/far [2.5, 5.5].  Channels-last float32.
"""

from __future__ import annotations

import json
import os

import numpy as np

from gdb_nerf_tpu_torch.datasets.imageio import load_rgb

PAIRS_FILE = "data/mvsnerf/pairs.json"
ALL_SCENES = ["chair", "drums", "ficus", "hotdog", "lego", "materials", "mic", "ship"]

B2C = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], dtype=np.float64
)


class Dataset:
    def __init__(self, cfg, **kwargs):
        self.cfg = cfg
        self.data_root = os.path.join(cfg.workspace, kwargs["data_root"])
        self.split = kwargs["split"]
        self.scenes = [kwargs["scene"]] if "scene" in kwargs else []
        # Deterministic augmentation under fix_random (reference seeds all
        # RNGs in train_net.py:18-23); entropy-seeded otherwise.
        self.rng = np.random.default_rng(
            0 if getattr(cfg, "fix_random", False) else None
        )
        self.build_metas()

    def build_metas(self) -> None:
        scenes = self.scenes or list(ALL_SCENES)
        pairs = json.load(open(PAIRS_FILE))
        self.scene_infos = {}
        self.metas = []
        for scene in scenes:
            meta = json.load(
                open(os.path.join(self.data_root, scene, "transforms_train.json"))
            )
            info = {"ixts": [], "exts": [], "img_paths": [], "scene_name": scene}
            focal = 0.5 * 800 / np.tan(0.5 * meta["camera_angle_x"])
            for idx, frame in enumerate(meta["frames"]):
                c2w = np.array(frame["transform_matrix"]) @ B2C
                ext = np.linalg.inv(c2w)
                ixt = np.eye(3)
                ixt[0, 0] = ixt[1, 1] = focal
                ixt[0, 2] = ixt[1, 2] = 400.0
                info["ixts"].append(ixt.astype(np.float32))
                info["exts"].append(ext.astype(np.float32))
                info["img_paths"].append(
                    os.path.join(self.data_root, scene, f"train/r_{idx}.png")
                )
            self.scene_infos[scene] = info

            train_ids, render_ids = pairs[f"{scene}_train"], pairs[f"{scene}_val"]
            if self.split == "train":
                render_ids = train_ids
            c2ws = np.stack(
                [np.linalg.inv(info["exts"][i]) for i in train_ids]
            )
            for idx in render_ids:
                c2w = np.linalg.inv(info["exts"][idx])
                distance = np.linalg.norm(
                    c2w[:3, 3][None] - c2ws[:, :3, 3], axis=-1
                )
                argsorts = distance.argsort()
                if idx in train_ids:
                    argsorts = argsorts[1:]
                if self.split == "train":
                    nv = max(self.cfg.train.sampler_meta.input_views_num)
                else:
                    nv = self.cfg.test.sampler_meta.input_views_num[0]
                src_views = [train_ids[i] for i in argsorts[:nv]]
                self.metas.append((scene, idx, src_views))

    def __getitem__(self, index_meta):
        import cv2

        index, input_views_num, render_scale = index_meta
        scene, tar_view, src_views = self.metas[index]
        if self.split == "train":
            if self.rng.random() < 0.1:
                src_views = src_views + [tar_view]
            src_views = list(
                self.rng.choice(src_views, size=input_views_num, replace=False)
            )
        info = self.scene_infos[scene]
        tar_img = self.read_image(info, tar_view)
        tar_mask = np.ones_like(tar_img[..., 0], dtype=np.uint8)
        tar_ext, tar_ixt = info["exts"][tar_view], info["ixts"][tar_view]
        src_inps, src_exts, src_ixts = self.read_src(info, src_views)

        tar_gt_ms = {"rgb": [], "mask": []}
        for s in self.cfg.mvs.vol_scales:
            tar_gt_ms["rgb"].append(
                cv2.resize(
                    tar_img, None, fx=s, fy=s, interpolation=cv2.INTER_AREA
                ).astype(np.float32)
            )
            tar_gt_ms["mask"].append(
                cv2.resize(
                    tar_mask, None, fx=s, fy=s, interpolation=cv2.INTER_NEAREST
                ).astype(np.float32)
            )

        if render_scale != 1.0:
            tar_img = cv2.resize(
                tar_img, None, fx=render_scale, fy=render_scale,
                interpolation=cv2.INTER_AREA,
            )
            tar_mask = cv2.resize(
                tar_mask, None, fx=render_scale, fy=render_scale,
                interpolation=cv2.INTER_NEAREST,
            )

        H, W = tar_img.shape[:2]
        return {
            "src_views": {
                "rgb": src_inps,
                "extrinsics": src_exts,
                "intrinsics": src_ixts,
            },
            "tar_views": {
                "extrinsics": tar_ext,
                "intrinsics": tar_ixt,
                "rgb": tar_img,
                "mask": tar_mask,
            },
            "near_far": np.array([2.5, 5.5], dtype=np.float32),
            "tar_gt_ms": tar_gt_ms,
            "render_scale": render_scale,
            "meta": {
                "scene": scene,
                "tar_view": tar_view,
                "frame_id": 0,
                "h": H,
                "w": W,
            },
        }

    def read_src(self, info, src_views):
        imgs, exts, ixts = [], [], []
        for idx in src_views:
            imgs.append(self.read_image(info, idx))
            ixts.append(info["ixts"][idx])
            exts.append(info["exts"][idx])
        return np.stack(imgs), np.stack(exts), np.stack(ixts)

    def read_image(self, info, idx):
        return load_rgb(info["img_paths"][idx], white_bg=True)

    def __len__(self):
        return len(self.metas)
