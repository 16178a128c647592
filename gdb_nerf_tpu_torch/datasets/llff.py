"""LLFF forward-facing dataset reader.

Behavior-equivalent of the reference LLFF loader
(the reference's datasets/dataloader/llff.py): parses `poses_bounds.npy`
(rows are the llff [down, right, back] convention; reordered to c2w with
columns [r, u, -t]), derives intrinsics from the pose row (x0.25 for the
`images_4` images, then rescaled to the configured input size), resizes to
`input_h_w`, and uses scene-global near/far = min/max of per-view bounds.
Masks are all-ones.  Channels-last float32.
"""

from __future__ import annotations

import json
import os

import numpy as np

from gdb_nerf_tpu_torch.datasets.imageio import load_rgb

PAIRS_FILE = "data/mvsnerf/pairs.json"
ALL_SCENES = ["fern", "flower", "fortress", "horns", "leaves", "orchids", "room", "trex"]


class Dataset:
    def __init__(self, cfg, **kwargs):
        self.cfg = cfg
        self.data_root = os.path.join(cfg.workspace, kwargs["data_root"])
        self.split = kwargs["split"]
        self.input_h_w = tuple(kwargs["input_h_w"])
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
            pose_bounds = np.load(
                os.path.join(self.data_root, scene, "poses_bounds.npy")
            )
            poses = pose_bounds[:, :15].reshape((-1, 3, 5))
            n = len(poses)
            c2ws = np.tile(np.eye(4), (n, 1, 1))
            # llff rows are (down, right, back); c2w columns = (r, u, -t).
            c2ws[:, :3, 0] = poses[:, :3, 1]
            c2ws[:, :3, 1] = poses[:, :3, 0]
            c2ws[:, :3, 2] = -poses[:, :3, 2]
            c2ws[:, :3, 3] = poses[:, :3, 3]
            ixts = np.tile(np.eye(3), (n, 1, 1))
            ixts[:, 0, 0] = ixts[:, 1, 1] = poses[:, 2, 4]
            ixts[:, 0, 2] = poses[:, 1, 4] / 2.0
            ixts[:, 1, 2] = poses[:, 0, 4] / 2.0
            ixts[:, :2] *= 0.25  # images_4

            img_names = sorted(
                f
                for f in os.listdir(os.path.join(self.data_root, scene, "images_4"))
                if f.endswith(".png")
            )
            info = {
                "ixts": ixts.astype(np.float32),
                "c2ws": c2ws.astype(np.float32),
                "image_names": img_names,
                "depth_ranges": pose_bounds[:, -2:].astype(np.float32),
                "scene_name": scene,
            }
            self.scene_infos[scene] = info

            train_ids = pairs[f"{scene}_train"]
            render_ids = train_ids if self.split == "train" else pairs[f"{scene}_val"]
            train_c2ws = c2ws[train_ids]
            for i in render_ids:
                c2w = info["c2ws"][i]
                distance = np.linalg.norm(
                    c2w[:3, 3][None] - train_c2ws[:, :3, 3], axis=-1
                )
                argsorts = distance.argsort()
                if i in train_ids:
                    argsorts = argsorts[1:]
                if self.split == "train":
                    nv = max(self.cfg.train.sampler_meta.input_views_num)
                else:
                    nv = self.cfg.test.sampler_meta.input_views_num[0]
                src_views = [train_ids[j] for j in argsorts[:nv]]
                self.metas.append((scene, i, src_views))

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
        tar_img, tar_mask, tar_ext, tar_ixt = self.read_tar(info, tar_view)
        src_inps, src_exts, src_ixts = self.read_src(info, src_views)

        tar_gt_ms = {"rgb": [], "mask": []}
        for s in self.cfg.mvs.vol_scales:
            tar_gt_ms["rgb"].append(
                cv2.resize(tar_img, None, fx=s, fy=s, interpolation=cv2.INTER_AREA)
            )
            tar_gt_ms["mask"].append(
                cv2.resize(
                    tar_mask, None, fx=s, fy=s, interpolation=cv2.INTER_NEAREST
                )
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

        dr = info["depth_ranges"]
        near_far = np.array([dr[:, 0].min(), dr[:, 1].max()], dtype=np.float32)
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
            "near_far": near_far,
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
            img, orig = self.read_image(info, idx)
            imgs.append(img)
            ixt, ext = self.read_cam(info, idx, orig)
            ixts.append(ixt)
            exts.append(ext)
        return np.stack(imgs), np.stack(exts), np.stack(ixts)

    def read_tar(self, info, idx):
        img, orig = self.read_image(info, idx)
        ixt, ext = self.read_cam(info, idx, orig)
        mask = np.ones_like(img[..., 0], dtype=np.float32)
        return img, mask, ext, ixt

    def read_cam(self, info, idx, orig_size):
        c2w = info["c2ws"][idx]
        w2c = np.linalg.inv(c2w).astype(np.float32)
        ixt = info["ixts"][idx].copy()
        ixt[0] *= self.input_h_w[1] / orig_size[1]
        ixt[1] *= self.input_h_w[0] / orig_size[0]
        return ixt.astype(np.float32), w2c

    def read_image(self, info, idx):
        import cv2

        path = os.path.join(
            self.data_root, info["scene_name"], "images_4", info["image_names"][idx]
        )
        img = load_rgb(path)
        orig = img.shape[:2]
        img = cv2.resize(img, self.input_h_w[::-1], interpolation=cv2.INTER_AREA)
        return img, orig

    def __len__(self):
        return len(self.metas)
