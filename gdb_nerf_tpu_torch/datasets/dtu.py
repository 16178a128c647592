"""DTU multi-view stereo dataset reader.

Behavior-equivalent of the reference DTU loader
(the reference's datasets/dataloader/dtu.py): 49 cameras per scan read from
`Cameras/train/%08d_cam.txt` (intrinsics x4), images from
`Rectified/{scene}_train/rect_%03d_3_r5000.png`, ground-truth depth from
`.pfm` files downscaled x0.5 and cropped [44:556, 80:720] to 512x640.
near/far comes from the camera file's depth_min/interval with
``interval_scale = 1 / (global_num_depth / 192)``.  Source views are the
nearest cameras by center distance using the pairs.json train/val id splits;
train-time augmentation includes the target view in the source pool with
10% probability.

Images are channels-last (V, H, W, 3) float32 in [0, 1].
"""

from __future__ import annotations

import json
import os

import numpy as np

from gdb_nerf_tpu_torch.datasets.imageio import load_rgb
from gdb_nerf_tpu_torch.utils.io import read_cam_file, read_pfm

PAIRS_FILE = "data/mvsnerf/pairs.json"


class Dataset:
    def __init__(self, cfg, **kwargs):
        self.cfg = cfg
        self.data_root = os.path.join(cfg.workspace, kwargs["data_root"])
        self.split = kwargs["split"]
        self.scenes = [kwargs["scene"]] if "scene" in kwargs else []
        self.num_depth = cfg.nerf.global_num_depth
        self.interval_scale = 1.0 / (float(self.num_depth) / 192.0)
        # Deterministic augmentation under fix_random (reference seeds all
        # RNGs in train_net.py:18-23); entropy-seeded otherwise.
        self.rng = np.random.default_rng(
            0 if getattr(cfg, "fix_random", False) else None
        )
        self.build_metas(kwargs["ann_file"])

    def build_metas(self, ann_file: str) -> None:
        scenes = [line.strip() for line in open(ann_file).readlines()]
        pairs = json.load(open(PAIRS_FILE))
        if self.scenes:
            scenes = self.scenes

        self.scene_infos = {}
        self.metas = []
        for scene in scenes:
            info = {
                "ixts": [],
                "exts": [],
                "dpt_paths": [],
                "img_paths": [],
                "near_far": [],
            }
            for i in range(49):
                cam_path = os.path.join(
                    self.data_root, "Cameras/train/{:08d}_cam.txt".format(i)
                )
                ixt, ext, depth_min, depth_interval = read_cam_file(cam_path)
                ixt = ixt.copy()
                ixt[:2] *= 4  # camera files store intrinsics at 1/4 res
                depth_max = (
                    depth_min
                    + depth_interval * self.interval_scale * self.num_depth
                )
                info["ixts"].append(ixt.astype(np.float32))
                info["exts"].append(ext.astype(np.float32))
                info["dpt_paths"].append(
                    os.path.join(
                        self.data_root,
                        "Depths/{}/depth_map_{:04d}.pfm".format(scene, i),
                    )
                )
                info["img_paths"].append(
                    os.path.join(
                        self.data_root,
                        "Rectified/{}_train/rect_{:03d}_3_r5000.png".format(
                            scene, i + 1
                        ),
                    )
                )
                info["near_far"].append(
                    np.array([depth_min, depth_max], dtype=np.float32)
                )

            if self.split == "train" and len(self.scenes) != 1:
                train_ids = list(range(49))
                test_ids = list(range(49))
            elif self.split == "train" and len(self.scenes) == 1:
                train_ids = pairs["dtu_train"]
                test_ids = pairs["dtu_train"]
            else:
                train_ids = pairs["dtu_train"]
                test_ids = pairs["dtu_val"]
            info["train_ids"], info["test_ids"] = train_ids, test_ids
            self.scene_infos[scene] = info

            cam_points = np.array(
                [np.linalg.inv(info["exts"][i])[:3, 3] for i in train_ids]
            )
            for tar_view in test_ids:
                cam_point = np.linalg.inv(info["exts"][tar_view])[:3, 3]
                distance = np.linalg.norm(cam_points - cam_point[None], axis=-1)
                argsorts = distance.argsort()
                if tar_view in train_ids:
                    argsorts = argsorts[1:]
                if self.split == "train":
                    nv = max(self.cfg.train.sampler_meta.input_views_num)
                else:
                    nv = self.cfg.test.sampler_meta.input_views_num[0]
                src_views = [train_ids[i] for i in argsorts[:nv]]
                self.metas.append((scene, tar_view, src_views))

    def __getitem__(self, index_meta):
        import cv2

        index, input_views_num, render_scale = index_meta
        scene, tar_view, src_views = self.metas[index]
        if self.split == "train":
            if self.rng.random() < 0.1:
                src_views = src_views + [tar_view]
            pool = src_views[: input_views_num + 1]
            src_views = list(
                self.rng.choice(pool, size=input_views_num, replace=False)
            )
        info = self.scene_infos[scene]

        tar_img = load_rgb(info["img_paths"][tar_view])
        H, W = tar_img.shape[:2]
        tar_ext, tar_ixt = info["exts"][tar_view], info["ixts"][tar_view]

        tar_dpt = read_pfm(info["dpt_paths"][tar_view])[0].astype(np.float32)
        tar_dpt = cv2.resize(
            tar_dpt, None, fx=0.5, fy=0.5, interpolation=cv2.INTER_NEAREST
        )
        tar_dpt = tar_dpt[44:556, 80:720]
        tar_mask = (tar_dpt > 0.0).astype(np.uint8)

        if render_scale != 1.0:
            tar_img = cv2.resize(
                tar_img, None, fx=render_scale, fy=render_scale,
                interpolation=cv2.INTER_AREA,
            )
            tar_mask = cv2.resize(
                tar_mask, None, fx=render_scale, fy=render_scale,
                interpolation=cv2.INTER_NEAREST,
            )
            tar_dpt = cv2.resize(
                tar_dpt, None, fx=render_scale, fy=render_scale,
                interpolation=cv2.INTER_NEAREST,
            )

        src_inps, src_exts, src_ixts = self.read_src(info, src_views)

        tar_gt_ms = {"rgb": [], "mask": [], "depth": []}
        for s in self.cfg.mvs.vol_scales:
            tar_gt_ms["rgb"].append(
                cv2.resize(tar_img, None, fx=s, fy=s, interpolation=cv2.INTER_AREA)
            )
            tar_gt_ms["mask"].append(
                cv2.resize(
                    tar_mask, None, fx=s, fy=s, interpolation=cv2.INTER_NEAREST
                )
            )
            tar_gt_ms["depth"].append(
                cv2.resize(
                    tar_dpt, None, fx=s, fy=s, interpolation=cv2.INTER_NEAREST
                )
            )

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
                "depth": tar_dpt,
            },
            "near_far": info["near_far"][tar_view],
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
        inps, exts, ixts = [], [], []
        for v in src_views:
            inps.append(load_rgb(info["img_paths"][v]))
            exts.append(info["exts"][v])
            ixts.append(info["ixts"][v])
        return np.stack(inps), np.stack(exts), np.stack(ixts)

    def __len__(self):
        return len(self.metas)
