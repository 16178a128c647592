"""Per-scene PSNR/SSIM (+DTU depth metrics) evaluator.

A copy of ``gdb_nerf_tpu/eval/evaluator.py``: metrics on mask-zeroed
images, optional 10%-border center crop (LLFF/MVSNeRF protocol), depth
abs-err and accuracy at 2mm/10mm for the five MVSNeRF DTU scans, per-scene
breakdown printed by ``summarize``.  With ``eval_lpips`` it scores LPIPS
(``eval/lpips.py``) on the configured ``device``; when the weights file is
absent the metric reads "SKIPPED (weights absent)", as the JAX evaluator's
does.  Unlike the JAX evaluator, which skips LPIPS on any exception, only a
missing weights file skips it here: any other failure of LPIPS raises.
"""

from __future__ import annotations

import os

import cv2
import numpy as np

from gdb_nerf_tpu_torch.eval import metrics
from gdb_nerf_tpu_torch.eval.lpips import LPIPS

DEPTH_EVAL_SCENES = ("scan1", "scan8", "scan21", "scan103", "scan110")


class Evaluator:
    def __init__(self, cfg):
        self.cfg = cfg
        self.lpips_fn = None
        self.lpips_skipped = False
        if getattr(cfg, "eval_lpips", False):
            try:
                self.lpips_fn = LPIPS.load_default(getattr(cfg, "device", "cuda"))
            except FileNotFoundError as e:
                self.lpips_skipped = True
                print(f"[evaluator] LPIPS unavailable ({e}); skipping lpips metric")
        self._reset()
        os.makedirs(cfg.result_dir, exist_ok=True)

    def _reset(self):
        self.psnrs, self.ssims, self.lpips = [], [], []
        self.scene_psnrs, self.scene_ssims, self.scene_lpips = {}, {}, {}
        self.abs, self.acc_2, self.acc_10 = [], [], []
        self.mvs_abs, self.mvs_acc_2, self.mvs_acc_10 = [], [], []

    def evaluate(self, output: dict, batch: dict) -> None:
        gt_rgb = np.asarray(batch["tar_views"]["rgb"], np.float32)
        masks = (np.asarray(batch["tar_views"]["mask"]) >= 1).astype(np.uint8)
        pred_rgb = np.clip(np.asarray(output["rgb"], np.float32), 0.0, 1.0)
        B, H, W = gt_rgb.shape[:3]

        if self.cfg.test.eval_center:
            hc, wc = int(H * 0.1), int(W * 0.1)
            pred_rgb = pred_rgb[:, hc:-hc, wc:-wc]
            gt_rgb = gt_rgb[:, hc:-hc, wc:-wc]
            masks = masks[:, hc:-hc, wc:-wc]

        for b in range(B):
            scene = batch["meta"]["scene"][b]
            for d in (self.scene_psnrs, self.scene_ssims, self.scene_lpips):
                d.setdefault(scene, [])

            if getattr(self.cfg, "save_result", False):
                path = os.path.join(
                    self.cfg.result_dir,
                    "{}_{}_{}.png".format(
                        scene,
                        batch["meta"]["tar_view"][b],
                        batch["meta"]["frame_id"][b],
                    ),
                )
                img = (
                    cv2.cvtColor(pred_rgb[b], cv2.COLOR_RGB2BGR) * 255
                ).clip(0, 255).astype(np.uint8)
                cv2.imwrite(path, img)
                if "nerf_depth" in output:
                    # colormapped depth alongside the RGB dump
                    from gdb_nerf_tpu_torch.utils.img import visualize_depth_numpy

                    dvis, _ = visualize_depth_numpy(
                        np.asarray(output["nerf_depth"])[b]
                    )
                    cv2.imwrite(path[:-4] + "_depth.png", dvis)

            mask = masks[b] == 1
            gt = gt_rgb[b].copy()
            pred = pred_rgb[b].copy()
            gt[~mask] = 0.0
            pred[~mask] = 0.0

            p = metrics.psnr(gt[mask], pred[mask], data_range=1.0)
            self.psnrs.append(p)
            self.scene_psnrs[scene].append(p)

            s = metrics.ssim(gt, pred, channel_axis=-1)
            self.ssims.append(s)
            self.scene_ssims[scene].append(s)

            if self.lpips_fn is not None:
                l = float(self.lpips_fn(gt * 2 - 1, pred * 2 - 1))
                self.lpips.append(l)
                self.scene_lpips[scene].append(l)

            if self.cfg.test.eval_depth and scene in DEPTH_EVAL_SCENES:
                nerf_depth = np.asarray(output["nerf_depth"])[b]
                nerf_gt = np.asarray(batch["tar_views"]["depth"])[b]
                mvs_depth = np.asarray(output["mvs_depth"])[b]
                mvs_gt = np.asarray(batch["tar_gt_ms"]["depth"][-1])[b]
                nerf_depth = cv2.resize(
                    nerf_depth, nerf_gt.shape[::-1], interpolation=cv2.INTER_LINEAR
                )
                nm = nerf_gt != 0.0
                mm = mvs_gt != 0.0
                err = np.abs(nerf_depth[nm] - nerf_gt[nm])
                self.abs.append(err.mean())
                self.acc_2.append((err < 2).mean())
                self.acc_10.append((err < 10).mean())
                merr = np.abs(mvs_depth[mm] - mvs_gt[mm])
                self.mvs_abs.append(merr.mean())
                self.mvs_acc_2.append((merr < 2.0).mean())
                self.mvs_acc_10.append((merr < 10.0).mean())

    def summarize(self) -> dict:
        ret = {"psnr": float(np.mean(self.psnrs)), "ssim": float(np.mean(self.ssims))}
        if self.lpips:
            ret["lpips"] = float(np.mean(self.lpips))
        elif self.lpips_skipped:
            # eval_lpips was requested but there is no LPIPS: the metrics
            # table is NOT protocol-comparable to the reference's; say so in
            # the output itself, not just once at construction.
            ret["lpips"] = "SKIPPED (weights absent)"
        print("=" * 30)
        for scene in self.scene_psnrs:
            line = "{} psnr: {:.2f} ssim: {:.3f}".format(
                scene.ljust(16),
                np.mean(self.scene_psnrs[scene]),
                np.mean(self.scene_ssims[scene]),
            )
            if self.scene_lpips.get(scene):
                line += " lpips:{:.3f}".format(np.mean(self.scene_lpips[scene]))
            print(line)
        print("=" * 30)
        if self.lpips_skipped:
            print(f"lpips: {ret['lpips']}")
        print(ret)
        if self.cfg.test.eval_depth and self.abs:
            print(
                {
                    "abs": float(np.mean(self.abs)),
                    "acc_2": float(np.mean(self.acc_2)),
                    "acc_10": float(np.mean(self.acc_10)),
                }
            )
            print(
                {
                    "mvs_abs": float(np.mean(self.mvs_abs)),
                    "mvs_acc_2": float(np.mean(self.mvs_acc_2)),
                    "mvs_acc_10": float(np.mean(self.mvs_acc_10)),
                }
            )
        self._reset()
        return ret
