"""Training metrics recorder (TensorBoard + smoothed console stats).

A copy of ``gdb_nerf_tpu/train/recorder.py``: a tensorboardX writer under
``cfg.record_dir`` (wiped when not resuming; optional, the recorder runs
without it), SmoothedValue windows (deque of 20, median/avg/global-avg),
scalar/image logging, and a state_dict so the global step survives
checkpoint resume.
"""

from __future__ import annotations

import os
import shutil
from collections import defaultdict, deque

import numpy as np


class SmoothedValue:
    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float) -> None:
        self.deque.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class Recorder:
    def __init__(self, cfg, enabled: bool = True):
        self.cfg = cfg
        self.enabled = enabled
        self.step = 0
        self.epoch = 0
        self.loss_stats = defaultdict(SmoothedValue)
        self.batch_time = SmoothedValue()
        self.data_time = SmoothedValue()
        self.image_stats: dict = {}
        self.writer = None
        if not enabled:
            return
        log_dir = cfg.record_dir
        if not cfg.resume and os.path.exists(log_dir):
            print(f"remove contents of directory {log_dir}")
            shutil.rmtree(log_dir)
        os.makedirs(log_dir, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter

            self.writer = SummaryWriter(log_dir=log_dir)
        except Exception as e:
            print(f"[recorder] tensorboard unavailable: {e}")

    def update_loss_stats(self, stats: dict) -> None:
        for k, v in stats.items():
            self.loss_stats[k].update(float(v))

    def update_image_stats(self, image_stats: dict, batched: bool | None = None) -> None:
        """Stash images for the next record(): HWC float arrays clamped to
        [0, 1]; 2-D arrays (depth) are normalized to their own range.

        ``batched``: True if every value carries a leading batch axis, False
        if none do.  None falls back to shape inference, which cannot
        distinguish an (H, W, C) image with an unusual channel count from a
        batched (B, H, W) map — callers that know should say."""
        if not self.enabled:
            return
        for k, v in image_stats.items():
            img = np.asarray(v, dtype=np.float32)
            if batched and img.ndim >= 3:
                img = img[0]
            if img.ndim == 4:  # batched HWC: take the first element
                img = img[0]
            if batched is None and img.ndim == 3 and img.shape[-1] not in (1, 3, 4):
                # Heuristic: batched 2-D map, e.g. (B, H, W) nerf_depth from
                # the network — take the first element, fall through to the
                # grayscale normalization below.
                img = img[0]
            if img.ndim == 2:  # depth/opacity map -> normalized grayscale
                lo, hi = float(img.min()), float(img.max())
                img = (img - lo) / max(hi - lo, 1e-8)
                img = img[..., None]
            self.image_stats[k] = np.clip(img, 0.0, 1.0)

    def record(
        self,
        prefix: str,
        step: int | None = None,
        stats: dict | None = None,
        image_stats: dict | None = None,
        batched: bool | None = None,
    ):
        if not self.enabled or self.writer is None:
            return
        step = self.step if step is None else step
        stats = stats or {
            k: v.median for k, v in self.loss_stats.items()
        }
        for k, v in stats.items():
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue  # non-numeric marker, e.g. lpips "SKIPPED (...)"
            self.writer.add_scalar(f"{prefix}/{k}", v, step)
        if image_stats:
            self.update_image_stats(image_stats, batched=batched)
        for k, img in self.image_stats.items():
            self.writer.add_image(f"{prefix}/{k}", img, step, dataformats="HWC")
        self.image_stats.clear()

    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.step = int(sd.get("step", 0))

    def __str__(self) -> str:
        parts = [f"{k}: {v.avg:.4f}" for k, v in self.loss_stats.items()]
        return "  ".join(parts)
