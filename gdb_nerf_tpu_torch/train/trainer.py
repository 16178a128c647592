"""Trainer: the epoch/iteration loop around the train step.

Port of ``gdb_nerf_tpu/train/trainer.py``: per iteration the device
transfer, the train step and smoothed logging with eta, LR and peak
memory; ``val`` runs the evaluator through the eval ``Renderer`` (the bundle
head's kernel on the card) and puts the network back into training mode.
Checkpoints are saved by ``train_net.py`` from ``state_dict``.  Training
runs in float32; on the card each step is also timed with CUDA events
(``step_ms``).  With a process ``group`` the trainer takes data-parallel
steps (``train/step.py``): its BatchNorms span the group's ranks, and
``step_ms`` and ``memory_mb`` stay this rank's own.
"""

from __future__ import annotations

import datetime
import time

import numpy as np
import torch

from gdb_nerf_tpu_torch.models.layers import set_batchnorm_group
from gdb_nerf_tpu_torch.runtime.renderer import Renderer, set_float32_numerics, to_device
from gdb_nerf_tpu_torch.train.optim import make_optimizer
from gdb_nerf_tpu_torch.train.step import make_train_step, to_device_train


class Trainer:
    def __init__(self, cfg, network, device, use_perceptual: bool = True, group=None):
        if network.compute_dtype != torch.float32:
            raise ValueError(
                f"training runs in float32; compute_dtype {network.compute_dtype} is not "
                "supported by the trainer (bf16 training is a later item)")
        self.cfg = cfg
        self.device = torch.device(device)
        self.network = set_batchnorm_group(network.to(self.device).train(), group)
        set_float32_numerics(tf32=False)
        self.optimizer, self.scheduler = make_optimizer(cfg, self.network.parameters())
        self.step_fn = make_train_step(self.network, self.optimizer, self.scheduler,
                                       list(cfg.mvs.loss_weight), use_perceptual, group)
        self.step_ms: list[float] = []  # CUDA-event time of each step on the card

    @property
    def step(self) -> int:
        """Optimizer steps taken."""
        return self.scheduler.last_epoch

    def train_step(self, batch: dict) -> dict:
        """One step on a loader batch; returns the stats as floats."""
        dev_batch = to_device_train(batch, self.device)
        if self.device.type != "cuda":
            return {k: float(v) for k, v in self.step_fn(dev_batch).items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        stats = self.step_fn(dev_batch)
        end.record()
        end.synchronize()
        self.step_ms.append(start.elapsed_time(end))
        return {k: float(v) for k, v in stats.items()}

    def train_epoch(self, epoch: int, data_loader, recorder) -> None:
        self.network.train()
        max_iter = len(data_loader)
        end = time.time()
        for it, batch in enumerate(data_loader):
            data_time = time.time() - end
            stats = self.train_step(batch)
            batch_time = time.time() - end
            end = time.time()

            recorder.step += 1
            recorder.update_loss_stats(stats)
            recorder.batch_time.update(batch_time)
            recorder.data_time.update(data_time)

            if it % self.cfg.log_interval == 0 or it == max_iter - 1:
                lr = self.scheduler.get_last_lr()[0]
                eta_seconds = recorder.batch_time.global_avg * (max_iter - it)
                eta = str(datetime.timedelta(seconds=int(eta_seconds)))
                print(
                    f"eta: {eta}  epoch: {epoch}  iter {it}/{max_iter}  "
                    f"{recorder}  lr: {lr:.6f}  "
                    f"data: {recorder.data_time.avg:.3f}s  "
                    f"batch: {recorder.batch_time.avg:.3f}s  max_mem: {self.memory_mb()}"
                )
            if it % self.cfg.log_interval == 0:
                recorder.record("train")

    def val(self, epoch: int, data_loader, evaluator, recorder=None) -> dict:
        """Evaluate every batch of ``data_loader`` in eval mode; returns the
        evaluator's summary."""
        renderer = Renderer(self.network, self.device)
        image_stats = {}
        try:
            for batch in data_loader:
                ret, _ = renderer.render(to_device(batch, self.device))
                output = {k: v.float().cpu().numpy() for k, v in ret.items()}
                evaluator.evaluate(output, batch)
                if not image_stats:  # pred/gt/depth panel from the first batch
                    image_stats = {
                        "pred_rgb": output["rgb"],
                        "gt_rgb": np.asarray(batch["tar_views"]["rgb"]),
                        "nerf_depth": output["nerf_depth"],
                    }
        finally:
            self.network.train()
        result = evaluator.summarize()
        if recorder is not None:
            recorder.record("val", epoch, result, image_stats, batched=True)
        return result

    def memory_mb(self) -> str:
        if self.device.type != "cuda":
            return "n/a"
        return f"{torch.cuda.max_memory_allocated(self.device) / 2**20:.0f}MB"

    def state_dict(self) -> dict:
        """{net, optim, scheduler, step} for ``utils.checkpoint.save_model``."""
        return {"net": self.network.state_dict(), "optim": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        """Resume from a ``utils.checkpoint.load_model`` state; the next step
        runs at this config's schedule (``StepSchedule.load_state_dict``)."""
        self.network.load_state_dict(state["net"], strict=True)
        self.optimizer.load_state_dict(state["optim"])
        self.scheduler.load_state_dict(state["scheduler"])
