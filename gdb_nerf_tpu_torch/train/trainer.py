"""Trainer: the epoch/iteration loop around the train step.

Port of ``gdb_nerf_tpu/train/trainer.py``: per iteration the device
transfer, the train step and smoothed logging with eta, LR and peak
memory; ``val`` runs the evaluator through the eval ``Renderer`` (the bundle
head's kernel on the card) and puts the network back into training mode.
Checkpoints are saved by ``train_net.py`` from ``state_dict``.  On the card
each step is also timed with CUDA events (``step_ms``).

``network`` holds float32 weights (``runtime.registry.make_network(cfg,
torch.float32)``).  Under ``compute_dtype bfloat16`` they are the master
weights of a bf16 step (``train/mixed.py``): ``state_dict`` stays float32
under the reference's keys, and ``val`` renders through the step's bf16
compute copy with the master's latest weights rounded in, the network an
eval of the checkpoint builds (``val_network``), so on the card its head
runs the bf16 kernel.

With a process ``group`` the trainer takes data-parallel steps
(``train/step.py``): its BatchNorms span the group's ranks, and
``step_ms`` and ``memory_mb`` stay this rank's own.
"""

from __future__ import annotations

import datetime
import time

import numpy as np
import torch

from gdb_nerf_tpu_torch.models.layers import set_batchnorm_group
from gdb_nerf_tpu_torch.runtime import tracing
from gdb_nerf_tpu_torch.runtime.renderer import Renderer, set_float32_numerics, to_device
from gdb_nerf_tpu_torch.train.mixed import MixedPrecision
from gdb_nerf_tpu_torch.train.optim import make_optimizer
from gdb_nerf_tpu_torch.train.step import make_train_step, to_device_train


def read_stats(stats: dict) -> dict:
    """The step's stats as floats; reading each from the device is a host
    wait (``sync.stats``)."""
    out = {}
    for k, v in stats.items():
        with tracing.host_wait("stats", v.device):
            out[k] = float(v)
    return out


class Trainer:
    def __init__(self, cfg, network, device, use_perceptual: bool = True, group=None):
        if any(p.dtype != torch.float32 for p in network.parameters()):
            raise ValueError(
                "the trainer keeps float32 master weights; build the network with "
                "make_network(cfg, torch.float32), not with weights already cast to "
                f"{network.compute_dtype}")
        self.cfg = cfg
        self.device = torch.device(device)
        dtype = getattr(torch, getattr(cfg, "compute_dtype", "float32"))
        self.network = network.to(self.device).train()
        self.mixed = None if dtype == torch.float32 else MixedPrecision(self.network, dtype)
        set_batchnorm_group(self.network, group)
        if self.mixed is not None:
            set_batchnorm_group(self.mixed.compute.train(), group)
        set_float32_numerics(tf32=False)
        self.optimizer, self.scheduler = make_optimizer(cfg, self.network.parameters())
        self.step_fn = make_train_step(self.network, self.optimizer, self.scheduler,
                                       list(cfg.mvs.loss_weight), use_perceptual, group,
                                       self.mixed)
        self.step_ms: list[float] = []  # CUDA-event time of each step on the card
        self.val_network = self.network  # the network the last val rendered through

    @property
    def step(self) -> int:
        """Optimizer steps taken."""
        return self.scheduler.last_epoch

    def train_step(self, batch: dict) -> dict:
        """One step on a loader batch; returns the stats as floats.  The
        span ``train.step`` (a step's root) around ``train/step.py``'s
        phases and ``train.readback``: the wait for the step's end and the
        stats read into Python, each a host wait."""
        with tracing.span("train.step"):
            dev_batch = to_device_train(batch, self.device)
            timed = self.device.type == "cuda"
            if timed:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            stats = self.step_fn(dev_batch)
            if timed:
                end.record()
            with tracing.span("train.readback"):
                if timed:
                    with tracing.host_wait("step_end", self.device):
                        end.synchronize()
                    self.step_ms.append(start.elapsed_time(end))
                return read_stats(stats)

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
        if self.mixed is None:
            self.val_network = self.network
        else:
            self.mixed.refresh()
            self.val_network = self.mixed.compute
        renderer = Renderer(self.val_network, self.device)
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
            self.val_network.train()
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
