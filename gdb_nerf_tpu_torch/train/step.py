"""The training step: forward, loss, backward, clip, optimizer and LR step.

Port of ``gdb_nerf_tpu/train/step.py``.  The loss mirrors the reference's:
a photometric (MSE + SSIM + VGG) loss on the final image plus photometric
losses on each intermediate MVS stage's render, weighted by
``mvs.loss_weight``.  The stats dict has the JAX step's keys, with the
Smooth-L1 depth errors (``depth_loss{i}``) computed without gradient, for
monitoring only.

Data parallelism (the JAX step under ``shard_map`` on a ``data`` mesh):
with a process group each rank runs its own shard of the batch, the
BatchNorm moments span the ranks (``models.layers.set_batchnorm_group``),
and after the backward the gradients are averaged over ranks in one
all-reduce of a flat buffer, before the clip, as the JAX step ``pmean``s
before ``optax.clip``; the stats are averaged too.  Every rank then takes
the same optimizer step.

bf16 (``compute_dtype bfloat16``): the step runs a bf16 copy of float32
master weights (``train/mixed.py``); the all-reduce, the clip and the
optimizer act on the master's float32 gradients.

Its phases are spans of ``runtime/tracing.py``, in order: ``train.h2d``
(``to_device_train``), ``train.zero_grad`` (with ``mixed.refresh``),
``train.forward``, ``train.loss`` (the photometric losses and the
monitoring stats), ``train.backward`` and ``train.update`` (gather,
all-reduce, clip, optimizer, LR).
"""

from __future__ import annotations

import numpy as np
import torch

from gdb_nerf_tpu_torch.parallel.collectives import all_reduce_mean_, mean_over_ranks
from gdb_nerf_tpu_torch.runtime import tracing
from gdb_nerf_tpu_torch.train import losses
from gdb_nerf_tpu_torch.train.optim import CLIP_VALUE


def to_device_train(batch: dict, device) -> dict:
    """Device-side slice of a training batch (inputs + supervision), float32:
    the span ``train.h2d``, each pageable copy a host wait
    (``sync.to_device_train``)."""

    def t(x):
        x = torch.as_tensor(np.asarray(x, np.float32))
        with tracing.host_wait("to_device_train", device):
            return x.to(device)

    sv, tv = batch["src_views"], batch["tar_views"]
    with tracing.span("train.h2d"):
        out = {
            "src_views": {k: t(sv[k]) for k in ("rgb", "extrinsics", "intrinsics")},
            "tar_views": {k: t(tv[k]) for k in ("extrinsics", "intrinsics")},
            "near_far": t(batch["near_far"]),
            "tar_rgb": t(tv["rgb"]),
            "tar_gt_rgb_ms": [t(r) for r in batch["tar_gt_ms"]["rgb"]],
        }
        # Ground-truth depth (DTU only): carried for monitoring-only stats.
        if "depth" in batch["tar_gt_ms"]:
            out["tar_gt_depth_ms"] = [t(d) for d in batch["tar_gt_ms"]["depth"]]
            out["tar_gt_mask_ms"] = [t(m) for m in batch["tar_gt_ms"]["mask"]]
    return out


def make_loss_fn(network, loss_weight, use_perceptual: bool = True):
    """``loss_fn(batch) -> (loss, stats)`` on a ``to_device_train`` batch;
    the forward runs with ``train=True``."""
    weights = (1.0, 0.1, 0.05 if use_perceptual else 0.0)

    def loss_fn(batch):
        with tracing.span("train.forward"):
            ret, mvs_depths, blend_rgbs = network(
                {k: batch[k] for k in ("src_views", "tar_views", "near_far")}, train=True)
        with tracing.span("train.loss"):
            color_loss, mse, ssim_v, perc = losses.photometric_loss(
                batch["tar_rgb"], ret["rgb"], weights)
            depth_loss = 0.0
            for i, blend in enumerate(blend_rgbs):
                dl, _, _, _ = losses.photometric_loss(batch["tar_gt_rgb_ms"][i], blend, weights)
                depth_loss = depth_loss + loss_weight[i] * dl
            loss = color_loss + depth_loss
            stats = {
                "loss": loss,
                "mse_loss": mse,
                "psnr": -10.0 * torch.log10(mse + 1e-6),
                "ssim": ssim_v,
                "perceptual_loss": perc,
                "depth_loss": depth_loss,
            }
            if "tar_gt_depth_ms" in batch:
                with torch.no_grad():
                    _, dstats = losses.smooth_l1_depth(
                        mvs_depths, batch["tar_gt_depth_ms"], batch["tar_gt_mask_ms"],
                        [1.0] * len(mvs_depths))
                stats.update(dstats)
            return loss, {k: torch.as_tensor(v).detach() for k, v in stats.items()}

    return loss_fn


def make_train_step(network, optimizer, scheduler, loss_weight, use_perceptual: bool = True,
                    group=None, mixed=None):
    """``step(batch) -> stats``: one update of ``network``'s parameters.

    Every parameter takes part in the update: one that the loss does not
    reach (the FPN's full-resolution head at bundle size 2) gets a zero
    gradient, as under optax, so that a weight decay reaches it too.  With
    a process ``group``, ``batch`` is this rank's shard and the gradients
    and stats are averaged over the group's ranks.  With ``mixed``
    (``train.mixed.MixedPrecision`` over ``network``), the forward and
    backward run on its bf16 copy and everything after the backward acts on
    ``network``'s float32 gradients, in the JAX step's order."""
    loss_fn = make_loss_fn(network if mixed is None else mixed.compute, loss_weight,
                           use_perceptual)
    params = [p for p in network.parameters() if p.requires_grad]

    def step(batch):
        with tracing.span("train.zero_grad"):
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                else:
                    p.grad.zero_()
            if mixed is not None:
                mixed.refresh()
        loss, stats = loss_fn(batch)
        with tracing.span("train.backward"):
            loss.backward()
        with tracing.span("train.update"):
            if mixed is not None:
                mixed.gather_grads()
            if group is not None:
                all_reduce_mean_([p.grad for p in params], group)
                stats = mean_over_ranks(stats, group)
            torch.nn.utils.clip_grad_value_(params, CLIP_VALUE)
            optimizer.step()
            scheduler.step()
        return stats

    return step
