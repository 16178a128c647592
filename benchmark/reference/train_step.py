"""The training step of the plain reference: loss, backward, clip, adam.

Written out from the published recipe (the reference trainer's clip by
value at 40, then adam with betas (0.9, 0.999), eps 1e-8 and the
exponential schedule), not taken from the measured program: every
parameter is updated, one that the loss does not reach with a zero
gradient, as the program and optax do.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import losses

CLIP_VALUE = 40.0
BETAS = (0.9, 0.999)


def device_batch(batch: dict, device) -> dict:
    """A collated numpy training batch as the float32 tensors the loss reads."""

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    sv, tv = batch["src_views"], batch["tar_views"]
    return {
        "src_views": {k: t(sv[k]) for k in ("rgb", "extrinsics", "intrinsics")},
        "tar_views": {k: t(tv[k]) for k in ("extrinsics", "intrinsics")},
        "near_far": t(batch["near_far"]),
        "tar_rgb": t(tv["rgb"]),
        "tar_gt_rgb_ms": [t(r) for r in batch["tar_gt_ms"]["rgb"]],
    }


def loss(network, batch: dict, loss_weight, vgg) -> torch.Tensor:
    """The recipe's loss: the final image's photometric loss plus each MVS
    stage render's, weighted by ``loss_weight``."""
    weights = (1.0, 0.1, 0.05 if vgg is not None else 0.0)
    ret, _, blend_rgbs = network({k: batch[k] for k in ("src_views", "tar_views", "near_far")},
                                 train=True)
    total = losses.photometric_loss(batch["tar_rgb"], ret["rgb"], vgg, weights)[0]
    for i, blend in enumerate(blend_rgbs):
        total = total + loss_weight[i] * losses.photometric_loss(
            batch["tar_gt_rgb_ms"][i], blend, vgg, weights)[0]
    return total


def exponential_lr(train_cfg: dict, ep_iter: int):
    """The LR of optimizer step k under the recipe's exponential schedule."""
    sched = train_cfg["scheduler"]
    if sched["type"] != "exponential":
        raise ValueError(f"the reference knows the exponential schedule, not {sched['type']!r}")
    base, gamma, decay = train_cfg["lr"], sched["gamma"], sched["decay_epochs"]
    return lambda k: base * gamma ** ((k // max(ep_iter, 1)) / decay)


class Adam:
    """Adam over a list of tensors, written out in torch's order of
    operations (a lerp for the first moment, the bias-corrected root plus
    eps as the denominator), so that two steps from equal gradients give
    equal parameters."""

    def __init__(self, params, eps: float = 1e-8):
        self.params = params
        self.eps = eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads, lr: float) -> None:
        self.t += 1
        b1, b2 = BETAS
        step_size = lr / (1 - b1 ** self.t)
        c2_sqrt = (1 - b2 ** self.t) ** 0.5
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.lerp_(g, 1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.addcdiv_(m, (v.sqrt() / c2_sqrt).add_(self.eps), value=-step_size)


def run_steps(network, batches, loss_weight, vgg, lr_of_step, eps: float = 1e-8):
    """Take one step per batch from the network's current state.

    Returns (losses [float], the first step's clipped gradients {name: tensor}).
    """
    names = [n for n, p in network.named_parameters() if p.requires_grad]
    params = [p for p in network.parameters() if p.requires_grad]
    opt = Adam(params, eps)
    step_losses, first = [], None
    for k, batch in enumerate(batches):
        value = loss(network, batch, loss_weight, vgg)
        grads = torch.autograd.grad(value, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.clamp(-CLIP_VALUE, CLIP_VALUE)
                 for p, g in zip(params, grads)]
        if first is None:
            first = {n: g.detach().clone() for n, g in zip(names, grads)}
        opt.step(grads, lr_of_step(k))
        step_losses.append(float(value.detach()))
    return step_losses, first
