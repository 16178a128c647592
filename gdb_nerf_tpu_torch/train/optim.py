"""Optimizer and LR-schedule factories.

Port of ``gdb_nerf_tpu/train/optim.py``, whose optax chain is
``clip(40) -> adam/adamw/radam/sgd`` with a schedule of the optimizer step.
Here the clip is ``clip_grad_value_`` at ``CLIP_VALUE`` in the train step,
and each optimizer is the ``torch.optim`` class that computes what the
optax transform computes:

  * ``adam`` is ``Adam``, or with a weight decay ``AdamW``: the JAX package
    builds ``optax.adamw`` there, a decay decoupled from the moments and
    scaled by the LR (torch's ``Adam(weight_decay=...)`` would be an L2
    term in the gradient instead);
  * ``adamw`` is ``AdamW``; ``radam`` is ``RAdam`` (both rectify above a
    length of 5 of the approximated SMA; optax adds eps to the bias-corrected
    root, torch to the root before its correction, a difference of order eps);
  * ``sgd`` is ``SGD(momentum=0.9)``, whose buffer is optax's trace.

Betas (0.9, 0.999) are both libraries' defaults.  ``StepSchedule`` sets the
LR of optimizer step k to ``schedule(k)``, as optax's count does; the train
step steps it after every optimizer step.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

CLIP_VALUE = 40.0  # gradient clip by value (the reference trainer's clip)


def make_lr_schedule(cfg: Any) -> Callable[[int], float]:
    """The LR as a function of the optimizer step; ``ep_iter`` steps make an epoch."""
    base = cfg.train.lr
    sched = cfg.train.scheduler
    ep_iter = max(int(getattr(cfg, "ep_iter", -1)), 1)
    stype = getattr(sched, "type", "multi_step")

    if stype == "exponential":
        gamma = sched.gamma
        decay_epochs = sched.decay_epochs

        def fn(step):
            return base * gamma ** ((step // ep_iter) / decay_epochs)

        return fn
    if stype == "multi_step":
        milestones = list(sched.milestones)
        gamma = sched.gamma

        def fn(step):
            return base * gamma ** sum(step // ep_iter >= m for m in milestones)

        return fn
    if stype == "warmup_multi_step":
        milestones = list(sched.milestones)
        gamma = sched.gamma
        warmup_iters = int(getattr(sched, "warmup_iters", 500))
        warmup_factor = float(getattr(sched, "warmup_factor", 1.0 / 3))

        def fn(step):
            count = sum(step // ep_iter >= m for m in milestones)
            alpha = min(max(step / warmup_iters, 0.0), 1.0)
            wf = warmup_factor * (1 - alpha) + alpha if step < warmup_iters else 1.0
            return base * wf * gamma**count

        return fn
    raise ValueError(f"Unknown scheduler type: {stype}")


class StepSchedule(torch.optim.lr_scheduler.LRScheduler):
    """Sets every group's LR to ``schedule(step)``, ``step`` counting the
    optimizer steps taken (``last_epoch``)."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Callable[[int], float]):
        self.schedule = schedule
        super().__init__(optimizer)

    def get_lr(self) -> list[float]:
        return [self.schedule(self.last_epoch)] * len(self.optimizer.param_groups)

    def state_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items() if k not in ("optimizer", "schedule")}

    def load_state_dict(self, state_dict: dict) -> None:
        """Restore the step count; every group's LR becomes this schedule's
        at that count, as optax reads its schedule at the restored count,
        and not the LR stored with the checkpoint's optimizer.  Load the
        optimizer's state first."""
        super().load_state_dict(state_dict)
        self._last_lr = self.get_lr()
        for group, lr in zip(self.optimizer.param_groups, self._last_lr):
            group["lr"] = lr


def make_optimizer(cfg: Any, params) -> tuple[torch.optim.Optimizer, StepSchedule]:
    """The cfg's optimizer over ``params`` and its per-step LR schedule."""
    schedule = make_lr_schedule(cfg)
    name = cfg.train.optim
    wd = cfg.train.weight_decay
    eps = getattr(cfg.train, "eps", 1e-8)
    lr = schedule(0)
    if name == "adam":
        opt = (torch.optim.AdamW(params, lr, eps=eps, weight_decay=wd) if wd
               else torch.optim.Adam(params, lr, eps=eps))
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr, eps=eps, weight_decay=wd)
    elif name == "radam":
        opt = torch.optim.RAdam(params, lr, eps=eps)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr, momentum=0.9)
    else:
        raise ValueError(f"Unknown optimizer: {name}")
    return opt, StepSchedule(opt, schedule)
