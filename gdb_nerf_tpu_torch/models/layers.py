"""Conv building blocks with the reference's module layout.

Port of ``ConvBlock`` / ``DeconvBlock`` from ``gdb_nerf_tpu/models/layers.py``
as the reference builds them: ``Sequential(Conv(bias=False), BatchNorm,
ReLU)``, so a block's parameters are ``<name>.0.weight`` and
``<name>.1.{weight,bias,running_mean,running_var}``.  The transposed conv is
``ConvTranspose3d(k=3, s=2, p=1, output_padding=1)`` (out = 2 * in).

Dtype: a network whose feature path runs in bf16 holds that path's conv and
linear weights in bf16 (``cast_weights``, once, when it is built), so every
layer computes in its weights' dtype with no cast per call.  BatchNorm
parameters and statistics stay float32; BatchNorm normalizes a bf16 input
with them and returns bf16.

BatchNorm over ranks (the JAX package's ``BatchNorm(axis_name='data')``):
``set_batchnorm_group`` gives every BatchNorm under a module a process
group.  In training mode such a BatchNorm normalizes with the batch
moments of every rank of the group (``batch_norm_over_ranks``); in eval
mode, or with no group, it is exactly ``nn.BatchNorm{2d,3d}``.
``nn.SyncBatchNorm`` is not used: it refuses CPU tensors, where the
2-process tests run.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn

from gdb_nerf_tpu_torch.parallel.collectives import all_reduce_sum

_WEIGHTED = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d, nn.Linear)


def cast_weights(module: nn.Module, dtype: torch.dtype, keep=()) -> nn.Module:
    """Cast, in place, the weights and biases of every conv and linear layer
    under ``module`` to ``dtype``, except the layers in ``keep``, which stay
    float32.  A state dict loaded afterwards is cast into these dtypes."""
    kept = {id(m) for m in keep}
    for m in module.modules():
        if isinstance(m, _WEIGHTED) and id(m) not in kept:
            m.to(dtype)
    return module


def batch_norm_over_ranks(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor, group):
    """Training-mode BatchNorm of ``x`` with the moments of the whole batch
    over the ranks of ``group``, and its running statistics updated with them.

    Each rank puts its element count, mean and sum of squared deviations per
    channel into its own row of a (world, 3, C) buffer, which one
    ``all_reduce_sum`` (differentiable) fills on every rank; the rows are
    merged by count (Chan et al.), with no cancellation.  The mean and the
    biased variance normalize, as flax's pmean of moments does; where the
    shards are equal the count weighting is that pmean, and it stays right
    where ranks hold different view counts.  ``running_var`` takes the
    unbiased variance over the whole batch, as torch's BatchNorm does on one
    process."""
    c = x.shape[1]
    dims = [0, *range(2, x.dim())]
    var_l, mean_l = torch.var_mean(x.float(), dims, correction=0)
    n = x.numel() // c
    world, r = dist.get_world_size(group), dist.get_rank(group)
    row = torch.stack([torch.full_like(mean_l, n), mean_l, var_l * n])[None]
    slots = torch.cat([row.new_zeros(r, 3, c), row, row.new_zeros(world - r - 1, 3, c)])
    counts, means, m2 = all_reduce_sum(slots, group).unbind(1)
    total = counts.sum(0)
    mean = (counts * means).sum(0) / total
    var = (m2 + counts * (means - mean) ** 2).sum(0) / total
    shape = (1, c) + (1,) * (x.dim() - 2)
    scale = torch.rsqrt(var + bn.eps) * bn.weight
    y = (x.float() - mean.view(shape)) * scale.view(shape) + bn.bias.view(shape)
    with torch.no_grad():
        bn.num_batches_tracked.add_(1)
        bn.running_mean.lerp_(mean, bn.momentum)
        bn.running_var.lerp_(var * total / (total - 1), bn.momentum)
    return y.to(x.dtype)


class _BatchNormOverRanks:
    """A BatchNorm whose training-mode moments span ``process_group``."""

    process_group = None

    def forward(self, x):
        if not self.training or self.process_group is None:
            return super().forward(x)
        self._check_input_dim(x)
        return batch_norm_over_ranks(self, x, self.process_group)


class BatchNorm2d(_BatchNormOverRanks, nn.BatchNorm2d):
    pass


class BatchNorm3d(_BatchNormOverRanks, nn.BatchNorm3d):
    pass


def set_batchnorm_group(module: nn.Module, group) -> nn.Module:
    """Give every BatchNorm under ``module`` the process group ``group``
    (None: batch moments of this process only)."""
    for m in module.modules():
        if isinstance(m, _BatchNormOverRanks):
            m.process_group = group
    return module


class ConvBlock(nn.Sequential):
    """Conv (bias-free) + BatchNorm + ReLU, 2D or 3D."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1,
                 padding: int = 0, ndim: int = 2):
        conv, bn = (nn.Conv2d, BatchNorm2d) if ndim == 2 else (nn.Conv3d, BatchNorm3d)
        super().__init__(
            conv(c_in, c_out, kernel, stride, padding, bias=False),
            bn(c_out, eps=1e-5, momentum=0.1),
            nn.ReLU(),
        )


class DeconvBlock(nn.Sequential):
    """ConvTranspose3d(k=3, s=2, p=1, op=1) + BatchNorm3d + ReLU."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__(
            nn.ConvTranspose3d(c_in, c_out, 3, 2, 1, output_padding=1, bias=False),
            BatchNorm3d(c_out, eps=1e-5, momentum=0.1),
            nn.ReLU(),
        )
