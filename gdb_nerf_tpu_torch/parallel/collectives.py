"""The collectives that XLA inserts for the JAX package's mesh, written out.

The JAX step ``pmean``s gradients and stats (``gdb_nerf_tpu/train/step.py``),
its BatchNorm ``psum``s batch moments over the ``data`` axis, and its
row-sharded render all-gathers the bundle maps before the decoder
(``gdb_nerf_tpu/parallel/infer.py``).  Here each is a call on a
``torch.distributed`` process group; ``group=None`` means the world group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; its backward sums the gradient over ranks (the
    transpose of ``psum``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)


def all_reduce_mean_(tensors: list[torch.Tensor], group=None) -> None:
    """Replace each tensor, in place, by its mean over ranks: one all-reduce
    of one flat buffer."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def mean_over_ranks(stats: dict, group=None) -> dict:
    """Each scalar of ``stats`` averaged over ranks (the step's ``pmean``)."""
    keys = list(stats)
    device = next((v.device for v in stats.values() if torch.is_tensor(v) and v.is_cuda), "cpu")
    flat = torch.stack([torch.as_tensor(stats[k]).detach().float().reshape(()).to(device)
                        for k in keys])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    return dict(zip(keys, flat.unbind()))


def gather_rows(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in rank
    order, on every rank.  Not differentiable: the row-sharded render is an
    eval path."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)
