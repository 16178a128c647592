"""How a kernel's time is taken and what it is held to.

``bound_ms`` is the least time the card could take for a call's work: the
larger of the bytes it must move over the device memory rate and the
operations it does over the peak rate for the input type.  Each kernel
module counts its own work (``bundle_head.work``, ``plane_conv.work``): each
input read once, each output written once, a multiply-add 2 operations.
``timed_ms`` is the device time of a call, taken with CUDA events.
"""

from __future__ import annotations

import time

import torch

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet): device
# memory bytes/s, and peak FLOP/s by input type (float32 outside the tensor
# cores, bf16 on them).
H100_BYTES_PER_S = 3.35e12
H100_PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def bound_ms(n_bytes: float, flops: float, dtype: torch.dtype) -> tuple[float, str]:
    """Least time the H100 could take: the larger of bytes over its memory
    rate and operations over its peak for the input type."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed_ms(fn, device: torch.device, iters: int) -> float:
    """Mean time of ``fn`` over ``iters`` calls after one warm-up: on the
    GPU the device's time, on the CPU the host clock's.

    On the GPU a spin kernel (``torch.cuda._sleep``) holds the stream while
    the host enqueues the calls, and CUDA events time them from its end: the
    calls then run back to back, so a wrapper's host cost per call (checks,
    ctypes, allocation) does not enter the time of a kernel shorter than it.
    """
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3  # enqueue time of one call
    end.synchronize()
    cycles_per_ms = 1_000_000 / start.elapsed_time(end)
    torch.cuda.synchronize(device)
    torch.cuda._sleep(int(cycles_per_ms * (2 * host_ms * iters + 1)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
