"""The traced segment: torch's profiler over a few seconds of the cell's loop,
reduced to device busy time, idle gaps and time by kernel.

The benchmark marks its own host work with ``record_function`` labels
(``mark``): ``bench.window`` spans the traced segment, the others say what
the host was doing (``bench.submit``, ``bench.render``, ``bench.copy_back``,
``bench.wait``, ``bench.data_wait``, ``bench.train_step``).  Device activity
is every kernel, copy and memset on the card; the union of their intervals
inside the window is the busy time, and each gap between them is charged to
the host label that spans its middle (``host`` where none does).
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

DEVICE_ACTIVITIES = {"kernel", "gpu_memcpy", "gpu_memset"}
WINDOW = "bench.window"
NAME_LEN = 96  # a kernel's name is cut to this many characters in the breakdown


def mark(label: str, on: bool):
    """A profiler label around host work, or nothing when not tracing."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(label)


def profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False,
                                  profile_memory=False)


def union_length(intervals: list) -> tuple[float, list]:
    """Total length of the union of (start, end) intervals, and the merged
    intervals in order."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def reduce_events(device_events: list, host_events: list, window: tuple) -> dict:
    """Busy and idle time inside ``window`` (start, end), in seconds.

    ``device_events``: (name, start_ns, end_ns); ``host_events``: (label,
    start_ns, end_ns).  Returns window_s, busy_s, kernels {name: [count,
    seconds]}, device_ops and idle_gaps (the ten largest, [name, seconds])."""
    ws, we = window
    clipped = [(max(s, ws), min(e, we)) for _, s, e in device_events if e > ws and s < we]
    busy_ns, merged = union_length(clipped)
    kernels = defaultdict(lambda: [0, 0.0])
    for name, s, e in device_events:
        if e > ws and s < we:
            k = kernels[name]
            k[0] += 1
            k[1] += (min(e, we) - max(s, ws)) * 1e-9
    host = sorted((s, e, label) for label, s, e in host_events)
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    edges = [ws] + [x for iv in merged for x in iv] + [we]
    for gs, ge in zip(edges[0::2], edges[1::2]):
        if ge <= gs:
            continue
        mid = (gs + ge) / 2
        label, i = "host", bisect.bisect_right(starts, mid) - 1
        while i >= 0:  # the innermost label that spans the gap's middle
            if host[i][1] >= mid:
                label = host[i][2]
                break
            i -= 1
        gaps[label] += (ge - gs) * 1e-9
    ops = sorted(((n[:NAME_LEN], v[1]) for n, v in kernels.items()), key=lambda x: -x[1])
    return {
        "window_s": (we - ws) * 1e-9,
        "busy_s": busy_ns * 1e-9,
        "kernels": dict(kernels),
        "device_ops": [list(x) for x in ops[:10]],
        "idle_gaps": [[k, v] for k, v in sorted(gaps.items(), key=lambda x: -x[1])[:10]],
    }


def on_device(e) -> bool:
    """A kernel, copy or memset on the card: not the card's copy of a host
    label (``gpu_user_annotation``), which spans the labelled work."""
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    if hasattr(e, "activity_type"):
        return e.activity_type() in DEVICE_ACTIVITIES
    return not (e.is_user_annotation() or e.name().startswith("bench."))


def summarize(prof) -> dict:
    """``reduce_events`` over a finished profiler's events."""
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if on_device(e):
            device.append((name, e.start_ns(), e.end_ns()))
        elif name == WINDOW:
            window = (e.start_ns(), e.end_ns())
        elif name.startswith("bench."):
            host.append((name, e.start_ns(), e.end_ns()))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    return reduce_events(device, host, window)
