"""Inference renderer and host -> device batch transfer.

Port of ``gdb_nerf_tpu/runtime/renderer.py::Renderer``.  ``to_device``
moves the network-input slice of a loader batch (numpy, channels-last) to
tensors on an explicit device; the transfer stays outside any timed region,
as in the reference protocol.  ``Renderer`` runs the eval forward under
``torch.inference_mode`` (the span ``render`` of ``runtime/tracing.py``)
and times it with CUDA events, beside the host time it takes to queue the
forward.

Float32 numerics are set explicitly: matmuls never use TF32, and cuDNN
convolutions use TF32 only when the renderer is built with ``tf32=True``
(PyTorch's default for convolutions is TF32 on).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gdb_nerf_tpu_torch.runtime import tracing


def to_device(batch: dict, device) -> dict:
    """The device-side slice of a loader batch, as float32 tensors (each a
    pageable copy, which the host waits for: ``sync.to_device``)."""

    def t(x):
        x = torch.as_tensor(np.asarray(x, np.float32))
        with tracing.host_wait("to_device", device):
            return x.to(device)

    sv, tv = batch["src_views"], batch["tar_views"]
    return {
        "src_views": {k: t(sv[k]) for k in ("rgb", "extrinsics", "intrinsics")},
        "tar_views": {k: t(tv[k]) for k in ("extrinsics", "intrinsics")},
        "near_far": t(batch["near_far"]),
    }


def set_float32_numerics(tf32: bool) -> None:
    """Set PyTorch's float32 switches: matmuls in full float32, cuDNN
    convolutions in TF32 only if ``tf32``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = tf32


class Renderer:
    """Holds an eval-mode network on a device and runs its forward."""

    def __init__(self, network: torch.nn.Module, device, tf32: bool = False):
        self.device = torch.device(device)
        self.network = network.eval().to(self.device)
        set_float32_numerics(tf32)
        # Pack the head's kernel weights now, at load time.
        self.network.nerf.packed_weights()

    def render(self, dev_batch: dict):
        """One eval forward on an already-transferred batch -> (ret, mvs_depths);
        the span ``render``, a request's root."""
        with tracing.span("render"), torch.inference_mode():
            ret, mvs_depths, _ = self.network(dev_batch)
        return ret, mvs_depths

    def render_timed(self, dev_batch: dict):
        """``render`` plus its latency -> (out, ms, enqueue_ms).

        ``ms`` is read after the device finished: CUDA events on a GPU, the
        host clock on the CPU.  ``enqueue_ms`` is the host clock from the
        call until the forward returned, before any sync: the time the host
        takes to queue the forward's work.  The forward holds no sync point,
        so when ``enqueue_ms`` is well below ``ms`` the device sets the
        latency, and when it nears ``ms`` the host does.
        """
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            out = self.render(dev_batch)
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            end.record()
            with tracing.host_wait("render_timed", self.device):
                end.synchronize()
            return out, start.elapsed_time(end), enqueue_ms
        t0 = time.perf_counter()
        out = self.render(dev_batch)
        ms = (time.perf_counter() - t0) * 1e3
        return out, ms, ms

    def mean_latency_ms(self, dev_batches) -> tuple[float, list, list, list]:
        """Render every batch; the mean latency excludes the first (warm-up)
        iteration when there is more than one.  Returns (mean ms, every
        request's ms, every request's enqueue ms, outputs)."""
        times, enqueues, outs = [], [], []
        for b in dev_batches:
            out, ms, enqueue_ms = self.render_timed(b)
            times.append(ms)
            enqueues.append(enqueue_ms)
            outs.append(out)
        timed = times[1:] if len(times) > 1 else times
        return float(np.mean(timed)), times, enqueues, outs
