"""What every kind of traffic shares: the seeded weights, the program's and
the reference's networks built from a configuration, and the device's
memory readings.

A kind of traffic is a file ``kinds/<kind>.py`` with one function,
``run(cell, seed, seconds, traced, device, t_start, controls) -> dict``:
set-up, the measured window, the traced segment and the check against the
plain reference.  It returns ``obs`` (what the metrics' readers read),
``readings`` (the numbers that decide ``correct``), ``controls``,
``attempted``, ``failed``, ``memory_peak`` and ``traced_units``.

The measured window starts at the first timed request or step and ends when
the last one started inside ``seconds`` has completed, so every unit of work
in it is counted whole.  With ``trace`` a segment of the mix's
``trace_seconds`` follows the window under the profiler; the window itself
is never traced.
"""

from __future__ import annotations

import gc
from types import SimpleNamespace

import torch

from benchmark.reference import weights as seeded


def namespace(d: dict) -> SimpleNamespace:
    return SimpleNamespace(**{k: namespace(v) if isinstance(v, dict) else v for k, v in d.items()})


def reference_network(cfg: dict, device):
    from benchmark.reference.network import Network

    with torch.device(device):
        return Network.from_config(namespace(cfg))


def seeded_state(cfg: dict, seed: int, device) -> dict:
    """The network's weights from the seed, made on ``device``."""
    with torch.device("meta"):
        shapes = reference_network(cfg, "meta")
    return seeded.network_state(shapes, seed, device)


def program_network(cfg: dict, dtype: torch.dtype, state: dict, device):
    """The measured program's network with the seeded weights loaded."""
    from gdb_nerf_tpu_torch.runtime.registry import make_network

    with torch.device(device):
        net = make_network(namespace(cfg), dtype)
    net.load_state_dict(state, strict=True)
    return net


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
