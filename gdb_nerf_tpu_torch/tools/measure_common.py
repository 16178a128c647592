"""What the tools that measure the model on synthetic scenes share.

``tools/measure_fill.py``, ``tools/measure_lod.py`` and
``tools/bf16_gate.py`` render the synthetic test scenes of an eval config
at its protocol size through the ``Renderer`` (the bundle head's kernel on
the card), from seeded weights or from a checkpoint.  The synthetic loader
renders at ``synthetic_hw``, whatever the config's own size, so each config
here takes its protocol size explicitly.
"""

from __future__ import annotations

import argparse
import itertools
import os

import torch

from gdb_nerf_tpu_torch.config import load_cfg
from gdb_nerf_tpu_torch.datasets import make_data_loader
from gdb_nerf_tpu_torch.models.network import Network
from gdb_nerf_tpu_torch.runtime.renderer import Renderer
from gdb_nerf_tpu_torch.utils.checkpoint import load_network

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# The reference protocol's frame size of each eval config (H, W).
PROTOCOL_HW = {"dtu_eval": (512, 640), "llff_eval": (640, 960), "nerf_eval": (800, 800)}


def device_of(name: str) -> torch.device:
    """``name`` as a device; stops if it is a GPU that is not there."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run on the CPU")
    return device


def eval_cfg(name: str, overrides=()):
    """``configs/<name>.yaml`` on the synthetic loader at its protocol size,
    then ``overrides`` (``key value`` pairs)."""
    H, W = PROTOCOL_HW[name]
    return load_cfg(os.path.join(REPO, "configs", f"{name}.yaml"),
                    ["synthetic", "True", "synthetic_hw", f"[{H},{W}]", *overrides])


def load_state(ckpt: str | None) -> dict | None:
    """The network state that ``utils.checkpoint.load_network`` picks in
    ``ckpt`` (a file or a model directory; raises FileNotFoundError when
    there is none), or None for no ``ckpt``."""
    if ckpt is None:
        return None
    state, path = load_network(ckpt)
    print(f"[weights] {path}")
    return state


def renderer_for(cfg, device, state: dict | None, debug_outputs: bool = False) -> Renderer:
    """A ``Renderer`` of ``Network.from_config(cfg)`` on ``device`` with
    ``state`` loaded, or initialized from torch's generator seeded with 0."""
    torch.manual_seed(0)
    network = Network.from_config(cfg, debug_outputs=debug_outputs)
    if state is not None:
        network.load_state_dict(state, strict=True)
    return Renderer(network, device)


def first_batches(cfg, n: int) -> list:
    """The first ``n`` batches of ``cfg``'s test loader, loaded in this
    thread: stopping early leaves no producer thread waiting."""
    loader = make_data_loader(cfg, is_train=False)
    loader.num_workers = 0
    return list(itertools.islice(loader, n))


def parser(doc: str, scenes: int) -> argparse.ArgumentParser:
    """The measure tools' arguments: --cfgs, --scenes, --ckpt, --dtype,
    --device."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--cfgs", nargs="*", default=list(PROTOCOL_HW), choices=list(PROTOCOL_HW))
    ap.add_argument("--scenes", type=int, default=scenes)
    ap.add_argument("--ckpt", default=None,
                    help="a .pth file or a model directory (utils/checkpoint.py::load_network); "
                    "default: weights initialized from seed 0")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda")
    return ap
