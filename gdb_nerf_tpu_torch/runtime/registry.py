"""Network and evaluator factories for the port.

Port-local counterpart of ``gdb_nerf_tpu/runtime/registry.py``: the YAML's
``network_module`` and ``evaluator_module`` strings name the GDB-NeRF
network, built from the config, and its evaluator.
"""

from __future__ import annotations

from typing import Any

import torch

from gdb_nerf_tpu_torch.eval.evaluator import Evaluator
from gdb_nerf_tpu_torch.models.network import Network


def make_network(cfg: Any, compute_dtype: torch.dtype | None = None) -> Network:
    """The config's network, in ``compute_dtype`` if given, else the
    config's.  A trainer's network is float32 whatever the config says: its
    master weights (a bf16 training rounds them into its compute copy at
    each step, ``train/mixed.py``, never at build)."""
    name = getattr(cfg, "network_module", "networks.gdb_nerf.network")
    if name != "networks.gdb_nerf.network":
        raise ValueError(f"unknown network_module {name!r}")
    return Network.from_config(cfg, compute_dtype=compute_dtype)


def make_evaluator(cfg: Any) -> Evaluator:
    name = getattr(cfg, "evaluator_module", "evaluators.gdb_nerf")
    if name != "evaluators.gdb_nerf":
        raise ValueError(f"unknown evaluator_module {name!r}")
    return Evaluator(cfg)
