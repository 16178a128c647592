"""Network factory for the port.

Port-local counterpart of ``gdb_nerf_tpu/runtime/registry.py``: the YAML's
``network_module`` string names the GDB-NeRF network, built from the config.
"""

from __future__ import annotations

from typing import Any

from gdb_nerf_tpu_torch.models.network import Network


def make_network(cfg: Any) -> Network:
    name = getattr(cfg, "network_module", "networks.gdb_nerf.network")
    if name != "networks.gdb_nerf.network":
        raise ValueError(f"unknown network_module {name!r}")
    return Network.from_config(cfg)
