"""Multi-process start-up: the process group, its backend and this rank.

Port of ``gdb_nerf_tpu/parallel/hosts.py``.  ``config_from_env`` reads the
same environment conventions as the JAX function and makes the same
single- or multi-process choice; where that function returns the
arguments of ``jax.distributed.initialize``, this one returns those of
``torch.distributed.init_process_group``:

  * ``JAX_COORDINATOR_ADDRESS`` (+ ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``):
    ``tcp://<address>`` with that world size and rank;
  * torchrun's ``MASTER_ADDR``/``MASTER_PORT`` + ``WORLD_SIZE``/``RANK``:
    ``tcp://<addr>:<port>`` (port 12355 if unset), or ``None`` where
    ``WORLD_SIZE <= 1``;
  * ``TPU_WORKER_HOSTNAMES`` is Cloud-TPU metadata with no meaning on a GPU
    host: ``None``.

Launch: ``torchrun --nproc_per_node=N -m gdb_nerf_tpu_torch.train_net ...``.

The backend rule (``backend_for``), printed on rank 0: ``gloo`` for CPU
tensors; ``nccl`` where every rank of the host has its own card (the
host's ranks, ``LOCAL_WORLD_SIZE``, fit ``torch.cuda.device_count()``), on
``cuda:LOCAL_RANK``; ``gloo`` on CUDA tensors where ranks share a card,
because NCCL refuses two ranks on one device.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def config_from_env(env=None) -> dict | None:
    """``init_process_group`` arguments from the environment; None = one process.

    Returns ``{"init_method", "world_size", "rank"}``; a JAX-style
    environment without ``JAX_NUM_PROCESSES`` or ``JAX_PROCESS_ID`` leaves
    that key out (the JAX runtime detects it; ``maybe_initialize_distributed``
    refuses)."""
    env = os.environ if env is None else env
    if env.get("JAX_COORDINATOR_ADDRESS"):
        out = {"init_method": f"tcp://{env['JAX_COORDINATOR_ADDRESS']}"}
        if env.get("JAX_NUM_PROCESSES"):
            out["world_size"] = int(env["JAX_NUM_PROCESSES"])
        if env.get("JAX_PROCESS_ID"):
            out["rank"] = int(env["JAX_PROCESS_ID"])
        return out
    if env.get("MASTER_ADDR") and env.get("WORLD_SIZE"):
        if int(env["WORLD_SIZE"]) <= 1:
            return None
        return {
            "init_method": f"tcp://{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '12355')}",
            "world_size": int(env["WORLD_SIZE"]),
            "rank": int(env.get("RANK", "0")),
        }
    return None


def backend_for(device: torch.device, local_world: int) -> str:
    """``gloo`` for the CPU or for ranks sharing a card, else ``nccl``."""
    if device.type != "cuda" or local_world > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def maybe_initialize_distributed(device="cuda", env=None) -> torch.device:
    """Join the process group that the environment describes, once.

    Returns the device this rank runs on: ``device`` itself for one process
    or the CPU; on a GPU host ``cuda:LOCAL_RANK`` where every rank has its
    own card, else ``cuda:LOCAL_RANK % device_count()``; the backend is
    ``backend_for``'s.  A second call returns the same device."""
    device = torch.device(device)
    if getattr(maybe_initialize_distributed, "_device", None) is not None:
        return maybe_initialize_distributed._device
    env = os.environ if env is None else env
    cfg = config_from_env(env)
    if cfg is None:
        return device
    missing = {"world_size", "rank"} - set(cfg)
    if missing:
        raise ValueError(f"multi-process start-up needs {sorted(missing)}: set "
                         "JAX_NUM_PROCESSES and JAX_PROCESS_ID (or torchrun's WORLD_SIZE, RANK)")
    local_rank = int(env.get("LOCAL_RANK", cfg["rank"]))
    local_world = int(env.get("LOCAL_WORLD_SIZE", cfg["world_size"]))
    if device.type == "cuda":
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend_for(device, local_world)
    dist.init_process_group(backend, **cfg)
    maybe_initialize_distributed._device = device
    if cfg["rank"] == 0:
        print(f"[parallel] {cfg['world_size']} processes over {backend} "
              f"({local_world} on this host; rank 0 on {device})")
    return device


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
    maybe_initialize_distributed._device = None


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def default_group():
    """The world group when more than one process runs, else None."""
    return dist.group.WORLD if world_size() > 1 else None
