"""Training CLI of the port.

    python -m gdb_nerf_tpu_torch.train_net --cfg_file configs/dtu_pretrain.yaml [k v ...]
    python -m gdb_nerf_tpu_torch.train_net --cfg_file configs/dtu_pretrain.yaml --test

Counterpart of the JAX package's ``train_net.py``: builds the trainer and
the loaders, resumes from ``trained_model_dir`` (``resume``) or warm-starts
from ``train.pretrain``, then per epoch trains ``ep_iter`` steps, saves
``<epoch>.pth`` (every ``save_ep``) and ``latest.pth`` (every
``save_latest_ep``) and runs ``val`` (every ``eval_ep``, unless
``skip_eval``).  ``--test`` evaluates instead (``run --type evaluate``).
``device`` selects the device (default ``cuda``; ``device cpu`` trains on
the CPU).  A fresh network is initialized from torch's generator seeded
with 0; ``fix_random`` also seeds python's and numpy's generators.

Data-parallel over N processes:

    torchrun --nproc_per_node=N -m gdb_nerf_tpu_torch.train_net --cfg_file ... [k v ...]

Each rank joins the process group first (``parallel.hosts``, which picks
the backend and this rank's card), loads its own shard of the training
set with ``train.batch_size`` a rank (the JAX per-process batch and the
reference's per-GPU one), starts from rank 0's parameters and buffers, and
takes data-parallel steps; saving, ``val`` and the recorder run on rank 0
only.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from gdb_nerf_tpu_torch.config import make_cfg, make_parser
from gdb_nerf_tpu_torch.datasets import make_data_loader
from gdb_nerf_tpu_torch.parallel import hosts
from gdb_nerf_tpu_torch.run import device_of, run_evaluate
from gdb_nerf_tpu_torch.runtime.registry import make_evaluator, make_network
from gdb_nerf_tpu_torch.train.recorder import Recorder
from gdb_nerf_tpu_torch.train.trainer import Trainer
from gdb_nerf_tpu_torch.utils import checkpoint


def train(cfg) -> None:
    device = hosts.maybe_initialize_distributed(device_of(cfg))
    try:
        _train(cfg, device, hosts.default_group())
    finally:
        hosts.shutdown()


def _train(cfg, device, group) -> None:
    main = hosts.is_main()
    torch.manual_seed(0)
    network = make_network(cfg, torch.float32)
    trainer = Trainer(cfg, network, device, group=group)
    recorder = Recorder(cfg, enabled=main)
    evaluator = None if cfg.skip_eval or not main else make_evaluator(cfg)
    train_loader = make_data_loader(cfg, is_train=True, max_iter=cfg.ep_iter,
                                    num_shards=hosts.world_size(), shard_id=hosts.rank())
    val_loader = make_data_loader(cfg, is_train=False)

    state, begin_epoch = checkpoint.load_model(cfg.trained_model_dir, resume=cfg.resume)
    if state is not None:
        trainer.load_state_dict(state)
        recorder.load_state_dict(state.get("recorder", {}))
    elif cfg.train.pretrain:
        net = checkpoint.load_pretrain(cfg)
        if net is not None:
            network.load_state_dict(net, strict=True)
    if group is not None:  # replicas start equal, as the JAX mesh replicates
        broadcast_state(network, group)

    for epoch in range(begin_epoch, cfg.train.epoch):
        recorder.epoch = epoch
        if hasattr(train_loader.batch_sampler, "set_epoch"):
            train_loader.batch_sampler.set_epoch(epoch)
        trainer.train_epoch(epoch, train_loader, recorder)

        if main:
            state = dict(trainer.state_dict(), recorder=recorder.state_dict())
            if (epoch + 1) % cfg.save_ep == 0:
                checkpoint.save_model(state, cfg.trained_model_dir, epoch)
            if (epoch + 1) % cfg.save_latest_ep == 0:
                checkpoint.save_model(state, cfg.trained_model_dir, epoch, last=True)
            if evaluator is not None and (epoch + 1) % cfg.eval_ep == 0:
                trainer.val(epoch, val_loader, evaluator, recorder)
        if group is not None:
            torch.distributed.barrier(group)


def broadcast_state(network: torch.nn.Module, group) -> None:
    """Every parameter and buffer of ``network`` set to rank 0's."""
    for t in [*network.parameters(), *network.buffers()]:
        torch.distributed.broadcast(t.data, 0, group=group)


def main(argv=None) -> None:
    """The CLI on ``argv`` (default ``sys.argv[1:]``)."""
    args = make_parser().parse_args(argv)
    cfg = make_cfg(args)
    if cfg.fix_random:
        random.seed(0)
        np.random.seed(0)
    if args.test:
        run_evaluate(cfg)
    else:
        train(cfg)


if __name__ == "__main__":
    main()
