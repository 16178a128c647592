"""Inference CLI of the port: forward latency over a few requests.

    python -m gdb_nerf_tpu_torch.run --type network --cfg_file configs/dtu_eval.yaml synthetic True

Same surface as the JAX package's ``run.py --type network``: the YAML
config with dotted ``key value`` overrides (``synthetic True`` renders
procedural scenes when no dataset is on disk).  ``device`` selects the
device (default ``cuda``; ``device cpu`` runs the plain PyTorch path on
the CPU).  Weights come from ``trained_model_dir``: that file, or in that
directory ``<epoch>.pth`` with ``test.epoch``, else ``latest.pth``, else
the highest-numbered ``<n>.pth``; without one, from a seeded random
initialization.  Latency excludes the first request, and the batch
transfer stays outside the timer.
"""

from __future__ import annotations

import torch

from gdb_nerf_tpu_torch.config import make_cfg, make_parser
from gdb_nerf_tpu_torch.datasets import make_data_loader
from gdb_nerf_tpu_torch.runtime.registry import make_network
from gdb_nerf_tpu_torch.runtime.renderer import Renderer, to_device
from gdb_nerf_tpu_torch.utils.checkpoint import load_network


def load_weights(network: torch.nn.Module, cfg) -> None:
    """Load the reference-format checkpoint ({'net': state_dict, ...}) that
    ``utils.checkpoint.load_network`` picks; keep the random initialization
    when there is none."""
    try:
        state, path = load_network(cfg.trained_model_dir, cfg.test.epoch)
    except FileNotFoundError:
        print(f"[run] no checkpoint in {cfg.trained_model_dir}; using randomly initialized weights")
        return
    network.load_state_dict(state, strict=True)
    print(f"[run] loaded {path}")


def run_network(cfg) -> None:
    device = torch.device(getattr(cfg, "device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass `device cpu` to run on the CPU")
    torch.manual_seed(0)
    network = make_network(cfg)
    load_weights(network, cfg)
    renderer = Renderer(network, device)
    times = []
    for batch in make_data_loader(cfg, is_train=False):
        dev_batch = to_device(batch, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        (ret, _), ms, _ = renderer.render_timed(dev_batch)
        times.append(ms)
        if not torch.isfinite(ret["rgb"]).all():
            raise RuntimeError("non-finite rgb in the rendered view")
    timed = times[1:] if len(times) > 1 else times
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"Mean forward latency: {sum(timed) / len(timed) / 1e3:.4f} s over "
          f"{len(timed)} batches ({where}, {network.compute_dtype}, first request excluded)")


def main() -> None:
    args = make_parser().parse_args()
    cfg = make_cfg(args)
    if args.type != "network":
        raise SystemExit(f"Unknown --type {args.type!r}; the port runs 'network'")
    run_network(cfg)


if __name__ == "__main__":
    main()
