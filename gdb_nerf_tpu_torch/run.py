"""Inference and evaluation CLI of the port.

    python -m gdb_nerf_tpu_torch.run --type dataset  --cfg_file configs/dtu_eval.yaml
    python -m gdb_nerf_tpu_torch.run --type network  --cfg_file configs/dtu_eval.yaml synthetic True
    python -m gdb_nerf_tpu_torch.run --type evaluate --cfg_file configs/dtu_eval.yaml synthetic True

Same surface as the JAX package's ``run.py``: the YAML config with dotted
``key value`` overrides (``synthetic True`` renders procedural scenes when
no dataset is on disk).  ``dataset`` walks the test loader; ``network``
prints the mean forward latency; ``evaluate`` prints PSNR and SSIM per
scene, LPIPS with ``eval_lpips`` (``eval/lpips.py``; it reads SKIPPED only
when its weights file is missing) and the FPS.  ``device``
selects the device (default ``cuda``; ``device cpu`` runs the plain
PyTorch path on the CPU).  Weights come from ``trained_model_dir``: that
file, or in that directory ``<epoch>.pth`` with ``test.epoch``, else
``latest.pth``, else the highest-numbered ``<n>.pth``; without one, from a
seeded random initialization.  Latency and FPS exclude the first request,
and the batch transfer stays outside the timer.
"""

from __future__ import annotations

import time

import torch

from gdb_nerf_tpu_torch.config import make_cfg, make_parser
from gdb_nerf_tpu_torch.datasets import make_data_loader
from gdb_nerf_tpu_torch.runtime.registry import make_evaluator, make_network
from gdb_nerf_tpu_torch.runtime.renderer import Renderer, to_device
from gdb_nerf_tpu_torch.utils.checkpoint import load_network


def device_of(cfg) -> torch.device:
    """The configured device (default ``cuda``); stops if it is a GPU that
    is not there."""
    device = torch.device(getattr(cfg, "device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass `device cpu` to run on the CPU")
    return device


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


def build_renderer(cfg) -> Renderer:
    device = device_of(cfg)
    torch.manual_seed(0)
    network = make_network(cfg)
    load_weights(network, cfg)
    return Renderer(network, device)


def timed_requests(renderer: Renderer, loader):
    """Render every batch of ``loader``: yields (batch, ret, ms)."""
    for batch in loader:
        dev_batch = to_device(batch, renderer.device)
        if renderer.device.type == "cuda":
            torch.cuda.synchronize(renderer.device)
        (ret, _), ms, _ = renderer.render_timed(dev_batch)
        if not torch.isfinite(ret["rgb"]).all():
            raise RuntimeError("non-finite rgb in the rendered view")
        yield batch, ret, ms


def where(renderer: Renderer) -> str:
    d = renderer.device
    return torch.cuda.get_device_name(d) if d.type == "cuda" else "cpu"


def run_dataset(cfg) -> None:
    t0 = time.time()
    n = sum(1 for _ in make_data_loader(cfg, is_train=False))
    print(f"Loaded {n} batches in {time.time() - t0:.2f} s")


def run_network(cfg) -> None:
    renderer = build_renderer(cfg)
    times = [ms for _, _, ms in timed_requests(renderer, make_data_loader(cfg, is_train=False))]
    timed = times[1:] if len(times) > 1 else times
    print(f"Mean forward latency: {sum(timed) / len(timed) / 1e3:.4f} s over "
          f"{len(timed)} batches ({where(renderer)}, {renderer.network.compute_dtype}, "
          "first request excluded)")


def evaluate(cfg, renderer: Renderer, loader) -> dict:
    """Evaluate the batches of ``loader``; returns the evaluator's summary."""
    evaluator = make_evaluator(cfg)
    times = []
    for batch, ret, ms in timed_requests(renderer, loader):
        evaluator.evaluate({k: v.float().cpu().numpy() for k, v in ret.items()}, batch)
        times.append(ms)
    result = evaluator.summarize()
    timed = times[1:] if len(times) > 1 else times
    print(f"FPS: {1e3 * len(timed) / sum(timed):.4f} over {len(timed)} batches "
          f"({where(renderer)}, {renderer.network.compute_dtype}, first request excluded)")
    return result


def run_evaluate(cfg) -> dict:
    """Evaluate the test split; returns the evaluator's summary."""
    return evaluate(cfg, build_renderer(cfg), make_data_loader(cfg, is_train=False))


RUNNERS = {"dataset": run_dataset, "network": run_network, "evaluate": run_evaluate}


def main(argv=None):
    """The CLI on ``argv`` (default ``sys.argv[1:]``); returns what the runner
    returns (``evaluate``: the evaluator's summary)."""
    args = make_parser().parse_args(argv)
    cfg = make_cfg(args)
    if args.type not in RUNNERS:
        raise SystemExit(f"Unknown --type {args.type!r}; expected one of {sorted(RUNNERS)}")
    return RUNNERS[args.type](cfg)


if __name__ == "__main__":
    main()
