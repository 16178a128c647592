"""Training-step time of the port on one device.

    python -m gdb_nerf_tpu_torch.tools.measure_train_step [--batch B] [--size H W] [--n N]
        [--dtype float32|bfloat16] [--chunk C] [--perceptual] [--sustain S] [--device cuda|cpu]

The counterpart of the JAX package's ``tools/measure_train_step.py``: the
port's ``Trainer`` on ``configs/dtu_pretrain.yaml`` with the synthetic
loader's first batch at ``--size`` (``--batch`` items; ``--dtype`` the
compute dtype, bf16 on float32 master weights; ``--chunk`` overrides
``nerf.chunk_size``; ``--perceptual`` adds the VGG term, which needs
``$workspace/weights/vgg16.npz``).  It prints the warm loss (the first
step, which also builds and tunes), the peak device memory
(``torch.cuda.max_memory_allocated``) and the best of two rounds of ``--n``
steps on that batch, already on the device, queued back to back and timed
by CUDA events (by the host clock on the CPU): ms a step, steps/s and
samples/s.  ``--sustain S`` then takes S steps over 4 rotating batches,
with the loss and PSNR every 10 steps.  Each timing line names the card
(``nvidia-smi``'s name and power limit).  The last line is the result as
JSON.  The default device is ``cuda``; without a GPU the tool stops unless
given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time

import torch

from gdb_nerf_tpu_torch.tools import ab_common
from gdb_nerf_tpu_torch.tools import measure_common as common

PRETRAIN = os.path.join(common.REPO, "configs", "dtu_pretrain.yaml")


def train_cfg(batch: int, hw, dtype: str, chunk: int = 0):
    """``configs/dtu_pretrain.yaml`` on the synthetic loader at ``hw``."""
    from gdb_nerf_tpu_torch.config import load_cfg

    opts = ["synthetic", "True", "synthetic_hw", f"[{hw[0]},{hw[1]}]", "train.batch_size",
            str(batch), "train.num_workers", "0", "compute_dtype", dtype]
    if chunk:
        opts += ["nerf.chunk_size", str(chunk)]
    return load_cfg(PRETRAIN, opts)


def _timed(device: torch.device, fn) -> float:
    """ms that ``fn`` took on ``device``: CUDA events on the card."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def measure(cfg, device, n: int = 4, perceptual: bool = False, sustain: int = 0) -> dict:
    """Time the trainer's step on ``cfg`` (see the module's docstring);
    returns the numbers it prints."""
    from gdb_nerf_tpu_torch.datasets import make_data_loader
    from gdb_nerf_tpu_torch.runtime.registry import make_network
    from gdb_nerf_tpu_torch.train.step import to_device_train
    from gdb_nerf_tpu_torch.train.trainer import Trainer

    device = torch.device(device)
    B, (H, W) = cfg.train.batch_size, cfg.synthetic_hw
    smi = ab_common.card_name() if device.type == "cuda" else "cpu"
    torch.manual_seed(0)
    trainer = Trainer(cfg, make_network(cfg, torch.float32), device, use_perceptual=perceptual)
    loader = make_data_loader(cfg, is_train=True, max_iter=4)
    loader.num_workers = 0
    batches = [to_device_train(b, device) for b in itertools.islice(loader, 4)]
    print(f"device: {device} ({smi})  B={B}  {H}x{W}  {cfg.compute_dtype}", flush=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    warm = float(trainer.step_fn(batches[0])["loss"])
    print(f"warm loss: {warm:.4f}", flush=True)

    def steps():
        for _ in range(n):
            trainer.step_fn(batches[0])

    best = min(_timed(device, steps) / n for _ in range(2))
    peak = (torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda"
            else None)
    print("peak device memory: " + (f"{peak:.2f} GiB (torch.cuda.max_memory_allocated)"
                                    if peak is not None else "not measured on the CPU"),
          flush=True)
    print(f"train step: {best:.2f} ms  ({1e3 / best:.2f} steps/s, {B * 1e3 / best:.2f} "
          f"samples/s), best of 2 rounds of {n} on {smi}", flush=True)
    result = {"batch": B, "hw": [H, W], "dtype": cfg.compute_dtype, "warm_loss": warm,
              "peak_gib": peak, "step_ms": best, "steps_per_s": 1e3 / best,
              "samples_per_s": B * 1e3 / best, "n": n, "card": smi}
    if sustain:
        result["sustain"] = sustained(trainer, batches, device, sustain, smi, B)
    print(json.dumps({"measure_train_step": result}), flush=True)
    return result


def sustained(trainer, batches, device, steps: int, smi: str, B: int) -> dict:
    """``steps`` steps over the rotating ``batches``, the loss and PSNR
    every 10 steps; returns the mean ms a step and the trend."""
    trend, total = [], 0.0
    for i in range(steps):
        out = {}
        total += _timed(device, lambda: out.update(trainer.step_fn(batches[i % len(batches)])))
        if (i + 1) % 10 == 0 or i + 1 == steps:
            trend.append({"step": i + 1, "loss": float(out["loss"]), "psnr": float(out["psnr"])})
            print(f"step {i + 1:4d}: loss {trend[-1]['loss']:.4f} psnr {trend[-1]['psnr']:.2f} "
                  f"({total / (i + 1):.1f} ms/step avg)", flush=True)
    ms = total / steps
    print(f"sustained {steps} steps: {ms:.2f} ms/step ({1e3 / ms:.2f} steps/s, "
          f"{B * 1e3 / ms:.2f} samples/s) on {smi}", flush=True)
    return {"steps": steps, "step_ms": ms, "trend": trend}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--size", type=int, nargs=2, default=[256, 320],
                    help="training frame (H W); the recipe trains at 512x640")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--chunk", type=int, default=0, help="nerf.chunk_size override")
    ap.add_argument("--perceptual", action="store_true")
    ap.add_argument("--sustain", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = common.device_of(args.device)
    cfg = train_cfg(args.batch, args.size, args.dtype, args.chunk)
    return measure(cfg, device, args.n, args.perceptual, args.sustain)


if __name__ == "__main__":
    main()
