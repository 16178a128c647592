"""The bf16 gate on trained weights: train in float32, render in both dtypes.

Random weights under-stress the bf16 path: their BatchNorm statistics are
untrained, and their wide confidence intervals keep the adaptive sampler
saturated.  So the gate trains first, then compares bf16 with float32 on
the trained weights (PARITY.md's recipe for the JAX package, run through
the port):

(a) train ``configs/dtu_pretrain.yaml`` with the port's ``Trainer`` in
    float32, TF32 off, from weights initialized from ``--seed`` (0), on the
    synthetic loader at 256x320 with 3 source views, 3 epochs of 120 steps
    (``RECIPE``, then any ``KEY VALUE`` overrides given after the options),
    and save ``latest.pth`` with ``utils/checkpoint.py::save_model`` into
    ``--out``; prints the first and last losses and a digest of every
    step's loss.  The training is deterministic (``deterministic``): the
    same seed, code and card give the same weights, so the gate's verdict
    can be reproduced;
(b) load it back with ``utils/checkpoint.py::load_network`` and render
    ``--scenes`` synthetic scenes of ``configs/dtu_eval.yaml`` at 512x640
    (``EVAL``) through the ``Renderer`` in float32 and in bfloat16 (the
    bundle head's kernel on the card);
(c) print one JSON row per scene, ``agree_db`` (bf16 against float32),
    ``gt_f32``, ``gt_bf16`` (PSNR against the target, the renders clipped
    to [0, 1] as the evaluator clips them) and ``gate_delta_bf16_trained``
    = |gt_bf16 - gt_f32|, then ``worst_gate_delta_bf16_trained``,
    ``gate_bar`` (0.05 dB) and ``pass``; it exits non-zero when the gate
    fails.

    python -m gdb_nerf_tpu_torch.tools.bf16_gate [--ckpt DIR_OR_PTH] [--out DIR]
        [--scenes 4] [--seed 0] [--device cuda|cpu] [KEY VALUE ...]

``--ckpt`` skips (a) and gates that checkpoint.  It runs on ``cuda`` and
stops without a GPU; ``--device cpu`` runs the plain head on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

from gdb_nerf_tpu_torch.config import load_cfg
from gdb_nerf_tpu_torch.datasets import make_data_loader
from gdb_nerf_tpu_torch.eval import metrics
from gdb_nerf_tpu_torch.kernels.bundle_head import LAUNCHES
from gdb_nerf_tpu_torch.runtime import tracing
from gdb_nerf_tpu_torch.runtime.registry import make_network
from gdb_nerf_tpu_torch.runtime.renderer import to_device
from gdb_nerf_tpu_torch.tools import measure_common as common
from gdb_nerf_tpu_torch.train.trainer import Trainer
from gdb_nerf_tpu_torch.utils.checkpoint import save_model

# (a): dtu_pretrain.yaml's overrides.  B stays the config's 4.
RECIPE = ["synthetic", "True", "synthetic_hw", "[256,320]", "train.epoch", "3", "ep_iter", "120",
          "train.sampler_meta.input_views_num", "[3]",
          "train.sampler_meta.input_views_prob", "[1.0]"]
# (b): dtu_eval.yaml's overrides.
EVAL = ["synthetic", "True", "synthetic_hw", "[512,640]"]
GATE_BAR = 0.05  # dB, PARITY.md's and the reference protocol's bar
SUMMARY = ("worst_gate_delta_bf16_trained", "gate_bar", "pass", "launches")


def recipe_cfg(opts=()):
    return load_cfg(os.path.join(common.REPO, "configs", "dtu_pretrain.yaml"), RECIPE + list(opts))


def gate_eval_cfg():
    return load_cfg(os.path.join(common.REPO, "configs", "dtu_eval.yaml"), EVAL)


@contextlib.contextmanager
def deterministic():
    """Deterministic kernels for (a): ``torch.use_deterministic_algorithms``
    (an op without a deterministic version raises; grid sampling and the
    bilinear resize take their deterministic paths) and cuDNN's
    deterministic algorithms, restored on exit.  On the card cuBLAS also
    needs ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` from the process's first
    matrix product on (``main`` sets it)."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2:]


def loss_digest(losses) -> str:
    """The first 16 hex digits of the SHA-256 of every step's loss (float64):
    equal digests, bit-equal trainings."""
    return hashlib.sha256(np.asarray(losses, np.float64).tobytes()).hexdigest()[:16]


def train(cfg, out_dir: str, device, seed: int = 0) -> dict:
    """(a) ``cfg.train.epoch`` epochs of ``cfg.ep_iter`` trainer steps from
    weights initialized from ``seed``, under ``deterministic``; saves
    ``<out_dir>/latest.pth``.  Returns each step's loss and view count, the
    step times (CUDA events, on the card) and the peak device memory."""
    device = torch.device(device)
    torch.manual_seed(seed)
    trainer = Trainer(cfg, make_network(cfg, torch.float32), device)
    loader = make_data_loader(cfg, is_train=True, max_iter=cfg.ep_iter)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, views = [], []
    with deterministic():
        for epoch in range(cfg.train.epoch):
            loader.batch_sampler.set_epoch(epoch)
            for batch in loader:
                views.append(int(batch["src_views"]["rgb"].shape[1]))
                stats = trainer.train_step(batch)
                losses.append(stats["loss"])
            print(f"[train] epoch {epoch}: loss {losses[-cfg.ep_iter]:.6f} -> {losses[-1]:.6f}, "
                  f"psnr {stats['psnr']:.3f}", flush=True)
    save_model(trainer.state_dict(), out_dir, cfg.train.epoch - 1, last=True)
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
    return {"losses": losses, "loss_digest": loss_digest(losses), "views": views,
            "step_ms": list(trainer.step_ms), "peak_gib": peak, "last_stats": stats}


def gate(cfg, state: dict, device, scenes: int) -> dict:
    """(b) and (c): the first ``scenes`` test scenes of ``cfg`` rendered with
    ``state`` in float32 and in bfloat16.  Returns the rows, the worst
    delta, the bar, ``pass``, the bundle-head kernel's launches in each
    dtype, and the clipped renders (H, W, 3) of each dtype with their
    targets."""
    batches = common.first_batches(cfg, scenes)
    renders, launches = {}, {}
    for dt in ("float32", "bfloat16"):
        renderer = common.renderer_for(SimpleNamespace(**{**vars(cfg), "compute_dtype": dt}),
                                       device, state)
        with tracing.recording() as rec:
            renders[dt] = [np.clip(renderer.render(to_device(b, device))[0]["rgb"]
                                   .float().cpu().numpy()[0], 0, 1) for b in batches]
        launches[dt] = rec.counter(LAUNCHES)
        del renderer
    rows, targets = [], [np.asarray(b["tar_views"]["rgb"][0], np.float32) for b in batches]
    for i, gt in enumerate(targets):
        f32, bf16 = renders["float32"][i], renders["bfloat16"][i]
        row = {"scene": i, "agree_db": metrics.psnr(f32, bf16), "gt_f32": metrics.psnr(gt, f32),
               "gt_bf16": metrics.psnr(gt, bf16)}
        row["gate_delta_bf16_trained"] = abs(row["gt_bf16"] - row["gt_f32"])
        rows.append(row)
    worst = max(r["gate_delta_bf16_trained"] for r in rows)
    return {"rows": rows, "worst_gate_delta_bf16_trained": worst, "gate_bar": GATE_BAR,
            "pass": worst <= GATE_BAR, "launches": launches, "renders": renders,
            "targets": targets}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None,
                    help="gate this .pth file or model directory instead of training")
    ap.add_argument("--out", default=os.path.join(common.REPO, "build", "bf16_gate"),
                    help="where (a) saves latest.pth")
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0, help="(a)'s weight initialization")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("opts", nargs="*", help="KEY VALUE overrides of (a)'s config, after RECIPE")
    args = ap.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # before the first product
    device = common.device_of(args.device)
    ckpt = args.ckpt
    if ckpt is None:
        cfg = recipe_cfg(args.opts)
        trained = train(cfg, args.out, device, args.seed)
        losses, ms = trained["losses"], trained["step_ms"][1:]
        print(json.dumps({"seed": args.seed, "batch_size": cfg.train.batch_size,
                          "steps": len(losses), "first_loss": losses[0], "last_loss": losses[-1],
                          "loss_digest": trained["loss_digest"],
                          "views": sorted(set(trained["views"])),
                          "mean_step_ms": sum(ms) / len(ms) if ms else None,
                          "peak_gib": trained["peak_gib"], "saved": args.out}), flush=True)
        ckpt = args.out
    result = gate(gate_eval_cfg(), common.load_state(ckpt), device, args.scenes)
    for row in result["rows"]:
        print(json.dumps(row))
    print(json.dumps({"ckpt": ckpt, **{k: result[k] for k in SUMMARY}}), flush=True)
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
