"""The ``train`` kind: ``Trainer.train_step`` on batches from the program's
loader over ``scenes`` seeded scenes at ``hw`` (``train_data.py``), in a
workspace that holds the seeded VGG16 weights of the perceptual loss.

The first ``check_steps`` steps, and one step at each view count the
sampler can draw that they did not, run before the window; the reference
follows the first ones once the window has closed.  ``min_step_s`` bounds
the steps the loader is asked for.
"""

from __future__ import annotations

import math
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import check, common, trace
from benchmark.reference import precision
from benchmark.reference import weights as seeded
from benchmark.work import model

# The optimizer's first-moment decay: adam's state after one step is
# (1 - beta1) times the gradient it got.
ADAM_BETA1 = 0.9


def write_vgg(layers: list, workspace) -> None:
    """The seeded VGG16 weights where the program's loss looks for them."""
    path = workspace / "weights"
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "vgg16.npz", **seeded.vgg_npz(layers))


def run(cell, seed: int, seconds: float, traced: bool, device: torch.device,
        t_start: float, controls: bool = False) -> dict:
    with tempfile.TemporaryDirectory(prefix="gdbn_bench_ws_") as ws:
        return run_in(cell, seed, seconds, traced, device, t_start, Path(ws), controls)


def run_in(cell, seed: int, seconds: float, traced: bool, device: torch.device,
           t_start: float, workspace: Path, controls: bool = False) -> dict:
    from gdb_nerf_tpu_torch.datasets import make_data_loader
    from gdb_nerf_tpu_torch.datasets.loader import collate
    from gdb_nerf_tpu_torch.train.trainer import Trainer

    mix = cell.mix
    H, W = mix["hw"]
    cfg = dict(cell.config["cfg"])
    cfg["train_dataset"] = {**cfg["train_dataset"], "seed": seed, "scenes_n": mix["scenes"],
                            "hw": [H, W], "device": str(device)}
    cfg["synthetic_hw"] = [H, W]
    B = cfg["train"]["batch_size"]
    vgg = seeded.vgg(seed, device)
    write_vgg(vgg, workspace)
    os.environ["workspace"] = str(workspace)
    # The program reads the VGG file once a process; a second run in one
    # process (``calibrate.py``) has to make it read this run's file.
    from gdb_nerf_tpu_torch.train import losses as program_losses

    program_losses._vgg_weights.cache_clear()
    state = common.seeded_state(cfg, seed, device)
    net = common.program_network(cfg, torch.float32, state, device)
    trainer = Trainer(common.namespace(cfg), net, device, use_perceptual=True)
    n_steps = mix["check_steps"] + math.ceil((seconds + mix["trace_seconds"]) / mix["min_step_s"])
    loader = make_data_loader(trainer.cfg, is_train=True, max_iter=n_steps)
    batches = iter(loader)

    # The first steps, which the reference follows, then one step at each
    # view count the sampler can draw that they did not.
    params = dict(trainer.network.named_parameters())
    fed, losses, grad1 = [], [], None
    for k in range(mix["check_steps"]):
        fed.append(next(batches))
        losses.append(trainer.train_step(fed[-1])["loss"])
        if k == 0:  # no first moment: the optimizer took no step
            st = trainer.optimizer.state
            grad1 = {n: st.get(p, {}).get("exp_avg", torch.zeros_like(p)).detach()
                     / (1 - ADAM_BETA1) for n, p in params.items()}
    p3 = {n: p.detach().clone() for n, p in params.items()}
    seen = {b["src_views"]["rgb"].shape[1] for b in fed}
    for views in cfg["train"]["sampler_meta"]["input_views_num"]:
        if views not in seen:
            trainer.train_step(collate([loader.dataset[(i, views, 1.0)] for i in range(B)]))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - t_start

    def window(length, traced_now):
        views, waits, bad = [], [], 0
        t0 = time.perf_counter()
        t_end = t0
        while t_end - t0 < length:
            with trace.mark("bench.data_wait", traced_now):
                tw = time.perf_counter()
                batch = next(batches)
                waits.append((time.perf_counter() - tw) * 1e3)
            with trace.mark("bench.train_step", traced_now):
                loss = trainer.train_step(batch)["loss"]
            bad += not math.isfinite(loss)
            views.append(batch["src_views"]["rgb"].shape[1])
            t_end = time.perf_counter()
        return {"views": views, "data_wait_ms": waits, "bad": bad, "window_s": t_end - t0}

    common.reset_peak(device)
    win = window(seconds, False)
    window_peak = common.peak_bytes(device)
    summary, traced_units = None, 0
    if traced:
        with trace.profiler(device) as prof:
            with trace.mark(trace.WINDOW, True):
                traced_units = len(window(mix["trace_seconds"], True)["views"])
        summary = trace.summarize(prof)
    memory_peak = common.peak_bytes(device)
    for _ in batches:  # the loader's threads end with its last batch
        pass
    n = len(win["views"])
    obs = {
        "setup_s": setup_s, "window_s": win["window_s"],
        "count": {"steps": n, "images": n * B},
        "series": {"data_wait_ms": win["data_wait_ms"]},
        "flops": sum(model.train_step_flops(cfg, B, H, W, v) for v in win["views"]),
        "window_peak_bytes": window_peak, "trace": summary,
    }
    prog = {"losses": losses, "grad1": grad1, "p3": p3}
    dataset = loader.dataset
    del trainer, net, loader, batches, params
    common.free(device)

    from benchmark import train_data
    from benchmark.reference import train_step

    rebuilt = [train_data.collate([dataset.item(i, b["src_views"]["rgb"].shape[1])
                                   for i in b["meta"]["scene"]]) for b in fed]
    feed_mismatch = float(not all(train_data.same_arrays(f, r) for f, r in zip(fed, rebuilt)))
    lr = train_step.exponential_lr(cfg["train"], cfg["ep_iter"])

    def reference(batches_, tf32=False):
        net = common.reference_network(cfg, device)
        net.load_state_dict(state, strict=True)
        net.train()
        dev = [train_step.device_batch(b, device) for b in batches_]
        with precision.tf32() if tf32 else precision.float32_exact():
            ls, g1 = train_step.run_steps(net, dev, cfg["mvs"]["loss_weight"], vgg, lr,
                                          cfg["train"]["eps"])
        out = {"losses": ls, "grad1": g1,
               "p3": {n_: p.detach().clone() for n_, p in net.named_parameters()}}
        del net, dev
        common.free(device)
        return out

    ref = reference(rebuilt)
    readings, extra = check.train_readings(prog, ref, state)
    readings["feed_mismatch"] = feed_mismatch
    if controls:
        extra["tf32"] = check.train_readings(reference(rebuilt, tf32=True), ref, state)[0]
        half = [{k: _rows(v, B // 2) for k, v in b.items() if k != "meta"} for b in rebuilt]
        extra["half_batch"] = check.train_readings(reference(half), ref, state)[0]
    return {"obs": obs, "readings": readings, "controls": extra, "attempted": n,
            "failed": win["bad"], "memory_peak": memory_peak, "traced_units": traced_units}


def _rows(x, n: int):
    """The first ``n`` rows of every array of a batch field."""
    if isinstance(x, dict):
        return {k: _rows(v, n) for k, v in x.items()}
    if isinstance(x, list):
        return [_rows(v, n) for v in x]
    return np.asarray(x)[:n]
