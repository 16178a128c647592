"""Per-stage latency of the eval forward on one device.

The port's counterpart of ``tools/profile_forward.py``.  It builds the
network of ``configs/dtu_eval.yaml`` from seed 0 on the synthetic loader's
first request at ``--size`` (``--views`` source views, at most
``--samples`` samples a bundle, ``--dtype`` the compute dtype) and runs the
forward stage by stage through the ``Network``'s own stage methods, each
stage on the previous stage's real outputs, so the stages chained are the
forward (``run_stages``):

  FPN features, cost volume stage0, CostRegSmall stage0, cost volume
  stage1 (the interval of stage 0 resized, then the volume), CostRegNet
  stage1 (each with its depth regression), ray bundles (the bundle grid and
  its depth windows), texture pyramid, bundle sampling, encode samples,
  NeRF head + composite (the bundle head's kernel on the card), RDN decoder
  (with the member-RGB unpack and the full-resolution maps).

Each stage runs once (its output feeds the next), then ``--iters`` times
back to back in each of ``ROUNDS`` rounds, under ``torch.inference_mode``
as the ``Renderer`` runs it.  Per stage it prints the best round's mean:
``ms``, CUDA events around the repeats with the stream left free (as the
forward runs: a stage whose host enqueue is longer than its device work
shows the host's time), ``enqueue_ms``, the host time to queue one repeat,
and ``busy_ms``, the device time of a repeat with the stream held by a spin
kernel while the host queues (``kernels/measure.py::timed_ms``: the device's
work alone).  Then the stages' sums beside the whole forward's
``Renderer.render_timed`` latency and enqueue time (the mean over
``--iters`` requests after a first one), the bundle head's kernel launches
in the stages' first calls (counted under ``tracing.recording()``, which
the timed repeats run without), and one JSON line of the table.  On the
CPU every time is the host clock.

    python -m gdb_nerf_tpu_torch.tools.profile_forward [--size H W] [--views V]
        [--iters N] [--samples S] [--dtype bfloat16|float32] [--device cuda|cpu]

Defaults: dtu_eval at 512x640, V = 3, S = 3, bf16.  It runs on ``cuda`` and
stops without a GPU; ``--device cpu`` runs the plain head on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from gdb_nerf_tpu_torch.kernels.bundle_head import LAUNCHES
from gdb_nerf_tpu_torch.kernels.measure import timed_ms
from gdb_nerf_tpu_torch.runtime import tracing
from gdb_nerf_tpu_torch.runtime.renderer import to_device
from gdb_nerf_tpu_torch.tools import ab_common
from gdb_nerf_tpu_torch.tools import measure_common as common

CONFIG = "dtu_eval"
ROUNDS = 3  # timed rounds of a stage; the best one is reported


def stage_names(n_mvs: int = 2) -> list[str]:
    """The stages in the order the forward runs them, for ``n_mvs`` cascade
    stages."""
    mvs = []
    for idx in range(n_mvs):
        reg = "CostRegSmall" if idx == 0 else "CostRegNet"
        mvs += [f"cost volume stage{idx}", f"{reg} stage{idx}"]
    return ["FPN features", *mvs, "ray bundles", "texture pyramid", "bundle sampling",
            "encode samples", "NeRF head + composite", "RDN decoder"]


def run_stages(network, batch: dict, step) -> dict:
    """The eval forward of ``network`` on the device batch ``batch``, stage
    by stage: ``step(name, fn)`` runs each stage's ``fn`` (at least once)
    and returns its output, which the next stage takes.  Returns the
    forward's ``ret``."""
    net = network
    frame = net.frame(batch)
    hw = tuple(frame.src_images.shape[2:4])
    first, rows = net._bundle_rows(hw[0] // net.bundle_size, False)
    feats = step("FPN features", lambda: net.features(frame))
    dn = net.depth_net
    names = stage_names(len(dn.vol_levels))[1:]
    mvs = {"depths": [], "depth_ranges": [], "vol_ranges": [], "volumes": []}
    ci = None
    for idx in range(len(dn.vol_levels)):
        def volume(idx=idx, ci=ci):
            dr = (frame.near_far[:, :, None, None] if idx == 0
                  else dn.next_depth_range(idx - 1, ci))
            return dn.stage_volume(idx, feats, frame.src_exts, frame.src_ints, frame.tar_exts,
                                   frame.tar_ints, dr, hw)

        depth_values, vol = step(names[2 * idx], volume)
        fv, depth, ci, vr = step(names[2 * idx + 1],
                                 lambda: dn.stage_regularize(idx, vol, depth_values))
        for key, value in zip(("volumes", "depths", "depth_ranges", "vol_ranges"),
                              (fv, depth, ci, vr)):
            mvs[key].append(value)
    windows = step("ray bundles", lambda: net.bundle_windows(frame, mvs))
    pyramid = step("texture pyramid", lambda: net.texture_pyramid(frame, feats))
    slabs = net.slabs(windows, first, rows)
    samples = step("bundle sampling", lambda: [net.sample(s) for s in slabs])
    encs = step("encode samples", lambda: [net.encode(frame, s, smp, pyramid)
                                           for s, smp in zip(slabs, samples)])
    outs = step("NeRF head + composite", lambda: [net.head_composite(smp, enc)
                                                  for smp, enc in zip(samples, encs)])
    return step("RDN decoder", lambda: net.decode(frame, windows, outs))


def time_repeats(fn, device: torch.device, iters: int) -> dict:
    """``fn``'s mean time over ``iters`` back-to-back calls, best of
    ``ROUNDS``: ``ms`` (CUDA events, the stream free), ``enqueue_ms`` (host)
    and ``busy_ms`` (the stream held while the host queues)."""
    best = None
    for _ in range(ROUNDS):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            enqueue = (time.perf_counter() - t0) * 1e3 / iters
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = enqueue = (time.perf_counter() - t0) * 1e3 / iters
        if best is None or ms < best["ms"]:
            best = {"ms": ms, "enqueue_ms": enqueue}
    return {**best, "busy_ms": timed_ms(fn, device, iters)}


def profile(renderer, dev_batch: dict, iters: int = 5) -> dict:
    """Time each stage of ``renderer``'s network on ``dev_batch`` (see the
    module's docstring) and the whole forward; returns the table."""
    device = renderer.device
    table, launches = [], 0

    def step(name, fn):
        nonlocal launches
        with tracing.recording() as rec:  # the first call, untimed: K1's launches
            out = fn()
        launches += rec.counter(LAUNCHES)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        table.append({"stage": name, **time_repeats(fn, device, iters)})
        row = table[-1]
        print(f"{name:<24} {row['ms']:9.3f} ms  enqueue {row['enqueue_ms']:8.3f} ms  "
              f"busy {row['busy_ms']:9.3f} ms", flush=True)
        return out

    with torch.inference_mode():
        run_stages(renderer.network, dev_batch, step)
    forward = [renderer.render_timed(dev_batch)[1:] for _ in range(iters + 1)][1:]
    fwd_ms = sum(t[0] for t in forward) / len(forward)
    fwd_enqueue = sum(t[1] for t in forward) / len(forward)
    sums = {k: sum(r[k] for r in table) for k in ("ms", "enqueue_ms", "busy_ms")}
    print(f"{'sum of the stages':<24} {sums['ms']:9.3f} ms  enqueue {sums['enqueue_ms']:8.3f} ms  "
          f"busy {sums['busy_ms']:9.3f} ms", flush=True)
    print(f"{'whole forward':<24} {fwd_ms:9.3f} ms  enqueue {fwd_enqueue:8.3f} ms  "
          f"(Renderer.render_timed, mean of {len(forward)} after a first)", flush=True)
    return {"stages": table, "sum_ms": sums["ms"], "sum_enqueue_ms": sums["enqueue_ms"],
            "sum_busy_ms": sums["busy_ms"], "forward_ms": fwd_ms,
            "forward_enqueue_ms": fwd_enqueue, "forward_each_ms": [t[0] for t in forward],
            "head_launches": launches}


def profile_cfg(size, views: int, samples: int, dtype: str):
    """dtu_eval on the synthetic loader at ``size`` with ``views`` source
    views, at most ``samples`` samples a bundle, in ``dtype``."""
    return common.eval_cfg(CONFIG, [
        "synthetic_hw", f"[{size[0]},{size[1]}]", "test.sampler_meta.input_views_num",
        f"[{views}]", "nerf.max_num_samples", str(samples), "compute_dtype", dtype])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, nargs=2, default=[512, 640])
    ap.add_argument("--views", type=int, default=3)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--samples", type=int, default=3)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = common.device_of(args.device)
    cfg = profile_cfg(args.size, args.views, args.samples, args.dtype)
    renderer = common.renderer_for(cfg, device, None)
    dev_batch = to_device(common.first_batches(cfg, 1)[0], device)
    smi = ab_common.card_name() if device.type == "cuda" else "cpu"
    H, W = args.size
    print(f"device: {device} ({smi})  {CONFIG} {H}x{W}  V={args.views}  S={args.samples}  "
          f"dtype={args.dtype}  iters={args.iters}", flush=True)
    result = profile(renderer, dev_batch, args.iters)
    print(f"bundle-head kernel launches in the stages' first calls: {result['head_launches']}",
          flush=True)
    result = {"config": CONFIG, "size": [H, W], "views": args.views, "samples": args.samples,
              "dtype": args.dtype, "device": str(device), "card": smi, "iters": args.iters,
              "rounds": ROUNDS, **result}
    print(json.dumps({"profile_forward": result}), flush=True)
    return result


if __name__ == "__main__":
    main()
