"""Sub-stage latency of ``encode_samples`` on one device.

The port's counterpart of ``tools/profile_encode.py``.  It runs the eval
forward of ``configs/dtu_eval.yaml`` from seed 0 on the synthetic loader's
first request at ``--size`` up to the samples of the first row slab (as
``tools/profile_forward.py`` does), then times, each ``--iters`` times back
to back after a warm-up, best of 3 rounds (``profile_forward.time_repeats``:
``ms``, ``enqueue_ms``, ``busy_ms``), the full encode and its pieces in the
order ``encode_samples`` runs them (``ops/bundles.py``):

  vox fetch       ``fetch_vox``: the trilinear cost-volume tap per sample;
  proj math       ``project_samples``: sphere centers, member projections, LOD;
  member rgb (xV) ``fetch_member_rgb``: b*b bilinear RGB taps per sample and view;
  mip fetch (xV)  ``fetch_mip``: the pyramid's bilinear tap at every level
                  (``ops/mip.py::mip_texture_fetch``), weighted by the tent;
  ray diff        ``ray_difference``.

Beside each fetch it prints its texel rows (4 a bilinear tap, 8 a trilinear
one) and their rate.  Beside the mip fetch it also prints the share of its
taps, and so of its rows, that land on levels of zero tent weight, counted
from the LOD that the projection piece computes: the rows a two-level fetch
would not read.  It ends with one JSON line.  On the CPU every time is the
host clock.

    python -m gdb_nerf_tpu_torch.tools.profile_encode [--size H W] [--views V]
        [--iters N] [--samples S] [--dtype bfloat16|float32] [--device cuda|cpu]

Defaults: dtu_eval at 512x640, V = 3, S = 3, bf16.  It runs on ``cuda`` and
stops without a GPU; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json

import torch

from gdb_nerf_tpu_torch.ops import bundles
from gdb_nerf_tpu_torch.runtime.renderer import to_device
from gdb_nerf_tpu_torch.tools import ab_common
from gdb_nerf_tpu_torch.tools import measure_common as common
from gdb_nerf_tpu_torch.tools.profile_forward import CONFIG, profile_cfg, time_repeats


def encode_inputs(network, batch: dict) -> dict:
    """What the encode of the first row slab takes in the eval forward of
    ``network`` on the device batch ``batch``."""
    net = network
    with torch.inference_mode():
        frame = net.frame(batch)
        B, V, H, W, _ = frame.src_images.shape
        feats = net.features(frame)
        mvs = net.depth_net(frame.src_nchw.reshape(B, V, 3, H, W), feats, frame.src_exts,
                            frame.src_ints, frame.tar_exts, frame.tar_ints, frame.near_far)
        windows = net.bundle_windows(frame, mvs)
        pyramid = net.texture_pyramid(frame, feats)
        first, rows = net._bundle_rows(H // net.bundle_size, False)
        slab = net.slabs(windows, first, rows)[0]
        samples = net.sample(slab)
    return {"frame": frame, "slab": slab, "samples": samples, "pyramid": pyramid,
            "feat_volume": slab.feat_volume.to(net.compute_dtype),
            "max_level": net.max_mipmap_level}


def pieces(inp: dict) -> tuple[dict, bundles.SampleProjection]:
    """The full encode and its pieces as calls without arguments, in the
    order ``encode_samples`` runs them; the pieces after the projection
    take its output from one call made here."""
    f, rb, smp = inp["frame"], inp["slab"].rb, inp["samples"]
    img_hw, tex_hw = f.src_images.shape[2:4], inp["pyramid"][0].shape[-2:]

    def project():
        return bundles.project_samples(rb, smp, f.src_exts, f.src_ints, img_hw, tex_hw)

    with torch.inference_mode():
        proj = project()
    return {
        "encode full": lambda: bundles.encode_samples(
            rb, smp, f.src_images, inp["pyramid"], inp["feat_volume"], f.src_exts, f.src_ints,
            inp["max_level"]),
        "vox fetch": lambda: bundles.fetch_vox(inp["feat_volume"], smp),
        "proj math": project,
        "member rgb (xV)": lambda: bundles.fetch_member_rgb(f.src_images, proj),
        "mip fetch (xV)": lambda: bundles.fetch_mip(inp["pyramid"], proj, inp["max_level"]),
        "ray diff": lambda: bundles.ray_difference(rb, f.src_exts, proj),
    }, proj


def zero_weight_share(lod: torch.Tensor, max_level: int) -> float:
    """The share of the mip fetch's (sample, level) taps whose tent weight
    max(0, 1 - |clamp(lod) - level|) is 0."""
    lod = torch.clamp(lod.reshape(-1, 1).double(), 0.0, float(max_level))
    levels = torch.arange(max_level + 1, dtype=lod.dtype, device=lod.device)
    weight = torch.clamp_min(1.0 - torch.abs(lod - levels), 0.0)
    return float((weight == 0).double().mean())


def texel_rows(inp: dict, proj) -> dict:
    """Texel rows that each fetch reads: 4 a bilinear tap, 8 a trilinear."""
    B, V, H, W, S, bsq = proj.grid.shape[:6]
    n = B * H * W * S
    return {"vox fetch": 8 * n, "member rgb (xV)": 4 * V * n * bsq,
            "mip fetch (xV)": 4 * V * n * (inp["max_level"] + 1)}


def profile(inp: dict, device, iters: int = 5) -> dict:
    """Time the full encode and its pieces (see the module's docstring)."""
    calls, proj = pieces(inp)
    rows = texel_rows(inp, proj)
    share = zero_weight_share(proj.lod, inp["max_level"])
    table = []
    with torch.inference_mode():
        for name, fn in calls.items():
            fn()
            row = {"piece": name, **time_repeats(fn, device, iters)}
            note = ""
            if name in rows:
                row["texel_rows"] = rows[name]
                row["m_rows_per_s"] = rows[name] / row["busy_ms"] / 1e3
                note = f"  {rows[name]:>11,} texel rows  {row['m_rows_per_s']:9.1f} M rows/s"
            if name.startswith("mip"):
                row["zero_weight_share"] = share
                note += f"  zero-weight share {share:.4f}"
            table.append(row)
            print(f"{name:<18} {row['ms']:9.3f} ms  enqueue {row['enqueue_ms']:8.3f} ms  "
                  f"busy {row['busy_ms']:9.3f} ms{note}", flush=True)
    parts = sum(r["busy_ms"] for r in table[1:])
    print(f"{'sum of the pieces':<18} busy {parts:9.3f} ms  (the full encode: "
          f"{table[0]['busy_ms']:.3f} ms)", flush=True)
    return {"pieces": table, "sum_busy_ms": parts, "zero_weight_share": share,
            "max_level": inp["max_level"], "n_samples": rows["vox fetch"] // 8}


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
    inp = encode_inputs(renderer.network, to_device(common.first_batches(cfg, 1)[0], device))
    smi = ab_common.card_name() if device.type == "cuda" else "cpu"
    H, W = args.size
    print(f"device: {device} ({smi})  {CONFIG} {H}x{W}  V={args.views}  S={args.samples}  "
          f"dtype={args.dtype}  iters={args.iters}", flush=True)
    result = {"config": CONFIG, "size": [H, W], "views": args.views, "dtype": args.dtype,
              "device": str(device), "card": smi, "iters": args.iters,
              **profile(inp, device, args.iters)}
    print(json.dumps({"profile_encode": result}), flush=True)
    return result


if __name__ == "__main__":
    main()
