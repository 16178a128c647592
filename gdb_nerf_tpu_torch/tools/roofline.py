"""Static bytes-moved and gather-row accounting for one eval frame, as floors.

The port's counterpart of ``tools/roofline.py``, with its stage list and its
per-stage arithmetic unchanged: per pipeline stage, the least device-memory
traffic (activation reads and writes that cannot be fused away, bf16
activations, the packed gather tables of the JAX design) and the gather-row
count, for ``--size``, ``--views`` and ``--samples``.  Pure arithmetic over
the config's shapes: no device.  It is a model of the frame's work, not a
count of what the port's own calls move (those sample float32 NCHW tables).

Floor per stage = max(bytes / BW, rows / RR, rows x row bytes / GBW), with

  * BW, the memory rate: ``--bw``, by default the H100's
    (``kernels/measure.py::H100_BYTES_PER_S``);
  * RR, the gather row rate, and GBW, the gathered bytes a second: from
    ``--envelope FILE`` (a file holding ``tools/microbench.py``'s JSON line:
    its ``rr`` and ``gbw``, the best of the card's gather calls) or from
    ``--rr`` and ``--gbw``, which win over the file.

With neither RR nor GBW it prints bytes and rows only.  The last line is the
table as JSON, each stage with the ``tools/profile_forward.py`` stage it
belongs to (``PROFILE_STAGE``).

    python -m gdb_nerf_tpu_torch.tools.roofline [--size H W] [--views V] [--samples S]
        [--bw B/s] [--envelope FILE | --rr ROWS/s --gbw B/s]
"""

from __future__ import annotations

import argparse
import json

from gdb_nerf_tpu_torch.kernels.measure import H100_BYTES_PER_S

# The profile_forward stage that runs each roofline stage's work.
PROFILE_STAGE = {
    "FPN convs": "FPN features", "cost volume s0": "cost volume stage0",
    "CostRegSmall s0": "CostRegSmall stage0", "cost volume s1": "cost volume stage1",
    "CostRegNet s1": "CostRegNet stage1", "bundle sampling": "bundle sampling",
    "encode: member rgb": "encode samples", "encode: mip fetch": "encode samples",
    "encode: vox fetch": "encode samples", "encode: proj+raydiff": "encode samples",
    "NeRF head": "NeRF head + composite", "composite": "NeRF head + composite",
    "RDN decoder": "RDN decoder",
}


def fmt_mb(b):
    return f"{b / 1e6:8.1f} MB"


def stages(H: int = 512, W: int = 640, V: int = 3, S: int = 3) -> list[tuple]:
    """(name, bytes, rows, row_bytes) of each stage of one frame."""
    b = 2  # bundle size
    bsq = b * b
    Hb, Wb = H // b, W // b
    e = 2  # bf16 bytes

    out = []

    def stage(name, byts, rows=0, row_bytes=0):
        out.append((name, byts, rows, row_bytes))

    # --- FPN: conv activation traffic (read in + write out per conv) ---
    fpn_acts = (
        2 * (H * W * 3) + 4 * (H * W * 8)          # c0 block x2
        + 2 * (H // 2 * W // 2 * 16) * 2            # c1 block
        + 2 * (H // 4 * W // 4 * 32) * 2            # c2 block
        + (H // 4 * W // 4) * (32 + 32)             # out0
        + (H // 2 * W // 2) * (32 + 32 + 16)        # lateral+out1
        + (H * W) * (32 + 32 + 8)                   # lateral+out2
    ) * V * e
    stage("FPN convs", fpn_acts)

    # --- cost volume stage0: D=64 @ (H/8, W/8), feats 1/4 res C=32 ---
    D0, h0, w0, C0 = 64, H // 8, W // 8, 32
    rows0 = V * D0 * h0 * w0
    rb0 = 4 * C0 * e
    cv0_bytes = (
        V * (H // 4) * (W // 4) * 4 * C0 * e        # pack write
        + rows0 * rb0                               # gathered rows read
        + 2 * D0 * h0 * w0 * C0 * 4                 # fp32 moment accumulators
        + D0 * h0 * w0 * C0 * e                     # variance out
    )
    stage("cost volume s0", cv0_bytes, rows0, rb0)

    # --- CostRegNetSmall s0 (C 8/16/32 over D0 x h0 x w0 pyramid) ---
    reg0 = 0
    dims = [(D0, h0, w0, 32), (D0, h0, w0, 8), (D0 // 2, h0 // 2, w0 // 2, 16),
            (D0 // 2, h0 // 2, w0 // 2, 16), (D0 // 4, h0 // 4, w0 // 4, 32),
            (D0 // 4, h0 // 4, w0 // 4, 32)]
    for (d, hh, ww, c) in dims:
        reg0 += 2 * d * hh * ww * c * e             # in+out per conv
    reg0 *= 2  # decoder mirrors encoder
    stage("CostRegSmall s0", reg0)

    # --- cost volume stage1: D=8 @ (H/2, W/2), feats 1/2 res C=16 ---
    D1, h1, w1, C1 = 8, H // 2, W // 2, 16
    rows1 = V * D1 * h1 * w1
    rb1 = 4 * C1 * e
    cv1_bytes = (
        V * h1 * w1 * 4 * C1 * e
        + rows1 * rb1
        + 2 * D1 * h1 * w1 * C1 * 4
        + D1 * h1 * w1 * C1 * e
    )
    stage("cost volume s1", cv1_bytes, rows1, rb1)

    # --- CostRegNet s1 ---
    reg1 = 0
    dims = [(D1, h1, w1, 16), (D1, h1, w1, 8), (D1 // 2, h1 // 2, w1 // 2, 16),
            (D1 // 2, h1 // 2, w1 // 2, 16), (D1 // 4, h1 // 4, w1 // 4, 32),
            (D1 // 4, h1 // 4, w1 // 4, 32), (1, h1 // 8, w1 // 8, 64),
            (1, h1 // 8, w1 // 8, 64)]
    for (d, hh, ww, c) in dims:
        reg1 += 2 * d * hh * ww * c * e
    reg1 *= 2
    stage("CostRegNet s1", reg1)

    # --- bundle sampling: (Hb, Wb, S) z/uvd/radii/valid tensors ---
    N = Hb * Wb * S
    stage("bundle sampling", N * (1 + 1 + 3 + 1 + 1) * 4 * 2)

    # --- encode ---
    F = 16 + 3  # mip feature width
    # member RGB: V * N * bsq rows of 2x2-packed RGB
    mrows = V * N * bsq
    mrb = 4 * 3 * e
    member_bytes = (
        V * H * W * 4 * 3 * e                        # pack write
        + mrows * mrb                                # rows read
        + mrows * (2 * 4 + 4)                        # coords + index
        + V * N * bsq * 3 * e                        # rgbs out
    )
    stage("encode: member rgb", member_bytes, mrows, mrb)
    # mip: 2 taps x V*N rows of 2x2-packed F channels
    prows = 2 * V * N
    prb = 4 * F * e
    pyr_texels = int(Hb * Wb * 4 / 3)
    mip_bytes = (
        V * pyr_texels * 4 * F * e                   # pyramid pack write
        + prows * prb
        + prows * (2 * 4 + 4)
        + V * N * F * e                              # mip_feat out
    )
    stage("encode: mip fetch", mip_bytes, prows, prb)
    # vox: degenerate depth-linear fetch, 2 narrow rows per sample
    vrows = 2 * N
    vrb = 8 * e
    stage("encode: vox fetch", vrows * vrb + N * 8 * e + N * 12, vrows, vrb)
    # projection / ray-diff elementwise (fp32 geometry)
    proj_bytes = V * N * (3 + 3 + 1 + 1 + 4) * 4 * 2
    stage("encode: proj+raydiff", proj_bytes)

    # --- NeRF head: split matmuls over (V, N) x ~hid ---
    hid = 64
    head_bytes = (
        V * N * (F + 4 + 12) * e * 2                 # per-view reads x2 passes
        + N * (hid + 8 + 16 + 31 + 8) * e * 2
    )
    stage("NeRF head", head_bytes)

    # --- composite + decoder ---
    stage("composite", N * (1 + 31 + 1) * e * 2)
    dec_acts = 0
    for c_in, c_out in [(28, 64)] + [(64, 64)] * 6 + [(64, 12)]:
        dec_acts += Hb * Wb * (c_in + c_out) * e
    stage("RDN decoder", dec_acts)
    return out


def floor_ms(byts: float, rows: float, rbts: float, bw: float, rr: float, gbw: float) -> float:
    """A stage's floor: the largest of its bytes at ``bw``, its rows at
    ``rr`` and its gathered bytes at ``gbw``."""
    return max(byts / bw, rows / rr, rows * rbts / gbw if rows else 0.0) * 1e3


def envelope_rates(path: str) -> tuple[float, float]:
    """``rr`` and ``gbw`` of the last JSON line in ``path`` that holds them
    (``tools/microbench.py``'s line, or its envelope alone)."""
    found = None
    with open(path) as f:
        for line in f:
            if line.lstrip().startswith("{"):
                obj = json.loads(line)
                obj = obj.get("microbench", obj)
                if "rr" in obj and "gbw" in obj:
                    found = (float(obj["rr"]), float(obj["gbw"]))
    if found is None:
        raise ValueError(f"{path}: no JSON line with 'rr' and 'gbw'")
    return found


def table(H: int, W: int, V: int, S: int, bw: float, rr: float | None = None,
          gbw: float | None = None, out=print) -> dict:
    """Print the stage table (floors where ``rr`` and ``gbw`` are given)
    and return it, each stage with its ``PROFILE_STAGE``."""
    rows_out = []
    has_rates = rr is not None and gbw is not None
    total_b = total_r = total_floor = 0.0
    out(f"{'stage':<22} {'bytes':>12} {'Mrows':>7}" + (f" {'floor ms':>9}" if has_rates else ""))
    for name, byts, rows, rbts in stages(H, W, V, S):
        row = {"stage": name, "profile_stage": PROFILE_STAGE[name], "bytes": byts,
               "rows": rows, "row_bytes": rbts}
        line = f"{name:<22} {fmt_mb(byts)} {rows / 1e6:7.2f}"
        if has_rates:
            row["floor_ms"] = floor_ms(byts, rows, rbts, bw, rr, gbw)
            total_floor += row["floor_ms"]
            line += f" {row['floor_ms']:9.2f}"
        total_b += byts
        total_r += rows
        rows_out.append(row)
        out(line)
    out("-" * 52)
    out(f"{'TOTAL':<22} {fmt_mb(total_b)} {total_r / 1e6:7.2f}"
        + (f" {total_floor:9.2f}" if has_rates else ""))
    if has_rates:
        out(f"\nassumptions: BW={bw / 1e9:.0f} GB/s  RR={rr / 1e6:.0f} M rows/s  "
            f"GBW={gbw / 1e9:.0f} GB/s")
    else:
        out(f"\nno row rate or gather bandwidth given (--envelope, or --rr and --gbw): "
            f"bytes and rows only; BW={bw / 1e9:.0f} GB/s")
    result = {"size": [H, W], "views": V, "samples": S, "bw": bw, "rr": rr, "gbw": gbw,
              "stages": rows_out, "total_bytes": total_b, "total_rows": total_r}
    if has_rates:
        result["total_floor_ms"] = total_floor
        result["floor_ms_by_profile_stage"] = by_profile_stage(rows_out)
    return result


def by_profile_stage(rows: list[dict]) -> dict:
    """The floors summed over each ``tools/profile_forward.py`` stage."""
    out: dict = {}
    for row in rows:
        out[row["profile_stage"]] = out.get(row["profile_stage"], 0.0) + row["floor_ms"]
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, nargs=2, default=[512, 640])
    ap.add_argument("--views", type=int, default=3)
    ap.add_argument("--samples", type=int, default=3)
    ap.add_argument("--bw", type=float, default=H100_BYTES_PER_S,
                    help="device memory bytes/s (default: the H100's, kernels/measure.py)")
    ap.add_argument("--envelope", default=None, help="a file with tools/microbench.py's JSON line")
    ap.add_argument("--rr", type=float, default=None, help="gather rows/s")
    ap.add_argument("--gbw", type=float, default=None, help="gathered bytes/s")
    args = ap.parse_args(argv)
    rr, gbw = envelope_rates(args.envelope) if args.envelope else (None, None)
    rr = args.rr if args.rr is not None else rr
    gbw = args.gbw if args.gbw is not None else gbw
    H, W = args.size
    result = table(H, W, args.views, args.samples, args.bw, rr, gbw)
    print(json.dumps({"roofline": result}))
    return result


if __name__ == "__main__":
    main()
