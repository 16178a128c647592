"""The card's envelope for the forward's shapes: copy, gathers and convs.

The port's counterpart of ``tools/microbench.py``, measured with CUDA events
over back-to-back calls with the stream held while the host queues them
(``kernels/measure.py::timed_ms``):

  * copy bandwidth: an elementwise pass (``x * 1.0001``) over 64 MB of bf16,
    read and write counted;
  * gather row rate against row width C in {4, 8, 16, 32, 48, 64, 128}:
    2,000,000 random rows of a bf16 table of 81,920 rows (a 256x320 map
    flattened) through the calls the forward and its tools use,
    ``index_select``, ``take_along_dim`` (a broadcast (N, 1) index) and
    indexing ``table[idx]``, all three held equal; and ``F.grid_sample``'s
    bilinear taps on a float32 NCHW (1, C, 256, 320) table at 2,000,000
    points, as the forward samples its tables, counted as 4 texel rows a
    point;
  * the member-RGB-shaped gather: 2,949,120 rows at C = 12 (bf16,
    ``index_select``), and the forward's own member-RGB fetch, grid_sample
    of 3 float32 512x640 RGB views at 983,040 points each;
  * convs (cuDNN, bf16, NCHW, 3x3): C8 at 512x640 against C32 at 256x320
    and C128 at 128x160, the same activation bytes; and the first Conv3d of
    CostRegNet at stage 1 (16 -> 8 channels over 8 x 256 x 320).

The last line is the envelope as JSON: bytes/s of the copy, rows/s and
gathered bytes/s of each call by width, TFLOP/s of the convs, and ``rr``
and ``gbw``, the highest row rate and gathered byte rate of any gather call
here, which ``tools/roofline.py --envelope`` reads as the card's row rate
and gather bandwidth.

    python -m gdb_nerf_tpu_torch.tools.microbench [--quick] [--device cuda|cpu]

``--quick`` runs the widths 8, 16, 48 and 128 at small sizes (a CPU check of
the tool, not an envelope).  It runs on ``cuda`` and stops without a GPU;
``--device cpu`` times on the host clock.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from gdb_nerf_tpu_torch.kernels.measure import timed_ms
from gdb_nerf_tpu_torch.models.cost_reg_net import CostRegNet
from gdb_nerf_tpu_torch.tools import ab_common
from gdb_nerf_tpu_torch.tools import measure_common as common

FULL = {"copy_mb": 64, "table_rows": 81920, "table_hw": (256, 320), "n_idx": 2_000_000,
        "widths": (4, 8, 16, 32, 48, 64, 128), "member_hw": (512, 640), "member_rows": 2_949_120,
        "member_points": 983_040, "conv_hw": (512, 640), "conv3d": (8, 256, 320), "iters": 20}
QUICK = {"copy_mb": 1, "table_rows": 4096, "table_hw": (64, 64), "n_idx": 65536,
         "widths": (8, 16, 48, 128), "member_hw": (32, 40), "member_rows": 65536,
         "member_points": 16384, "conv_hw": (64, 80), "conv3d": (8, 32, 40), "iters": 2}
ROW_CALLS = ("index_select", "take_along_dim", "indexing")


def rates(ms: float, rows: int, row_bytes: int) -> dict:
    s = ms / 1e3
    return {"ms": ms, "rows_per_s": rows / s, "bytes_per_s": rows * row_bytes / s}


def row_gathers(table: torch.Tensor, idx: torch.Tensor, device, iters: int) -> dict:
    """The three row gathers of ``table`` at ``idx`` (int64), held equal;
    their times and rates."""
    calls = {"index_select": lambda: table.index_select(0, idx),
             "take_along_dim": lambda: torch.take_along_dim(table, idx[:, None], dim=0),
             "indexing": lambda: table[idx]}
    want = calls["index_select"]()
    for name, fn in calls.items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"microbench: {name} differs from index_select")
    row_bytes = table.shape[1] * table.element_size()
    return {name: rates(timed_ms(fn, device, iters), idx.numel(), row_bytes)
            for name, fn in calls.items()}


def grid_sample_taps(table: torch.Tensor, grid: torch.Tensor, device, iters: int) -> dict:
    """``F.grid_sample`` (bilinear, border) of the NCHW ``table`` at ``grid``
    (N, P, 1, 2): 4 texel rows of C values a point."""
    def fn():
        return F.grid_sample(table, grid, mode="bilinear", padding_mode="border",
                             align_corners=False)

    texels = 4 * grid.shape[0] * grid.shape[1]
    return rates(timed_ms(fn, device, iters), texels, table.shape[1] * table.element_size())


def conv_tflops(x: torch.Tensor, conv, flops: float, device, iters: int) -> dict:
    ms = timed_ms(lambda: conv(x), device, iters)
    return {"ms": ms, "tflops": flops / (ms / 1e3) / 1e12}


def measure(device, quick: bool = False) -> dict:
    """Every measurement of the module's docstring; returns the envelope."""
    size = QUICK if quick else FULL
    it = size["iters"]
    g = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g).to(dtype).to(device)

    def uniform_grid(n_views, points):
        return (torch.rand(n_views, points, 1, 2, generator=g) * 2 - 1).to(device)

    n = size["copy_mb"] * 2**20 // 2
    x = randn(n)
    copy = {"mb": size["copy_mb"], **rates(timed_ms(lambda: x * 1.0001, device, it), 1, 2 * 2 * n)}
    del copy["rows_per_s"]
    print(f"copy {size['copy_mb']:5d} MB bf16: {copy['ms']:8.3f} ms  "
          f"{copy['bytes_per_s'] / 1e9:8.1f} GB/s (read + write)", flush=True)

    rows, N = size["table_rows"], size["n_idx"]
    idx = torch.randint(0, rows, (N,), generator=g).to(device)
    th, tw = size["table_hw"]
    grid = uniform_grid(1, N)
    gather = {name: {} for name in (*ROW_CALLS, "grid_sample")}
    for C in size["widths"]:
        got = row_gathers(randn(rows, C), idx, device, it)
        got["grid_sample"] = grid_sample_taps(randn(1, C, th, tw, dtype=torch.float32), grid,
                                              device, it)
        for name, r in got.items():
            gather[name][str(C)] = r
        print(f"gather C={C:4d}: " + "  ".join(
            f"{name} {r['ms']:7.3f} ms {r['rows_per_s'] / 1e6:8.1f} M rows/s "
            f"{r['bytes_per_s'] / 1e9:6.1f} GB/s" for name, r in got.items()), flush=True)

    mh, mw = size["member_hw"]
    m_idx = torch.randint(0, mh * mw, (size["member_rows"],), generator=g).to(device)
    m_table = randn(mh * mw, 12)
    member = {"index_select_c12": rates(timed_ms(lambda: m_table.index_select(0, m_idx), device,
                                                 it), m_idx.numel(), 24)}
    member["grid_sample_rgb_3_views"] = grid_sample_taps(
        randn(3, 3, mh, mw, dtype=torch.float32), uniform_grid(3, size["member_points"]),
        device, it)
    for name, r in member.items():
        print(f"gather member-rgb shape, {name}: {r['ms']:8.3f} ms "
              f"({r['rows_per_s'] / 1e6:.1f} M rows/s, {r['bytes_per_s'] / 1e9:.1f} GB/s)",
              flush=True)

    H, W = size["conv_hw"]
    conv = {}
    for C, s in ((8, 1), (32, 2), (128, 4)):
        h, w = H // s, W // s
        weight = randn(C, C, 3, 3)
        conv[f"C{C} {h}x{w}"] = conv_tflops(randn(1, C, h, w),
                                            lambda v, k=weight: F.conv2d(v, k, padding=1),
                                            2 * h * w * C * C * 9, device, it)
    D, h, w = size["conv3d"]
    conv3d = CostRegNet(16, 8, 8).conv0[0].to(device=device, dtype=torch.bfloat16)
    conv["conv3d C16->8 " + "x".join(map(str, (D, h, w)))] = conv_tflops(
        randn(1, 16, D, h, w), conv3d, 2 * D * h * w * 16 * 8 * 27, device, it)
    for name, r in conv.items():
        print(f"conv {name}: {r['ms']:8.3f} ms  {r['tflops']:6.2f} TFLOP/s", flush=True)

    every = [r for by_width in gather.values() for r in by_width.values()]
    every += list(member.values())
    return {"bytes_per_s": copy["bytes_per_s"], "copy": copy,
            "rows_per_s": {name: {C: r["rows_per_s"] for C, r in by_width.items()}
                           for name, by_width in gather.items()},
            "gather": gather, "member_rgb": member,
            "tflops": {name: r["tflops"] for name, r in conv.items()}, "conv": conv,
            "rr": max(r["rows_per_s"] for r in every),
            "gbw": max(r["bytes_per_s"] for r in every)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = common.device_of(args.device)
    smi = ab_common.card_name() if device.type == "cuda" else "cpu"
    print(f"device: {device} ({smi})", flush=True)
    env = measure(device, args.quick)
    print(f"envelope: copy {env['bytes_per_s'] / 1e9:.1f} GB/s, best gather "
          f"{env['rr'] / 1e6:.1f} M rows/s and {env['gbw'] / 1e9:.1f} GB/s", flush=True)
    env = {"device": str(device), "card": smi, "quick": args.quick, **env}
    print(json.dumps({"microbench": env}), flush=True)
    return env


if __name__ == "__main__":
    main()
