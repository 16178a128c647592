"""The K7 kernels of ``csrc/plane_ops.cu`` that were redesigned for Hopper
against an earlier tree's and PyTorch's calls, on one card in one run.

Seven probes at the FPN's plane size (C8, 512x640), float32, TF32 off:
``sublane_stride2`` (K7a), ``lane_stride2`` (K7b), ``lane_downsample_matmul``
(K7c), ``sublane_downsample_matmul`` (K7d), ``upsample_matmul`` (K7f),
``grouped_conv3`` (K7g) and ``dyn_row_mask`` (K7h).  Each is run three ways:
PyTorch's call (``probe_ops.library_call``), the earlier tree's kernel
through that tree's own ``PlaneOpsKernels`` (its package imported from
OTHER beside this one, its library built into OTHER/build/kernels), and
this tree's.  Each must agree with the plain version (``probe_ops.agree``:
bit for bit, the conv within 1e-5 / 1e-4); then ``measure.timed_ms`` times
them, ``ITERS`` calls a turn, in turns library, earlier, this, this,
earlier, library, so that the card's drift falls on both kernels alike.

    mkdir -p build/parent
    git archive <commit> gdb_nerf_tpu_torch | tar -x -C build/parent
    python -m gdb_nerf_tpu_torch.tools.ab_plane_ops build/parent [--out PATH]

It prints the card's name and power limit, both builds' ptxas lines, and per
probe each version's mean and per-turn times, bound share and TFLOP/s or
GB/s (and the tile rows this tree's product takes); then, for each product
launch of K7c, K7d and K7f, this tree's kernel at every row of the tile
table (``tile_sweep``), the row the wrapper picks marked.  The same as JSON
in ``--out`` (``build/ab_plane_ops.json``).  It needs a GPU and exits non-zero
without one, or if a version disagrees with the plain one.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from gdb_nerf_tpu_torch.kernels import plane_ops
from gdb_nerf_tpu_torch.kernels.build import REPO
from gdb_nerf_tpu_torch.kernels.measure import bound_ms, timed_ms
from gdb_nerf_tpu_torch.runtime.renderer import set_float32_numerics
from gdb_nerf_tpu_torch.tools import probe_ops
from gdb_nerf_tpu_torch.tools.ab_common import card_name, import_from_tree, ptxas_lines

NAMES = ("sublane_stride2", "lane_stride2", "lane_downsample_matmul",
         "sublane_downsample_matmul", "upsample_matmul", "grouped_conv3", "dyn_row_mask")
ORDER = ("library", "other", "this", "this", "other", "library")
SIZE = (8, 512, 640)
ITERS = 50


def compare(other, this: plane_ops.PlaneOpsKernels, name: str, device: torch.device) -> dict:
    """One probe's three versions: agreement with the plain version, then
    the times in ``ORDER``."""
    args = probe_ops.inputs(name, *SIZE, device)
    want = plane_ops.REFERENCES[name](*args)
    fns = {"library": probe_ops.library_call(name, args),
           "other": lambda: getattr(other, name)(*args),
           "this": lambda: getattr(this, name)(*args)}
    agree = {k: probe_ops.agree(name, f(), want) for k, f in fns.items()}
    if not all(ok for _, ok in agree.values()):
        raise AssertionError(f"{name}: a version disagrees with the plain one "
                             f"(max|err|, agrees): {agree}")
    times = {k: [] for k in fns}
    for k in ORDER:
        times[k].append(timed_ms(fns[k], device, ITERS))
    n_bytes, flops = plane_ops.work(name, args)
    b_ms, by = bound_ms(n_bytes, flops, torch.float32)
    r = {"bound_ms": b_ms, "bound_by": by, "bytes": n_bytes, "flops": flops, "times": times,
         "max_abs_err": {k: e for k, (e, _) in agree.items()}}
    if name in plane_ops.PRODUCTS:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        r["tile"] = [plane_ops.tile_name(t) for t in plane_ops.product_tiles(name, args, sms)]
    for k, ts in times.items():
        ms = sum(ts) / len(ts)
        r[k] = {"ms": ms, "bound_share": b_ms / ms,
                "tflops" if by == "operations" else "gbs":
                    flops / ms / 1e9 if by == "operations" else n_bytes / ms / 1e6}
    return r


def tile_sweep(this: plane_ops.PlaneOpsKernels, device: torch.device) -> list[dict]:
    """Each product launch of the three matmul probes at ``SIZE`` with
    random operands, timed at every tile row; checked against
    ``torch.matmul`` (TF32 off) within the product tolerance."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    g = torch.Generator(device=device).manual_seed(0)
    rows, seen = [], set()
    for name in plane_ops.PRODUCTS:
        args = probe_ops.inputs(name, *SIZE, device)
        for batch, M, K, N, ab, bb in plane_ops.product_launches(name, args):
            if (batch, M, K, N, ab, bb) in seen:
                continue
            seen.add((batch, M, K, N, ab, bb))
            a = torch.randn((batch, M, K) if ab else (M, K), device=device, generator=g)
            b = torch.randn((batch, K, N) if bb else (K, N), device=device, generator=g) / K**0.5
            out = torch.empty(batch, M, N, device=device)
            want = torch.matmul(a, b)
            flops = 2 * batch * M * K * N
            r = {"launch": [batch, M, K, N, ab, bb], "picked": plane_ops.tile_name(
                plane_ops.select_tile(batch, M, N, ab, bb, sms)), "ms": {}}
            for t in range(len(plane_ops.MATMUL_TILES)):
                run = lambda: this.launch_matmul("sweep", a, b, out, t)  # noqa: E731
                run()
                err, ok = probe_ops.close(out, want)
                if not ok:
                    raise AssertionError(f"tile {plane_ops.tile_name(t)} at {r['launch']}: {err}")
                r["ms"][plane_ops.tile_name(t)] = timed_ms(run, device, ITERS)
            r["library_ms"] = timed_ms(lambda: torch.matmul(a, b), device, ITERS)
            print(f"[sweep] {r['launch']}: " + "; ".join(
                f"{k} {ms:.4f} ms {flops / ms / 1e9:.1f} TFLOP/s" + (" (picked)" if k == r["picked"]
                                                                     else "")
                for k, ms in r["ms"].items()) + f"; torch.matmul {r['library_ms']:.4f} ms")
            rows.append(r)
    return rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path,
                    help="the root of another tree holding gdb_nerf_tpu_torch (an earlier commit's)")
    ap.add_argument("--out", type=Path, default=REPO / "build" / "ab_plane_ops.json",
                    help="where the results go as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this comparison runs on the card")
    card = card_name()
    print(card)
    device = torch.device("cuda")
    set_float32_numerics(tf32=False)
    this = plane_ops.PlaneOpsKernels()
    this.load()
    other = import_from_tree(args.other.resolve(), "kernels.plane_ops").PlaneOpsKernels()
    other.load()
    builds = {"this": ptxas_lines(this.build_log), "other": ptxas_lines(other.build_log)}
    for tag, lines in builds.items():
        for line in lines:
            print(f"[ptxas {tag}] {line}")
    result = {"card": card, "iters": ITERS, "order": ORDER, "ptxas": builds, "probes": {}}
    for name in NAMES:
        r = compare(other, this, name, device)
        result["probes"][name] = r
        line = f"[ab] {name}: bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
        for k in ("library", "other", "this"):
            rate = (f"{r[k]['tflops']:.1f} TFLOP/s" if "tflops" in r[k]
                    else f"{r[k]['gbs']:.0f} GB/s")
            line += (f"; {k} {r[k]['ms']:.4f} ms ({', '.join(f'{t:.4f}' for t in r['times'][k])}),"
                     f" {100 * r[k]['bound_share']:.1f} % of the bound, {rate}")
        if "tile" in r:
            line += f"; tile {' then '.join(r['tile'])}"
        print(line)
    result["tile_sweep"] = tile_sweep(this, device)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
