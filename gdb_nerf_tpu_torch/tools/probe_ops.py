"""The Mosaic primitive probes, one kernel each: the port's probe tool.

The port's counterpart of ``tools/probe_mosaic_ops.py``, with the kernels
of ``kernels/plane_ops.py`` in place of the nine Pallas ones.  Each probe
makes its input from a seeded ``torch.Generator`` at the probe's size
(C, H, W = 8, 64, 256), runs its kernel and compares the output with the
probe's own expected expression:

* the slices, the upsamples and the pad copy bits: equal, as on the TPU;
* the selection products (0/1 matrices built as the probes build them)
  run in float32 FMAs without TF32, so each output is one input value:
  equal too (the TPU probes allowed 5e-2 for their matrix unit's passes);
* ``grouped_conv3`` against the valid 3x3 conv of its padded input
  (``F.conv2d``, TF32 off) within atol 1e-5, rtol 1e-4.  The TPU probe's
  reference re-pads the interior of x with zeros and so differs from its
  kernel on the output's border;
* ``dyn_row_mask``: o1 as the probe checks it, and o2 against its two
  row blocks.

    python -m gdb_nerf_tpu_torch.tools.probe_ops [--probe NAME ...] [--device cpu]

It prints ``[ok]`` or ``[FAIL]`` per probe, then ``k/n probes ok``, and,
unlike the TPU tool, exits non-zero if any probe failed.  It runs on
``cuda`` and exits non-zero without a GPU; ``--device cpu`` runs the
kernels' plain versions on the CPU instead.  A kernel that fails to build
or launch fails its probe: nothing falls back.
"""

from __future__ import annotations

import argparse
import sys
import traceback

import torch
import torch.nn.functional as F

from gdb_nerf_tpu_torch.kernels.plane_ops import KERNELS, ROW_MASK_OFFSET, PlaneOpsKernels
from gdb_nerf_tpu_torch.runtime.renderer import set_float32_numerics

C, H, W = 8, 64, 256
# grouped_conv3 against another float32 sum order: the plane convs' tolerance.
# Products with a random matrix sum in the same order with fmaf against a
# multiply and an add: the same tolerance.
CONV_ATOL, CONV_RTOL = 1e-5, 1e-4
# Products with a random matrix, (probe, C, H, W, the matrix's other side):
# on 132 SMs the wrapper picks each tile row once for the right product
# x @ s (M = C*H folded, K = W, N = the width) and once for the left s @ x
# (M = the height, K = H, N = W), on the 16-byte path (K and N multiples of
# 4) and on the 4-byte one.  The card tests and the smoke run them.
TILE_CASES = [
    ("lane_downsample_matmul", 8, 534, 100, 32),    # 64x128, 16-byte
    ("lane_downsample_matmul", 2, 30, 37, 33),      # 32x128, 4-byte
    ("sublane_downsample_matmul", 2, 45, 33, 30),   # 64x128, 4-byte
    ("sublane_downsample_matmul", 2, 64, 32, 37),   # 32x128, 16-byte
]
# Widths that take each strided-slice path: W % 8 == 0 (the vector paths
# of both strides), W % 4 == 0 only (sh = 2 vector, sw = 2 scalar), W odd
# (scalar); with H odd.
SLICE_WIDTHS = (648, 644, 637)
SLICE_C, SLICE_H = 3, 37
# Sizes (C, H, W) that take the grouped conv's and the row mask's paths
# beside the probe's, the FPN's and the ragged sizes.  The conv: 12
# channels (two groups of 8) at 16x32 tile edges with 16-byte stores; 3
# channels by column pairs with 4-byte stores (W % 4 == 2).  The
# row mask: 16-byte rows with o2 in 8-byte halves (W % 4 == 0, W/2 % 4 ==
# 2), and H = 12, whose masked rows 7-11 include o2's rows 7 and 8.  The
# card tests and the smoke run them.
PATH_SIZES = {"grouped_conv3": [(12, 336, 704), (3, 48, 702)],
              "dyn_row_mask": [(5, 508, 644), (3, 12, 20)]}


def _selection(rows: int, cols: int, r, c) -> torch.Tensor:
    """A (rows, cols) float32 matrix with ones at (r[i], c[i]), else 0."""
    s = torch.zeros(rows, cols)
    s[r, c] = 1.0
    return s


def inputs(name: str, C: int, H: int, W: int, device, seed: int = 0) -> tuple[torch.Tensor, ...]:
    """The probe's inputs at (C, H, W), float32: x = arange for the two
    slices, else x ~ N(0, 1) from ``seed`` ((C, H+2, W+2) for the conv, its
    weights (C, 9, C, 1) ~ N(0, 0.2) from ``seed + 1``); the selection
    matrices of the products (ceil for odd sizes, as ``::2``)."""
    g = torch.Generator().manual_seed(seed)
    if name in ("sublane_stride2", "lane_stride2"):
        args = (torch.arange(C * H * W, dtype=torch.float32).reshape(C, H, W),)
    elif name == "grouped_conv3":
        x = torch.randn(C, H + 2, W + 2, generator=g)
        g.manual_seed(seed + 1)
        args = (x, torch.randn(C, 9, C, 1, generator=g) * 0.2)
    else:
        x = torch.randn(C, H, W, generator=g)
        Ho, Wo = (H + 1) // 2, (W + 1) // 2
        if name == "lane_downsample_matmul":
            args = (x, _selection(W, Wo, torch.arange(0, W, 2), torch.arange(Wo)))
        elif name == "sublane_downsample_matmul":
            args = (x, _selection(Ho, H, torch.arange(Ho), torch.arange(0, H, 2)))
        elif name == "upsample_matmul":
            args = (x, _selection(2 * H, H, torch.arange(2 * H), torch.arange(2 * H) // 2),
                    _selection(W, 2 * W, torch.arange(2 * W) // 2, torch.arange(2 * W)))
        else:
            args = (x,)
    return tuple(a.to(device) for a in args)


def random_product_inputs(name: str, C: int, H: int, W: int, width: int, device,
                          seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """x ~ N(0, 1) (C, H, W) and a matrix ~ N(0, 1/K), which keeps the
    outputs near 1: s (W, width) for ``lane_downsample_matmul`` (x @ s),
    s (width, H) for ``sublane_downsample_matmul`` (s @ x)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(C, H, W, generator=g)
    if name == "lane_downsample_matmul":
        s = torch.randn(W, width, generator=g) / W**0.5
    else:
        s = torch.randn(width, H, generator=g) / H**0.5
    return x.to(device), s.to(device)


def close(got: torch.Tensor, want: torch.Tensor) -> tuple[float, bool]:
    """Max abs difference, and whether |got - want| <= CONV_ATOL + CONV_RTOL
    |want| everywhere."""
    d = (got - want).abs()
    return float(d.max()), bool((d <= CONV_ATOL + CONV_RTOL * want.abs()).all())


def conv_weights_oihw(w: torch.Tensor) -> torch.Tensor:
    """w (co, 9, ci, 1), tap t = 3 ky + kx, as F.conv2d's (co, ci, 3, 3)."""
    co, _, ci, _ = w.shape
    return w[..., 0].reshape(co, 3, 3, ci).permute(0, 3, 1, 2).contiguous()


def library_call(name: str, args):
    """Probe ``name``'s function as PyTorch's own calls on ``args`` (made
    once, outside the call): the yardstick that ``chip_smoke.py`` and
    ``ab_plane_ops`` time beside the K7 kernels; no wrapper runs it.  The
    products are ``torch.matmul`` in float32, which must equal the plain
    versions on a 0/1 matrix unless TF32 is on."""
    x = args[0]
    if name == "sublane_stride2":
        return lambda: x[:, ::2].contiguous()
    if name == "lane_stride2":
        return lambda: x[..., ::2].contiguous()
    if name == "lane_downsample_matmul":
        return lambda: torch.matmul(x, args[1])
    if name == "sublane_downsample_matmul":
        return lambda: torch.matmul(args[1], x)
    if name == "repeat_upsample":
        return lambda: F.interpolate(x[None], scale_factor=2, mode="nearest")[0]
    if name == "upsample_matmul":
        return lambda: torch.matmul(args[1], torch.matmul(x, args[2]))
    if name == "grouped_conv3":
        w = conv_weights_oihw(args[1])
        return lambda: F.conv2d(x[None], w)[0]
    if name == "dyn_row_mask":
        c, h, w = x.shape
        rows = torch.arange(h, device=x.device)[None, :, None]
        blocks = x.view(c, 2, h // 2, w)[:, :, :h // 4, :w // 2]
        return lambda: (torch.where(rows < h - ROW_MASK_OFFSET, x, 0.0),
                        blocks.reshape(c, h // 2, w // 2))
    if name == "pad_value":
        return lambda: F.pad(x, (1, 1, 1, 1))
    raise ValueError(f"unknown probe {name!r}")


def expected(name: str, args) -> tuple[torch.Tensor, ...]:
    """The probe's own expected outputs, written as the TPU probe writes them."""
    x = args[0]
    if name in ("sublane_stride2", "sublane_downsample_matmul"):
        return (x[:, ::2, :],)
    if name in ("lane_stride2", "lane_downsample_matmul"):
        return (x[:, :, ::2],)
    if name in ("repeat_upsample", "upsample_matmul"):
        return (torch.repeat_interleave(torch.repeat_interleave(x, 2, dim=1), 2, dim=2),)
    if name == "grouped_conv3":
        return (F.conv2d(x[None], conv_weights_oihw(args[1]))[0],)
    if name == "dyn_row_mask":
        h, w = x.shape[1:]
        rows = torch.arange(h, device=x.device)[None, :, None]
        o1 = torch.where(rows < h - ROW_MASK_OFFSET, x, 0.0)
        o2 = torch.cat([x[:, :h // 4, :w // 2], x[:, h // 2:h // 2 + h // 4, :w // 2]], dim=1)
        return o1, o2
    if name == "pad_value":
        return (F.pad(x, (1, 1, 1, 1)),)
    raise ValueError(f"unknown probe {name!r}")


def agree(name: str, got, want) -> tuple[float, bool]:
    """Max abs difference over the outputs (a tensor or a tuple), and whether
    they agree: equal bit for bit, but ``grouped_conv3`` within atol + rtol
    |want| elementwise."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err, ok = 0.0, True
    for g, r in zip(got, want, strict=True):
        if g.shape != r.shape or g.dtype != r.dtype:
            return float("inf"), False
        if name == "grouped_conv3":
            e, close_ok = close(g, r)
            ok &= close_ok
        else:
            e = float((g - r).abs().max())
            ok &= torch.equal(g, r)
        err = max(err, e)
    return err, ok


def run_probe(kernels: PlaneOpsKernels, name: str, device) -> float:
    """One probe at its size: its kernel against its expected outputs.
    Returns the max abs difference; raises AssertionError if they disagree."""
    args = inputs(name, C, H, W, device)
    got = getattr(kernels, name)(*args)
    err, ok = agree(name, got, expected(name, args))
    if not ok:
        raise AssertionError(f"{name} differs from its expected output: max|err| = {err:.3e}")
    return err


def check(kernels: PlaneOpsKernels, device, names=KERNELS) -> None:
    """Each probe in ``names`` at its size, float32 without TF32; prints
    ``[ok]`` or ``[FAIL]`` for each, then the count, and raises
    AssertionError if any failed."""
    set_float32_numerics(tf32=False)
    failed = []
    for name in names:
        try:
            err = run_probe(kernels, name, device)
        except Exception as e:  # report every probe, then fail below
            failed.append(name)
            first = str(e).splitlines()[0][:160] if str(e) else ""
            print(f"[FAIL] {name}: {type(e).__name__}: {first}")
            traceback.print_exc(file=sys.stderr)
            continue
        print(f"[ok]   {name}" + (f"  max|err| = {err:.2e}" if err else ""))
    print(f"{len(names) - len(failed)}/{len(names)} probes ok")
    if failed:
        raise AssertionError(f"probes failed: {', '.join(failed)}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probe", nargs="*", default=list(KERNELS), choices=KERNELS)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run the plain versions")
    kernels = PlaneOpsKernels()
    check(kernels, device, args.probe)
    if device.type == "cuda":
        print(f"kernel launches: {kernels.launches}")


if __name__ == "__main__":
    main()
