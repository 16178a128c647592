"""Plane-layout conv kernels against cuDNN: the port's conv microbench.

The port's counterpart of ``tools/microbench_pallas_conv.py``, with the
kernels of ``kernels/plane_conv.py`` in place of the Pallas ones and cuDNN
(``F.conv2d``) in place of the XLA yardstick.  Planes are (C, H, W), with
C8 3x3 convs on full 512x640 planes, a stride-2 5x5 downsample and a
nearest-2x upsample merge: the conv work of the FPN's first layers.

    python -m gdb_nerf_tpu_torch.tools.microbench_conv --check   # numerics
    python -m gdb_nerf_tpu_torch.tools.microbench_conv           # chain of 4 C8 convs, 512x640 bf16
    python -m gdb_nerf_tpu_torch.tools.microbench_conv --prims   # fpnprim, 512x640 C8 bf16

It runs on ``cuda`` and exits non-zero without a GPU; ``--device cpu``
runs the kernels' plain versions on the CPU instead (times then are host
clock times of the CPU, not device times).  On the GPU, times are CUDA
events over many calls after a warm-up, float32 convs run without TF32,
and a kernel that fails to build or launch raises: nothing falls back.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from gdb_nerf_tpu_torch.kernels.measure import bound_ms, timed_ms
from gdb_nerf_tpu_torch.kernels.plane_conv import (
    PlaneConvKernels,
    conv1_reference,
    convchain_reference,
    fpnprim_reference,
    work,
)
from gdb_nerf_tpu_torch.runtime.renderer import set_float32_numerics

CHECK_ATOL = 1e-4  # float32 against cuDNN: the JAX tool's bound against XLA's conv
ITERS = 20
REFERENCES = {"conv1": conv1_reference, "convchain": convchain_reference,
              "fpnprim": fpnprim_reference}


def bf16_tol(want: torch.Tensor) -> float:
    """4 bf16 ulps at the largest magnitude of ``want``: one bf16 ulp of m
    is at most 2**-7 * |m|, and a float32 sum taken in another order flips
    a rounding by one ulp, which a chain carries into the next layer."""
    return 4 * 2.0**-7 * float(want.float().abs().max())


def inputs(name: str, c: int, H: int, W: int, dtype: torch.dtype, device, seed: int = 0,
           n: int = 4, c_out: int | None = None, scale: float = 0.2,
           float32_params: bool = False):
    """Pre-padded planes, weights and bias for kernel ``name`` from a seed:
    x (c, H+pad, W+pad) ~ N(0, 1) with a zero ring, weights ~ N(0, scale),
    bias ~ N(0, 1) (convchain: N(0, 0.1)), all rounded to ``dtype`` as the
    JAX tool makes them (with ``float32_params``, weights and bias stay
    float32: bf16 planes then get weights that are not bf16 values).  x is in
    ``dtype``; weights and bias are handed over in float32, the type the
    kernels read, so that a timed call holds no cast."""
    g = torch.Generator().manual_seed(seed)
    pad = 2 if name == "fpnprim" else 1
    x = F.pad(torch.randn(c, H, W, generator=g), (pad,) * 4)
    if name == "conv1":
        co = c if c_out is None else c_out
        params = (torch.randn(co, c, 3, 3, generator=g) * scale, torch.randn(co, generator=g))
    elif name == "convchain":
        params = (torch.randn(n, c, c, 3, 3, generator=g) * scale,
                  torch.randn(n, c, generator=g) * 0.1)
    else:
        params = (torch.randn(c, c, 5, 5, generator=g) * scale, torch.randn(c, generator=g))
    pdt = torch.float32 if float32_params else dtype
    return (x.to(dtype).to(device), *(t.to(pdt).float().to(device) for t in params))


def library_fn(name: str, args):
    """The same function through cuDNN (``F.conv2d``, weights in x's dtype,
    each conv's output in x's dtype, as the kernels round) and PyTorch's own
    epilogue ops: the yardstick of the times and the reference of
    ``--check``, as XLA's conv is the JAX tool's; used nowhere else."""
    x, w, b = args
    w, b = w.to(x.dtype), b.to(x.dtype)
    if name == "conv1":
        return lambda: torch.relu_(F.conv2d(x[None], w, b))[0]
    if name == "convchain":
        def chain():
            y = x[None]
            for k in range(w.shape[0]):
                y = torch.relu_(F.conv2d(y, w[k], b[k], padding=0 if k == 0 else 1))
            return y[0]
        return chain
    H = x.shape[1] - 4

    def prim():
        o1 = F.conv2d(x[None], w, b, stride=2)
        o2 = F.interpolate(o1, scale_factor=2, mode="nearest")
        o2[:, :, H - 3:].zero_()
        return o1[0], o2[0]
    return prim


def agree(got, want, atol: float, rtol: float = 0.0) -> tuple[float, bool]:
    """Max abs difference over the outputs (a tensor or a tuple), and
    whether every output is within its tolerance: float32 ``atol + rtol *
    |want|`` elementwise, bf16 ``bf16_tol(want)``."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err, ok = 0.0, True
    for g, r in zip(got, want, strict=True):
        if g.shape != r.shape or g.dtype != r.dtype:
            return float("inf"), False
        d = (g.float() - r.float()).abs()
        err = max(err, float(d.max()))
        if r.dtype == torch.float32:
            ok &= bool((d <= atol + rtol * r.abs()).all())
        else:
            ok &= float(d.max()) <= bf16_tol(r)
    return err, ok


def weight_rounding_errors(name: str, got, args) -> tuple[float, float, bool]:
    """For kernel ``name``'s output ``got`` (a tensor, or fpnprim's two) on
    float32 weights that are not bf16 values: the mean |got - plain| over
    every output against the plain version on those weights and on the
    weights rounded to bf16 (biases kept), and whether the first is below a
    quarter of the second.  A kernel that keeps the float32 weights (the
    bf16 kernels' lo MMAs) is far nearer the first (the CPU replay of the
    chain: 1-2 % of the second); one that rounds them equals the second but
    for the order of its sums."""
    x, w, b = args
    got = got if isinstance(got, tuple) else (got,)

    def mean_err(weights):
        want = REFERENCES[name](x, weights, b)
        want = want if isinstance(want, tuple) else (want,)
        return float(torch.cat([(g.float() - r.float()).abs().reshape(-1)
                                for g, r in zip(got, want, strict=True)]).mean())

    full, rounded = mean_err(w), mean_err(w.to(torch.bfloat16).float())
    return full, rounded, 4 * full < rounded


def check(kernels: PlaneConvKernels, device, dtype=torch.float32) -> None:
    """conv1 and a chain of 3 at the JAX tool's check shape (C8, 32x256)
    against cuDNN."""
    for name, kw in (("conv1", {}), ("convchain", {"n": 3})):
        args = inputs(name, 8, 32, 256, dtype, device, **kw)
        err, ok = agree(getattr(kernels, name)(*args), library_fn(name, args)(), CHECK_ATOL)
        print(f"{name} ({str(dtype)[6:]}) max|err| = {err:.2e}")
        if not ok:
            raise AssertionError(f"{name} disagrees with the cuDNN reference: {err:.2e}")
    print("numerics OK")


def check_prims(kernels: PlaneConvKernels, device, dtype=torch.float32) -> None:
    """fpnprim at the JAX tool's check shape (C8, 64x256)."""
    args = inputs("fpnprim", 8, 64, 256, dtype, device, scale=0.1)
    err, ok = agree(kernels.fpnprim(*args), library_fn("fpnprim", args)(), CHECK_ATOL)
    print(f"fpnprim conv5s2 + upsample/mask ({str(dtype)[6:]}) max|err| = {err:.2e}")
    if not ok:
        raise AssertionError(f"fpnprim disagrees with the cuDNN reference: {err:.2e}")
    print("prims numerics OK")


def compare(kernels: PlaneConvKernels, name: str, args, device) -> dict:
    """Kernel against cuDNN on ``args``: their times and the bound."""
    ms = timed_ms(lambda: getattr(kernels, name)(*args), device, ITERS)
    lib_ms = timed_ms(library_fn(name, args), device, ITERS)
    b_ms, bound_by = bound_ms(*work(name, args), args[0].dtype)
    return {"ms": ms, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": bound_by}


def _where(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{torch.cuda.get_device_name(device)}, CUDA events"
    return "cpu, host clock, plain versions"


def bench(kernels: PlaneConvKernels, device) -> None:
    """The JAX tool's bench: a chain of 4 C8 3x3 convs at 512x640 bf16 in
    one kernel against 4 separate cuDNN convs (+ bias + ReLU)."""
    args = inputs("convchain", 8, 512, 640, torch.bfloat16, device)
    r = compare(kernels, "convchain", args, device)
    print(f"chain of 4 C8 3x3 convs @ 512x640 (bf16; {_where(device)}): kernel {r['ms']:.4f} ms, "
          f"cuDNN {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
          f"cuDNN/kernel {r['library_ms'] / r['ms']:.2f}x")


def bench_prims(kernels: PlaneConvKernels, device) -> None:
    """fpnprim (conv5x5 stride 2 + upsample) at 512x640 C8 bf16."""
    args = inputs("fpnprim", 8, 512, 640, torch.bfloat16, device, scale=0.1)
    r = compare(kernels, "fpnprim", args, device)
    print(f"fpnprim conv5s2+up @ 512x640 C8 (bf16; {_where(device)}): kernel {r['ms']:.4f} ms, "
          f"cuDNN {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true", help="numerics at the check shapes")
    ap.add_argument("--prims", action="store_true", help="time fpnprim at 512x640")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run the plain versions")
    set_float32_numerics(tf32=False)
    kernels = PlaneConvKernels()
    if args.check:
        for dtype in (torch.float32, torch.bfloat16):
            check(kernels, device, dtype)
            check_prims(kernels, device, dtype)
    elif args.prims:
        bench_prims(kernels, device)
    else:
        bench(kernels, device)
    if device.type == "cuda":
        print(f"kernel launches: {kernels.launches}")


if __name__ == "__main__":
    main()
