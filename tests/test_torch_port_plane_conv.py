"""The plane-conv kernels (K2-K4) of the port against the Pallas kernels.

The JAX side is ``tools/microbench_pallas_conv.py``'s ``pallas_conv1``,
``pallas_convchain`` and ``pallas_fpnprim`` in interpret mode on the CPU,
as that tool's ``--check`` runs them; the port's side is
``PlaneConvKernels`` on CPU tensors, which runs the plain versions.  The
same numpy inputs, made from a seed, go through both, at c = 4 on planes of
16x40, in float32 and bf16.  ``F.conv2d`` on the CPU is a second reference.

Tolerances: float32 atol 1e-5, rtol 1e-4 (the same float32 sums, taken in
another order by XLA; measured 1.2e-6).  bf16: both sides sum in float32 and
round at the same places, so a difference is a flipped rounding: within 4
bf16 ulps at the output's largest magnitude (measured 0).

The CUDA kernel cannot run here; ``test_convchain_tile_replay`` replays its
tiled algorithm (halo of n pixels recomputed per tile, intermediates zeroed
outside the image) in torch with the tile sizes of ``csrc/plane_conv.cu``.
"""

import importlib.util
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gdb_nerf_tpu_torch.kernels import plane_conv
from gdb_nerf_tpu_torch.kernels.measure import bound_ms
from gdb_nerf_tpu_torch.kernels.plane_conv import (
    PlaneConvKernels,
    conv1_reference,
    convchain_reference,
)
from gdb_nerf_tpu_torch.tools import microbench_conv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "microbench_pallas_conv", os.path.join(REPO, "tools", "microbench_pallas_conv.py"))
pallas_conv = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(pallas_conv)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
C, H, W = 4, 16, 40


def _both(a, dtype):
    """``a`` cast to ``dtype`` in JAX, and the same values as a torch tensor."""
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(a).astype(jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _assert_close(got: torch.Tensor, want, dtype):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    else:
        tol = microbench_conv.bf16_tol(torch.tensor(want))
        assert np.abs(got - want).max() <= tol


def _planes(rng, c, pad):
    return np.pad(rng.standard_normal((c, H, W)).astype(np.float32), ((0, 0), (pad, pad), (pad, pad)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1_matches_pallas(dtype):
    rng = np.random.default_rng(0)
    c_out = 6  # c_in != c_out
    (xj, xt), (wj, wt), (bj, bt) = (
        _both(a, dtype) for a in (_planes(rng, C, 1),
                                  rng.standard_normal((c_out, C, 3, 3)) * 0.2,
                                  rng.standard_normal(c_out)))
    kernels = PlaneConvKernels()
    got = kernels.conv1(xt, wt, bt)
    assert got.dtype == xt.dtype and kernels.launches["conv1"] == 0
    _assert_close(got, pallas_conv.pallas_conv1(xj, wj, bj, interpret=True), dtype)
    # Second reference: cuDNN's math on the CPU, in float32.
    want = torch.relu(F.conv2d(xt.float()[None], wt.float(), bt.float()))[0].to(xt.dtype)
    _assert_close(got, want.float().numpy(), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convchain_matches_pallas(dtype):
    """n = 3 with biases near +0.5, so that every intermediate is positive
    next to the image: the result depends on the zero ring."""
    rng = np.random.default_rng(1)
    n = 3
    (xj, xt), (wj, wt), (bj, bt) = (
        _both(a, dtype) for a in (_planes(rng, C, 1),
                                  rng.standard_normal((n, C, C, 3, 3)) * 0.2,
                                  rng.standard_normal((n, C)) * 0.1 + 0.5))
    got = PlaneConvKernels().convchain(xt, wt, bt)
    assert got.dtype == xt.dtype
    _assert_close(got, pallas_conv.pallas_convchain(xj, wj, bj, interpret=True), dtype)
    # Second reference: F.conv2d, zero-padding each intermediate after
    # rounding it to the working dtype.
    y = xt.float()[None]
    for k in range(n):
        y = torch.relu(F.conv2d(y, wt[k].float(), bt[k].float(), padding=0 if k == 0 else 1))
        y = y.to(xt.dtype).float()
    _assert_close(got, y[0].numpy(), dtype)
    # A chain that kept the values computed on the ring would differ.
    frame = F.pad(xt.float(), (n - 1,) * 4)[None]
    for k in range(n):
        frame = torch.relu(F.conv2d(frame, wt[k].float(), bt[k].float())).to(xt.dtype).float()
    assert frame.shape[-2:] == (H, W)
    assert (frame[0] - y[0]).abs().max() > 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fpnprim_matches_pallas(dtype):
    rng = np.random.default_rng(2)
    (xj, xt), (wj, wt), (bj, bt) = (
        _both(a, dtype) for a in (_planes(rng, C, 2),
                                  rng.standard_normal((C, C, 5, 5)) * 0.1,
                                  rng.standard_normal(C)))
    o1, o2 = PlaneConvKernels().fpnprim(xt, wt, bt)
    assert o1.shape == (C, H // 2, W // 2) and o2.shape == (C, H, W)
    w1, w2 = pallas_conv.pallas_fpnprim(xj, wj, bj, interpret=True)
    _assert_close(o1, w1, dtype)
    _assert_close(o2, w2, dtype)
    # Second reference: a stride-2 F.conv2d, upsampled, last 3 rows zero.
    y = F.conv2d(xt.float()[None], wt.float(), bt.float(), stride=2)
    up = F.interpolate(y, scale_factor=2, mode="nearest")[0]
    up[:, H - 3:] = 0
    _assert_close(o1, y[0].to(xt.dtype).float().numpy(), dtype)
    _assert_close(o2, up.to(xt.dtype).float().numpy(), dtype)
    assert (o2[:, H - 3:] == 0).all() and (o2[:, H - 4] != 0).any()


def _cu_constant(name: str) -> int:
    text = plane_conv.SOURCE.read_text()
    return int(re.search(rf"\b{name} = (\d+)", text).group(1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_convchain_tile_replay(dtype):
    """The CUDA kernel's tiling, replayed in torch: each output tile of
    kChainTH x kChainTW loads a frame with a halo of n pixels, every layer
    computes a region one pixel smaller per side and zeroes the positions
    outside the image, and the last writes the tile.  On a ragged plane
    (tiles cut at the right and bottom edges, c not a multiple of 8) it must
    equal the plain version."""
    th, tw = _cu_constant("kChainTH"), _cu_constant("kChainTW")
    g = torch.Generator().manual_seed(3)
    c, n, h, w = 5, 3, th + 5, 2 * tw + 7
    x = F.pad(torch.randn(c, h, w, generator=g), (1,) * 4).to(dtype)
    ws = (torch.randn(n, c, c, 3, 3, generator=g) * 0.3).to(dtype)
    bs = (torch.randn(n, c, generator=g) * 0.1 + 0.3).to(dtype)
    R, C_ = th + 2 * n, tw + 2 * n
    out = torch.full((c, h, w), float("nan"))
    for oy in range(0, h, th):
        for ox in range(0, w, tw):
            # frame row f is image row oy - n + f, x's padded row oy - n + f + 1
            frame = torch.zeros(c, R, C_)
            r0, c0 = oy - n + 1, ox - n + 1
            rs, cs = max(r0, 0), max(c0, 0)
            re_, ce = min(r0 + R, h + 2), min(c0 + C_, w + 2)
            frame[:, rs - r0:re_ - r0, cs - c0:ce - c0] = x[:, rs:re_, cs:ce].float()
            for k in range(n):
                region = plane_conv._conv3x3_planes(frame[:, k:R - k, k:C_ - k], ws[k].float())
                region = torch.relu(region + bs[k].float()[:, None, None])
                iy = torch.arange(oy - n + k + 1, oy - n + R - k - 1)[:, None]
                ix = torch.arange(ox - n + k + 1, ox - n + C_ - k - 1)[None]
                inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                if k == n - 1:
                    assert region.shape[1:] == (th, tw)
                    hh, ww = min(th, h - oy), min(tw, w - ox)
                    out[:, oy:oy + hh, ox:ox + ww] = region[:, :hh, :ww].to(dtype).float()
                else:
                    region = torch.where(inside, region.to(dtype).float(), torch.zeros(()))
                    frame = torch.zeros(c, R, C_)
                    frame[:, k + 1:R - k - 1, k + 1:C_ - k - 1] = region
    want = convchain_reference(x, ws, bs).float()
    assert not out.isnan().any()
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-4)
    else:
        assert (out - want).abs().max() <= microbench_conv.bf16_tol(want)


def test_wrappers_take_plain_path_on_cpu_only():
    kernels = PlaneConvKernels()
    args = {name: microbench_conv.inputs(name, 3, 6, 10, torch.float32, "cpu")
            for name in plane_conv.KERNELS}
    assert torch.equal(kernels.conv1(*args["conv1"]), conv1_reference(*args["conv1"]))
    kernels.convchain(*args["convchain"])
    kernels.fpnprim(*args["fpnprim"])
    assert kernels.launches == {"conv1": 0, "convchain": 0, "fpnprim": 0}
    # Off the CPU there is no plain fallback: the wrapper launches or raises.
    for name, a in args.items():
        with pytest.raises(ValueError, match="CUDA"):
            getattr(kernels, name)(*(t.to("meta") for t in a))
    assert kernels.launches == {"conv1": 0, "convchain": 0, "fpnprim": 0}


def test_microbench_check_on_cpu_and_no_gpu_exit(monkeypatch, capsys):
    microbench_conv.main(["--check", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("numerics OK") == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        microbench_conv.main([])
    assert exc.value.code not in (None, 0)


def test_work_and_bound_at_the_bench_shape():
    """Bytes and operations of the bench shapes (C8, 512x640): every
    kernel is bound by device memory in bf16; the float32 chain of 4 by
    float32 operations."""
    for name in plane_conv.KERNELS:
        args = microbench_conv.inputs(name, 8, 512, 640, torch.bfloat16, "meta")
        n_bytes, flops = plane_conv.work(name, args)
        ms, by = bound_ms(n_bytes, flops, torch.bfloat16)
        assert by == "bytes" and 0.003 < ms < 0.004, (name, ms)
    args = microbench_conv.inputs("convchain", 8, 512, 640, torch.float32, "meta")
    assert bound_ms(*plane_conv.work("convchain", args), torch.float32)[1] == "operations"
