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

The CUDA kernels cannot run here; ``test_convchain_tile_replay`` replays
the chain's tiled algorithm (halo of n pixels recomputed per tile,
intermediates zeroed outside the image, float32's strips of a thread's
register tile) in torch with the tile tables of ``csrc/plane_conv.cu``, and
``test_convchain_bf16_fragment_replay`` replays the bf16 kernel's tensor-core
algorithm (ldmatrix lane addresses, B fragments of hi and lo weights,
m16n8k16 steps over tap pairs and an m16n8k8 step for tap 9, the epilogue's
rounding) from the same constants, on ragged planes with c = 5 and c = 12.
The single-pass kernels of conv1 and fpnprim are replayed the same way:
``test_conv_bf16_fragment_replay`` (fpnprim's stride-2 column-parity frame
and its 13 K steps, tap 24 on m16n8k8, hi and lo at c = 5 and 8; conv1 with
c_in != c_out), ``test_conv_f32_replay`` (the float32 register tiles, their
conflict-free float2 windows, the (ci, ky, kx) sums) and
``test_fpnprim_store_pass_replay`` (16-byte pieces where whole and aligned,
o2's masked rows, the odd-width tail); ``test_conv1_and_fpnprim_shape_lines``
holds the wrapper's refusal lines to the source.
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
from tests.test_torch_port_network import run_jitted

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
    want = run_jitted(lambda *a: pallas_conv.pallas_conv1(*a, interpret=True), xj, wj, bj)
    _assert_close(got, want, dtype)
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
    want = run_jitted(lambda *a: pallas_conv.pallas_convchain(*a, interpret=True), xj, wj, bj)
    _assert_close(got, want, dtype)
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
    w1, w2 = run_jitted(lambda *a: pallas_conv.pallas_fpnprim(*a, interpret=True), xj, wj, bj)
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


def _cu_tiles(name: str) -> tuple[tuple[int, int, int], ...]:
    """A tile table of csrc/plane_conv.cu:
    ``constexpr Tile name[] = {{th, tw, threads}, ...};``."""
    body = re.search(rf"constexpr Tile {name}\[\] = \{{(.*?)\}};", plane_conv.SOURCE.read_text())
    return tuple(tuple(int(v) for v in row)
                 for row in re.findall(r"\{(\d+), (\d+), (\d+)\}", body.group(1)))


def _chain_inputs(c, n, h, w, dtype, seed, bf16_weights=True):
    """A ragged plane (c, h+2, w+2) in ``dtype`` with its zero ring, weights
    ~ N(0, 0.3) (rounded to bf16 unless ``bf16_weights`` is False) and
    biases near +0.3, so that intermediates are positive next to the image."""
    g = torch.Generator().manual_seed(seed)
    x = F.pad(torch.randn(c, h, w, generator=g), (1,) * 4).to(dtype)
    ws = torch.randn(n, c, c, 3, 3, generator=g) * 0.3
    bs = torch.randn(n, c, generator=g) * 0.1 + 0.3
    if bf16_weights:
        ws, bs = ws.to(torch.bfloat16).float(), bs.to(torch.bfloat16).float()
    return x, ws, bs


def _load_frame(x, c, n, h, w, oy, ox, R, C_):
    """The tile's frame (c, R, C_) as float32: frame row f is image row
    oy - n + f, x's padded row oy - n + f + 1; zero outside x."""
    frame = torch.zeros(c, R, C_)
    r0, c0 = oy - n + 1, ox - n + 1
    rs, cs = max(r0, 0), max(c0, 0)
    re_, ce = min(r0 + R, h + 2), min(c0 + C_, w + 2)
    frame[:, rs - r0:re_ - r0, cs - c0:ce - c0] = x[:, rs:re_, cs:ce].float()
    return frame


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_convchain_tile_replay(dtype):
    """The CUDA kernels' tiling, replayed in torch: each output tile (the
    first row of the dtype's tile table) loads a frame with a halo of n
    pixels, every layer computes a region one pixel smaller per side and
    zeroes the positions outside the image, and the last writes the tile.
    On a ragged plane (tiles cut at the right and bottom edges, c not a
    multiple of 8) it must equal the plain version.  float32 also replays
    the strips of kF32Px pixels that a thread takes: rows fastest, every
    region pixel written once, windows within the frame and its slack, and
    an odd row pitch."""
    th, tw, _ = _cu_tiles("kBf16Tiles" if dtype == torch.bfloat16 else "kF32Tiles")[0]
    c, n, h, w = 5, 3, th + 5, 2 * tw + 7
    x, ws, bs = _chain_inputs(c, n, h, w, dtype, 3, bf16_weights=dtype == torch.bfloat16)
    ws, bs = ws.to(dtype), bs.to(dtype)
    R, C_ = th + 2 * n, tw + 2 * n
    px, S = _cu_constant("kF32Px"), C_ | 1
    assert S % 2 == 1 and S >= C_
    out = torch.full((c, h, w), float("nan"))
    for oy in range(0, h, th):
        for ox in range(0, w, tw):
            frame = _load_frame(x, c, n, h, w, oy, ox, R, C_)
            for k in range(n):
                region = plane_conv._conv3x3_planes(frame[:, k:R - k, k:C_ - k], ws[k].float())
                region = torch.relu(region + bs[k].float()[:, None, None])
                iy = torch.arange(oy - n + k + 1, oy - n + R - k - 1)[:, None]
                ix = torch.arange(ox - n + k + 1, ox - n + C_ - k - 1)[None]
                inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                if dtype == torch.float32:
                    rr, rc, end = R - 2 * (k + 1), C_ - 2 * (k + 1), C_ - k - 1
                    items = torch.arange(rr * -(-rc // px))
                    strip = items // rr
                    fr, fc = k + 1 + items - strip * rr, k + 1 + strip * px
                    writes = torch.zeros(R, C_, dtype=torch.int64)
                    for p in range(px):
                        keep = fc + p < end
                        writes.index_put_((fr[keep], fc[keep] + p), torch.ones(()).long(),
                                          accumulate=True)
                    assert (writes[k + 1:R - k - 1, k + 1:end] == 1).all()
                    assert writes.sum() == rr * rc
                    # The last window read (channel c - 1, row fr + 1, up to
                    # column fc + px) stays inside the frame and its slack.
                    last_read = ((c - 1) * R + fr + 1) * S + fc + px
                    assert int(last_read.max()) < c * R * S + px
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


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _stage_fragments(ws: torch.Tensor, steps: int):
    """The bf16 kernels' staging of B fragments (fetch_layer): ws (n, c_out,
    c_in, k, k); entry i of the [layer][nt][cg][step][lane] table holds, for
    lane (g, t), the weights of output channel nt * 8 + g at (tap 2s, ci 2t
    and 2t + 1) and (tap 2s + 1, the same ci), ci counted from cg * 8, zero
    past c_in, c_out and the k * k taps; as hi = bf16(w) and lo = bf16(w -
    hi).  Returns hi and lo as float32 (n, GO, GI, steps, 32, 4)."""
    n, c_out, c_in, k = ws.shape[:4]
    taps, GI, GO = k * k, -(-c_in // 8), -(-c_out // 8)
    i = torch.arange(n * GO * GI * steps * 32)
    lane, s, rest = i & 31, (i >> 5) % steps, (i >> 5) // steps
    cg, nt, layer = rest % GI, (rest // GI) % GO, rest // (GI * GO)
    co, ci = nt * 8 + (lane >> 2), cg * 8 + 2 * (lane & 3)
    wf = ws.reshape(n, c_out, c_in, taps).float()
    v = torch.zeros(i.shape[0], 4)
    for e in range(4):
        tap, cc = 2 * s + (e >> 1), ci + (e & 1)
        ok = (co < c_out) & (cc < c_in) & (tap < taps)
        v[:, e] = torch.where(ok, wf[layer, co.clamp(max=c_out - 1), cc.clamp(max=c_in - 1),
                                     tap.clamp(max=taps - 1)], torch.zeros(()))
    hi = _bf16(v)
    lo = _bf16(v - hi)
    shape = (n, GO, GI, steps, 32, 4)
    return hi.reshape(shape), lo.reshape(shape)


def _b_matrix(frag: torch.Tensor) -> torch.Tensor:
    """The mma's B operand (16 x 8, k x n) from 32 lanes' fragments (32, 4):
    lane (g, t) holds b0 = (B[2t][g], B[2t + 1][g]) and b1 = (B[2t + 8][g],
    B[2t + 9][g])."""
    lane = torch.arange(32)
    g, t = lane >> 2, lane & 3
    B = torch.zeros(16, 8)
    for e, row in enumerate((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)):
        B[row, g] = frag[:, e]
    return B


def _a_matrix(rows8: torch.Tensor) -> torch.Tensor:
    """The mma's A operand from one ldmatrix: rows8 (M tiles, lanes, 8) are
    the 16-byte rows whose addresses the lanes gave; matrix j is lanes
    8j .. 8j + 7.  x4 (32 lanes): a0 = matrix 0 (rows 0-7, k 0-7), a1 =
    matrix 1 (rows 8-15), a2 = matrix 2 (rows 0-7, k 8-15), a3 = matrix 3;
    x2 (16 lanes): a 16 x 8 operand from matrices 0 and 1."""
    m = rows8.reshape(rows8.shape[0], -1, 8, 8)
    if m.shape[1] == 2:
        return torch.cat([m[:, 0], m[:, 1]], dim=1)
    return torch.cat([torch.cat([m[:, 0], m[:, 2]], dim=2), torch.cat([m[:, 1], m[:, 3]], dim=2)],
                     dim=1)


def _bf16_kernel_replay(x, ws, bs, use_lo=None):
    """convchain_bf16_kernel, replayed tile by tile in torch from the
    constants of csrc/plane_conv.cu: frames of 8-channel rows, M tiles of 16
    region pixels in row-major order (the tail repeating the last pixel),
    per channel group kSteps K steps (m16n8k16 on tap pairs, m16n8k8 on tap
    8) with hi and lo B fragments per n8 tile, float32 sums in two chains
    (even and odd steps, each lo MMA in the other chain), and the
    epilogue: bias and ReLU in float32, zero outside the image, one rounding
    to bf16, stored at accumulator row g or g + 8's region pixel.  ``use_lo`` overrides
    the kernel's per-layer flag (any lo fragment of the layer nonzero).
    Returns (output, the layers' flags)."""
    steps = _cu_constant("kSteps")
    th, tw, _ = _cu_tiles("kBf16Tiles")[0]
    n, c = ws.shape[:2]
    h, w = x.shape[1] - 2, x.shape[2] - 2
    G = -(-c // 8)
    assert G <= _cu_constant("kMaxGroups")
    hi, lo = _stage_fragments(ws, steps)
    has_lo = [bool((lo[k] != 0).any()) if use_lo is None else use_lo for k in range(n)]
    Bs = {(part, k, nt, cg, s): _b_matrix(f[k, nt, cg, s])
          for part, f in (("hi", hi), ("lo", lo))
          for k in range(n) for nt in range(G) for cg in range(G) for s in range(steps)}
    bias = torch.zeros(n, G * 8)
    bias[:, :c] = bs.float()
    R, C_ = th + 2 * n, tw + 2 * n
    lane = torch.arange(32)
    taps = [2 * s + (lane >> 4) if s < steps - 1 else torch.full((32,), 8) for s in range(steps)]
    out = torch.full((c, h, w), float("nan"))
    for oy in range(0, h, th):
        for ox in range(0, w, tw):
            frame = torch.zeros(G * 8, R, C_)
            frame[:c] = _load_frame(x, c, n, h, w, oy, ox, R, C_)
            frame = frame.reshape(G, 8, R * C_).transpose(1, 2)  # [cg][pixel][8]
            for k in range(n):
                rr, rc = R - 2 * (k + 1), C_ - 2 * (k + 1)
                npx = rr * rc
                m = torch.arange(-(-npx // 16))[:, None]
                p = torch.clamp(m * 16 + (lane & 15), max=npx - 1)  # (M tiles, lanes)
                fr, fc = k + 1 + p // rc, k + 1 + p % rc
                pix = fr * C_ + fc
                # Two chains a tile: step s's hi MMA into chain s & 1, its lo
                # MMA into the other; summed before the bias.
                acc = torch.zeros(G, 2, m.shape[0], 16, 8)
                for cg in range(G):
                    for s in range(steps):
                        tap = taps[s]
                        addr = pix + (tap // 3 - 1) * C_ + tap % 3 - 1
                        rows8 = frame[cg][addr]  # (M tiles, lanes, 8)
                        a = _a_matrix(rows8 if s < steps - 1 else rows8[:, :16])
                        for nt in range(G):
                            for part in ("hi", "lo") if has_lo[k] else ("hi",):
                                chain = (s + (part == "lo")) & 1
                                b = Bs[(part, k, nt, cg, s)][:a.shape[2]]
                                acc[nt, chain] = acc[nt, chain] + a @ b
                acc = acc[:, 0] + acc[:, 1]
                # Row r of an M tile is region pixel m * 16 + r: the pixel
                # whose row address lane r gave ldmatrix.
                qpix = pix[:, :16].reshape(-1)
                y, xx = oy - n + fr[:, :16].reshape(-1), ox - n + fc[:, :16].reshape(-1)
                keep = (m * 16 + torch.arange(16)).reshape(-1) < npx
                inside = (y >= 0) & (y < h) & (xx >= 0) & (xx < w)
                dst = torch.zeros(G, R * C_, 8)
                for nt in range(G):
                    v = torch.relu(acc[nt].reshape(-1, 8) + bias[k, nt * 8:nt * 8 + 8])
                    if k < n - 1:
                        v = torch.where(inside[:, None], v, torch.zeros(()))
                    dst[nt, qpix[keep]] = _bf16(v[keep])
                frame = dst
            planes = frame.transpose(1, 2).reshape(G * 8, R, C_)
            hh, ww = min(th, h - oy), min(tw, w - ox)
            out[:, oy:oy + hh, ox:ox + ww] = planes[:c, n:n + hh, n:n + ww]
    assert not out.isnan().any()
    return out, has_lo


@pytest.mark.parametrize("bf16_weights", [True, False], ids=["bf16-weights", "float32-weights"])
@pytest.mark.parametrize("c", [5, 12])
def test_convchain_bf16_fragment_replay(c, bf16_weights):
    """The bf16 chain kernel's tensor-core algorithm, replayed in torch on a
    ragged plane (2 x 2 tiles cut at the edges; c = 5 pads the channels to
    8, c = 12 takes two channel groups and two n8 tiles), held to
    ``convchain_reference`` within bf16_tol.  The hi/lo split: weights that
    are bf16 values give lo = 0 everywhere and the kernel's per-layer flag
    skips the lo MMAs (exact); float32 weights set it, hi + lo is within
    2**-16 of w,
    and fewer outputs differ from the plain version with lo than without."""
    th, tw, _ = _cu_tiles("kBf16Tiles")[0]
    n, h, w = 3, th + 5, tw + 7
    x, ws, bs = _chain_inputs(c, n, h, w, torch.bfloat16, 10 + c, bf16_weights)
    want = convchain_reference(x, ws, bs).float()
    got, has_lo = _bf16_kernel_replay(x, ws, bs)
    assert has_lo == [not bf16_weights] * n
    assert (got - want).abs().max() <= microbench_conv.bf16_tol(want)
    share = float((got != want).float().mean())
    print(f"c={c} {'bf16' if bf16_weights else 'float32'} weights: {100 * share:.2f} % of the "
          f"outputs differ from the plain version (by at most "
          f"{float((got - want).abs().max()):.3e})")
    if bf16_weights:
        assert not _stage_fragments(ws, _cu_constant("kSteps"))[1].any()
        return
    # Each weight as hi + lo: |w - (hi + lo)| <= 2**-16 |w|.
    full = ws.reshape(ws.shape[0], c, c, 9)
    err = (full - (_bf16(full) + _bf16(full - _bf16(full)))).abs()
    assert (err <= 2.0**-16 * full.abs()).all()
    hi_only, _ = _bf16_kernel_replay(x, ws, bs, use_lo=False)
    share_hi = float((hi_only != want).float().mean())
    print(f"  without the lo MMAs: {100 * share_hi:.2f} %")
    assert share < share_hi


def _store_prim_tile(stage, th, tw, es, H, W, oy, ox, o1, o2, writes):
    """store_prim_tile replayed: o1's rows of the tile in pieces of 16 / es
    values, o2's two rows per o1 row in pieces of 8 / es o1 values, each
    twice, rows >= H - 3 zero; a piece is a 16-byte vector where it is whole
    (within the tile's valid width) and its address (outputs 16-byte
    aligned) is a multiple of 16, else stored value by value.  Counts every
    element written in ``writes`` (o1's, o2's); returns (vector pieces,
    value-by-value pieces)."""
    c = o1.shape[0]
    V1, V2 = 16 // es, 8 // es
    Ho, Wo = H // 2, W // 2
    nr, nc = min(th, Ho - oy), min(tw, Wo - ox)
    counts = [0, 0]
    for out, cnt, rows, V in ((o1, writes[0], th, V1), (o2, writes[1], 2 * th, V2)):
        co, rr, k = (t.reshape(-1) for t in torch.meshgrid(
            torch.arange(c), torch.arange(rows), torch.arange(tw // V), indexing="ij"))
        col = k * V
        if out is o1:
            r, y, idx = rr, oy + rr, (co * Ho + oy + rr) * Wo + ox + col
        else:
            r = rr >> 1
            y = 2 * (oy + r) + (rr & 1)
            idx = (co * H + y) * W + 2 * (ox + col)
        keep = (r < nr) & (col < nc)
        vec = keep & (col + V <= nc) & (idx * es % 16 == 0)
        counts[0] += int(vec.sum())
        counts[1] += int((keep & ~vec).sum())
        for e in range(V):
            m = keep & (col + e < nc)
            v = stage[co[m], r[m] * tw + col[m] + e]
            if out is o1:
                dst = [idx[m] + e]
            else:
                v = torch.where(y[m] >= H - 3, torch.zeros(()), v)
                dst = [idx[m] + 2 * e, idx[m] + 2 * e + 1]
            for d in dst:
                out.view(-1)[d] = v
                cnt.view(-1).index_add_(0, d, torch.ones(d.shape[0]))
    return tuple(counts)


def _cu_single_pass(name: str):
    """The source's single-pass conv kind ``name``: ConvBf16's (K, STRIDE,
    TH, TW, ReLU) for Conv1Bf16 and PrimBf16, ConvF32's (K, STRIDE, TH, TW,
    CO, ReLU) with its kPx for Conv1F32 and PrimF32."""
    text = plane_conv.SOURCE.read_text()
    if name.endswith("Bf16"):
        k, stride, th, tw, relu = re.search(
            rf"using {name} = ConvBf16<(\d+), (\d+), (\d+), (\d+), (true|false)>;", text).groups()
        return int(k), int(stride), int(th), int(tw), relu == "true"
    k, stride, tw, co, relu = re.search(
        rf"using {name} = ConvF32<(\d+), (\d+), (\d+), (\d+), (true|false)>;", text).groups()
    th = int(re.search(r"STRIDE = STRIDE_, TH = (\d+)", text).group(1))
    return int(k), int(stride), th, int(tw), int(co), relu == "true", _cu_constant("kPx")


def _conv_bf16_replay(name, x, w, b, use_lo=None):
    """conv_bf16_kernel (conv1 or fpnprim), replayed tile by tile in torch
    from the constants of csrc/plane_conv.cu: the frame of x's padded rows
    from STRIDE * oy and column pairs from STRIDE * ox as 8-channel rows
    (zero past c_in and outside x), stride 2's columns stored by parity
    (column 2q at pixel q, 2q + 1 at pixel CE + q); M tiles of 16 output
    pixels in row-major order over the tile; per input group the K steps,
    lane l's ldmatrix row at tap 2s + l / 16 (m16n8k16) and the last tap at
    the last step (x2, m16n8k8), i.e. at frame row STRIDE pr + ky, pixel pc
    + slot(kx); hi and lo B fragments in two chains; the epilogue (bias, and
    conv1's ReLU, in float32, one rounding to bf16) into the stage, then
    the store pass.  Returns (outputs, the lo flag, the store pass's
    (vector, value-by-value) pieces)."""
    K, stride, th, tw, relu = _cu_single_pass("Conv1Bf16" if name == "conv1" else "PrimBf16")
    assert (K, stride, (th, tw)) == plane_conv.SINGLE_PASS[torch.bfloat16][name]
    steps, taps = (K * K + 1) // 2, K * K
    c_out, c_in = w.shape[:2]
    GI, GO = -(-c_in // 8), -(-c_out // 8)
    pad = (K - 1) // 2
    Ho, Wo = (x.shape[1] - 2 * pad) // stride, (x.shape[2] - 2 * pad) // stride
    fr, ce = stride * (th - 1) + K, (stride * (tw - 1) + K + 1) // 2

    def slot(q):
        return (q & 1) * ce + (q >> 1) if stride == 2 else q

    hi, lo = _stage_fragments(w[None], steps)
    has_lo = bool((lo != 0).any()) if use_lo is None else use_lo
    Bs = {(part, nt, cg, s): _b_matrix(f[0, nt, cg, s]) for part, f in (("hi", hi), ("lo", lo))
          for nt in range(GO) for cg in range(GI) for s in range(steps)}
    bias = torch.zeros(GO * 8)
    bias[:c_out] = b.float()
    lane = torch.arange(32)
    toff = []
    for s in range(steps):
        tap = 2 * s + (lane >> 4) if s < steps - 1 else torch.full((32,), taps - 1)
        toff.append(tap // K * 2 * ce + slot(tap % K))
    outs = (torch.full((c_out, Ho, Wo), float("nan")),) + (
        (torch.full((c_out, 2 * Ho, 2 * Wo), float("nan")),) if name == "fpnprim" else ())
    writes, pieces = tuple(torch.zeros(o.shape) for o in outs), [0, 0]
    mt = th * tw // 16
    p = torch.arange(mt)[:, None] * 16 + (lane & 15)
    pix = stride * (p // tw) * 2 * ce + p % tw
    for oy in range(0, Ho, th):
        for ox in range(0, Wo, tw):
            region = torch.zeros(GI * 8, fr, 2 * ce)
            r1, c1 = min(stride * oy + fr, x.shape[1]), min(stride * ox + 2 * ce, x.shape[2])
            region[:c_in, :r1 - stride * oy, :c1 - stride * ox] = \
                x[:, stride * oy:r1, stride * ox:c1].float()
            if stride == 2:
                region = torch.cat([region[:, :, 0::2], region[:, :, 1::2]], dim=2)
            frame = region.reshape(GI, 8, fr * 2 * ce).transpose(1, 2)  # [cg][pixel][8]
            acc = torch.zeros(GO, 2, mt, 16, 8)
            for cg in range(GI):
                for s in range(steps):
                    rows8 = frame[cg][pix + toff[s]]  # (M tiles, lanes, 8)
                    a = _a_matrix(rows8 if s < steps - 1 else rows8[:, :16])
                    for nt in range(GO):
                        for part in ("hi", "lo") if has_lo else ("hi",):
                            chain = (s + (part == "lo")) & 1
                            acc[nt, chain] += a @ Bs[(part, nt, cg, s)][:a.shape[2]]
            acc = (acc[:, 0] + acc[:, 1]).reshape(GO, th * tw, 8)
            v = torch.cat([(acc[nt] + bias[nt * 8:nt * 8 + 8]).T for nt in range(GO)])
            stage = _bf16(torch.relu(v) if relu else v)
            if name == "conv1":
                hh, ww = min(th, Ho - oy), min(tw, Wo - ox)
                outs[0][:, oy:oy + hh, ox:ox + ww] = stage[:c_out].view(c_out, th, tw)[:, :hh, :ww]
                writes[0][:, oy:oy + hh, ox:ox + ww] += 1
            else:
                for i, n in enumerate(_store_prim_tile(stage, th, tw, 2, 2 * Ho, 2 * Wo, oy, ox,
                                                       *outs, writes)):
                    pieces[i] += n
    assert all((t == 1).all() for t in writes)
    return outs, has_lo, pieces


@pytest.mark.parametrize("name, c_in, c_out, bf16_weights", [
    ("fpnprim", 5, 5, True), ("fpnprim", 5, 5, False), ("fpnprim", 8, 8, True),
    ("fpnprim", 8, 8, False), ("conv1", 5, 12, False), ("conv1", 12, 5, False)])
def test_conv_bf16_fragment_replay(name, c_in, c_out, bf16_weights):
    """The bf16 single-pass kernel's tensor-core algorithm, replayed in
    torch on a ragged plane (2 x 2 tiles cut at the edges, an odd output
    width; c = 5 pads the channels to 8, 12 takes two groups), every output
    held to the plain version within bf16_tol: fpnprim's stride-2 taps
    through the column-parity frame and its K order (12 tap pairs on
    m16n8k16, tap 24 on m16n8k8: 200 of 208 K slots), conv1's c_in != c_out
    with its ReLU; and the hi/lo split (weights that are bf16 values skip
    the lo MMAs exactly; float32 weights take them, and fewer outputs then
    differ from the plain version than without)."""
    K, stride, th, tw, _ = _cu_single_pass("Conv1Bf16" if name == "conv1" else "PrimBf16")
    assert th * tw % 32 == 0 and tw % 8 == 0 and K * K % 2 == 1
    if name == "fpnprim":
        steps = (K * K + 1) // 2
        assert 2 * (steps - 1) == 24 and 16 * (steps - 1) + 8 == 25 * 8 and 16 * steps == 208
    g = torch.Generator().manual_seed(40 + c_in + 3 * c_out)
    H, W = stride * (th + 3), stride * (tw + 7)
    x = F.pad(torch.randn(c_in, H, W, generator=g), ((K - 1) // 2,) * 4).to(torch.bfloat16)
    w = torch.randn(c_out, c_in, K, K, generator=g) * (0.1 if K == 5 else 0.3)
    b = torch.randn(c_out, generator=g)
    if bf16_weights:
        w, b = _bf16(w), _bf16(b)
    want = plane_conv.fpnprim_reference(x, w, b) if name == "fpnprim" else \
        (conv1_reference(x, w, b),)
    want = [t.float() for t in want]
    outs, has_lo, _ = _conv_bf16_replay(name, x, w, b)
    assert has_lo == (not bf16_weights)
    for got, ref in zip(outs, want):
        assert (got - ref).abs().max() <= microbench_conv.bf16_tol(ref)
    if name == "fpnprim":
        o1, o2 = outs
        assert (o2[:, H - 3:] == 0).all() and torch.equal(o2[:, :H - 3:2, ::2], o1[:, :(H - 2) // 2])
    if not bf16_weights:
        without, _, _ = _conv_bf16_replay(name, x, w, b, use_lo=False)
        assert (outs[0] != want[0]).float().mean() < (without[0] != want[0]).float().mean()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("W", [640, 634])
def test_fpnprim_store_pass_replay(dtype, W):
    """The fpnprim kernels' store pass from the source's tiles: at the
    bench width (640) every piece is a 16-byte vector (bf16 8 o1 values or
    4 o1 values twice; float32 4, or 2 twice); at the smoke's ragged width
    (634: o1 317 wide, odd, rows not 16-byte aligned) the tail and the
    misaligned rows go value by value (o2 a pair at a time); every element of o1 and o2 is
    written once, o2 is o1 twice in both directions with rows >= H - 3
    zero, exactly."""
    th, tw = _cu_single_pass("PrimBf16" if dtype == torch.bfloat16 else "PrimF32")[2:4]
    es = torch.empty((), dtype=dtype).element_size()
    H = 2 * th + 6  # two tile rows, the second cut, with the masked rows in it
    c = 3
    g = torch.Generator().manual_seed(W)
    y = torch.randn(c, H // 2, W // 2, generator=g).to(dtype).float()  # o1 as the kernel rounds it
    o1 = torch.full(y.shape, float("nan"))
    o2 = torch.full((c, H, W), float("nan"))
    writes, pieces = (torch.zeros(o1.shape), torch.zeros(o2.shape)), [0, 0]
    for oy in range(0, H // 2, th):
        for ox in range(0, W // 2, tw):
            stage = torch.zeros(c, th * tw)
            tile = y[:, oy:oy + th, ox:ox + tw]
            stage.view(c, th, tw)[:, :tile.shape[1], :tile.shape[2]] = tile
            for i, n in enumerate(_store_prim_tile(stage, th, tw, es, H, W, oy, ox, o1, o2, writes)):
                pieces[i] += n
    assert all((t == 1).all() for t in writes)
    up = y.repeat_interleave(2, 1).repeat_interleave(2, 2)
    up[:, H - 3:] = 0
    assert torch.equal(o1, y) and torch.equal(o2, up)
    if W == 640:
        assert pieces[1] == 0
    else:
        assert pieces[0] > 0 and pieces[1] > 0


@pytest.mark.parametrize("name", ["conv1", "fpnprim"])
def test_conv_f32_replay(name):
    """The float32 conv1 / fpnprim kernel (conv_f32_kernel) from the
    source's constants: a thread per (half of each group's channels, output
    row, strip of kPx columns), a warp on the tile's 32 rows; the frame's
    rows stored by parity at stride 2, at a pitch of 2 mod 4 floats over
    its column pairs; each thread's float2 window reads stay in the loaded
    columns and are conflict-free per half-warp; sums in (ci, ky, kx)
    order, bias (and conv1's ReLU), then the store pass: within 1e-5 / 1e-4
    of the plain version on a ragged plane (2 x 3 tiles, the last column
    tile 3 wide; c_in != c_out for conv1, 12 channels: two groups)."""
    K, stride, th, tw, CO, relu, P = _cu_single_pass("Conv1F32" if name == "conv1" else "PrimF32")
    assert (K, stride, (th, tw)) == plane_conv.SINGLE_PASS[torch.float32][name] and th == 32
    fr = stride * (th - 1) + K
    rh = -(-fr // stride)
    pairs = (stride * (tw - 1) + K + 1) // 2
    S, win, halves = 2 * (pairs | 1), stride * (P - 1) + K, 8 // CO
    assert S % 4 == 2 and S >= 2 * pairs >= stride * (tw - 1) + K
    t = torch.arange(th * (tw // P) * halves)
    half, rest = t // (th * (tw // P)), t % (th * (tw // P))
    row, j0 = rest % th, rest // th * P
    assert int((stride * j0 + win).max()) <= 2 * pairs and (stride * j0 % 2 == 0).all()

    def stored(r, ky):  # stored row of frame row stride * r + ky
        return (ky & 1) * rh + r + (ky >> 1) if stride == 2 else r + ky

    for ky in range(K):
        sr = stored(row, ky)
        assert int(sr.max()) < stride * rh
        for e in range(win // 2):
            pair = (sr * S + stride * j0 + 2 * e) // 2  # float2 index
            for hw in pair.reshape(-1, 16):
                assert len(set((hw % 16).tolist())) == 16
    c_in, c_out = (5, 12) if name == "conv1" else (12, 12)
    pad = (K - 1) // 2
    Ho, Wo = th + 5, 2 * tw + 3
    H, W = stride * Ho, stride * Wo
    g = torch.Generator().manual_seed(8)
    x = F.pad(torch.randn(c_in, H, W, generator=g), (pad,) * 4)
    w = torch.randn(c_out, c_in, K, K, generator=g) * 0.1
    b = torch.randn(c_out, generator=g)
    outs = (torch.full((c_out, Ho, Wo), float("nan")),) + (
        (torch.full((c_out, H, W), float("nan")),) if name == "fpnprim" else ())
    writes = tuple(torch.zeros(o.shape) for o in outs)
    for oy in range(0, Ho, th):
        for ox in range(0, Wo, tw):
            frame = torch.zeros(c_in, stride * rh, S)
            for f in range(fr):
                r, q0 = stride * oy + f, stride * ox
                if r < x.shape[1]:
                    cols = x[:, r, q0:min(q0 + 2 * pairs, x.shape[2])]
                    frame[:, stored(0, f) if stride == 1 else (f & 1) * rh + f // 2,
                          :cols.shape[1]] = cols
            stage = torch.zeros(c_out, th * tw)
            cols = stride * j0[:, None] + torch.arange(win)
            for gi in range(-(-c_out // 8)):
                co = gi * 8 + half[:, None] * CO + torch.arange(CO)  # (threads, CO)
                wt = F.pad(w, (0, 0, 0, 0, 0, 0, 0, 8))[co]  # zero past c_out
                acc = torch.zeros(t.shape[0], P, CO)
                for ci in range(c_in):
                    for ky in range(K):
                        vals = frame[ci, stored(row, ky)].gather(1, cols)
                        for kx in range(K):
                            acc += vals[:, stride * torch.arange(P) + kx, None] * \
                                wt[:, None, :, ci, ky, kx]
                v = acc + F.pad(b, (0, 8))[co][:, None]
                v = torch.relu(v) if relu else v
                keep = co < c_out
                for p in range(P):
                    idx = (row * tw + j0 + p)[:, None].expand(-1, CO)
                    stage[co[keep], idx[keep]] = v[:, p][keep]
            if name == "conv1":
                o2 = torch.empty(0)
                hh, ww = min(th, Ho - oy), min(tw, Wo - ox)
                outs[0][:, oy:oy + hh, ox:ox + ww] = stage.view(c_out, th, tw)[:, :hh, :ww]
                writes[0][:, oy:oy + hh, ox:ox + ww] += 1
            else:
                _store_prim_tile(stage, th, tw, 4, H, W, oy, ox, *outs, writes)
    assert all((n == 1).all() for n in writes)
    want = (plane_conv.conv1_reference(x, w, b),) if name == "conv1" else \
        plane_conv.fpnprim_reference(x, w, b)
    for got, ref in zip(outs, want):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-4)


def test_conv1_and_fpnprim_shape_lines():
    """The source's single-pass kinds against the wrapper's, and the line
    between the shapes conv1 and fpnprim launch and those they refuse with
    ``ValueError`` before the launch: bf16 takes at most 16 channels a side
    (two groups of 8); float32 whatever its block's shared memory fits
    (conv1 c -> c up to 19, fpnprim up to 13: frame, weights and output
    stage); and fpnprim's x must start on a column pair's boundary (4 bytes
    bf16, 8 float32)."""
    for dt, kinds in ((torch.bfloat16, ("Conv1Bf16", "PrimBf16")),
                      (torch.float32, ("Conv1F32", "PrimF32"))):
        for name, kind in zip(("conv1", "fpnprim"), kinds):
            K, stride, th, tw = _cu_single_pass(kind)[:4]
            assert plane_conv.SINGLE_PASS[dt][name] == (K, stride, (th, tw))
    fits, pfits = plane_conv.conv1_fits, plane_conv.fpnprim_fits
    assert fits(5, 12, torch.bfloat16) and fits(16, 16, torch.bfloat16)
    assert not fits(17, 8, torch.bfloat16) and not fits(8, 17, torch.bfloat16)
    assert max(c for c in range(1, 64) if fits(c, c, torch.float32)) == 19
    assert fits(5, 12, torch.float32) and fits(12, 5, torch.float32)
    assert max(c for c in range(1, 40) if pfits(c, torch.bfloat16)) == 16
    assert max(c for c in range(1, 40) if pfits(c, torch.float32)) == 13
    meta = {"device": "meta"}
    for dt, c_in, c_out in ((torch.bfloat16, 17, 8), (torch.bfloat16, 4, 17), (torch.float32, 20, 20)):
        x = torch.empty(c_in, 10, 12, dtype=dt, **meta)
        w, b = torch.empty(c_out, c_in, 3, 3, **meta), torch.empty(c_out, **meta)
        with pytest.raises(ValueError, match="shared memory"):
            plane_conv._conv1_launch(x, w, b)
    assert plane_conv._conv1_launch(torch.empty(19, 10, 12, **meta), torch.empty(19, 19, 3, 3, **meta),
                                    torch.empty(19, **meta))[1] == (19, 19, 8, 10)
    for dt, c in ((torch.bfloat16, 17), (torch.float32, 14)):
        x = torch.empty(c, 12, 14, dtype=dt, **meta)
        with pytest.raises(ValueError, match="shared memory"):
            plane_conv._fpnprim_launch(x, torch.empty(c, c, 5, 5, **meta), torch.empty(c, **meta))
    for dt in (torch.bfloat16, torch.float32):
        x = torch.zeros(3 * 12 * 14 + 1, dtype=dt)[1:].view(3, 12, 14)
        w, b = torch.zeros(3, 3, 5, 5), torch.zeros(3)
        with pytest.raises(ValueError, match="boundary"):
            plane_conv._fpnprim_launch(x, w, b)
        assert plane_conv._fpnprim_launch(x.clone(), w, b)[1] == (3, 8, 10)


def _pick_tile(tiles, c, n, dtype, H, W, sms=132):
    """The kernel's pick_tile, replayed: among the rows whose shared memory
    fits a block, the least ceil(blocks / sms) x the pixel-layers a block
    computes (every layer's region, the halo included)."""
    def cost(t):
        blocks = -(-H // t[0]) * -(-W // t[1])
        return -(-blocks // sms) * sum((t[0] + 2 * (n - k - 1)) * (t[1] + 2 * (n - k - 1))
                                       for k in range(n))
    fit = [t for t in tiles if plane_conv.convchain_smem(c, n, dtype, t) <= plane_conv.MAX_SMEM]
    return min(fit, key=cost, default=None)


def test_convchain_tables_and_the_shape_line():
    """csrc/plane_conv.cu's tile tables and sizes against the wrapper's
    constants, and the wrapper's line between the shapes it launches and
    those it refuses (``ValueError`` before the launch): float32 takes
    every c and n that the chain took before these tables (a 16 x 32 tile,
    float32 frames and every layer's weights in shared memory: up to c = 20
    at n = 4) and more (c = 24 at n = 4: two layers' weights staged at a
    time); bf16 every c <= 16 among them but the chains of 31 or more
    layers at c <= 3 (a pixel of the frame holds 8 channels) and no c > 16.
    Each table has two rows, the smallest last (the one the wrapper's
    check reads), and the microbench's shapes take both: the bench (C8
    512x640, n = 4, 132 SMs) the first (float32 40 x 64, 130 blocks, one a
    SM; bf16 32 x 40), the check (C8 32x256, n = 3) the 16 x 32 one."""
    tables = {torch.bfloat16: _cu_tiles("kBf16Tiles"), torch.float32: _cu_tiles("kF32Tiles")}
    assert _cu_constant("kMaxSmem") == plane_conv.MAX_SMEM
    assert (_cu_constant("kSteps"), _cu_constant("kF32Px"), _cu_constant("kMaxGroups")) == \
        (plane_conv._STEPS, plane_conv._F32_PX, plane_conv._BF16_MAX_GROUPS)
    assert _cu_constant("kChainThreads") == 256 and \
        all(t[2] == 256 for t in tables[torch.bfloat16])
    assert max(t[2] for t in tables[torch.float32]) == _cu_constant("kF32MaxThreads")
    for dt, rows in tables.items():
        assert len(rows) == 2 and rows[-1][:2] == plane_conv.CHAIN_MIN_TILE
        assert all(t[0] >= rows[-1][0] and t[1] >= rows[-1][1] for t in rows)
        assert _pick_tile(rows, 8, 4, dt, 512, 640) == rows[0]
        assert _pick_tile(rows, 8, 3, dt, 32, 256) == rows[-1]
        # The wrapper's check is the kernel's: some row fits (bf16 c <= 16).
        for c, n in ((8, 4), (16, 17), (24, 4), (4, 40), (17, 1)):
            assert plane_conv.convchain_fits(c, n, dt) == (
                _pick_tile(rows, c, n, dt, 64, 64) is not None
                and not (dt == torch.bfloat16 and c > 16)), (dt, c, n)
    assert _pick_tile(tables[torch.float32], 8, 4, torch.float32, 512, 640) == (40, 64, 640)
    assert -(-512 // 40) * -(-640 // 64) == 130

    def earlier_fits(c, n):  # the earlier kernel: 16 x 32 tiles, float32 frames
        G = -(-c // 8)
        return (2 * c * (16 + 2 * n) * (32 + 2 * n) + n * G * 8 * (9 * c + 1)) * 4 <= 232_448

    fits = plane_conv.convchain_fits
    missed = []
    for c in range(1, 25):
        for n in range(1, 80):
            if earlier_fits(c, n):
                assert fits(c, n, torch.float32), (c, n)
                if c <= 16 and not fits(c, n, torch.bfloat16):
                    missed.append((c, n))
            assert not (c > 16 and fits(c, n, torch.bfloat16))
    assert {c for c, _ in missed} == {1, 2, 3} and min(n for _, n in missed) == 31
    line = {dt: max(c for c in range(1, 40) if fits(c, 4, dt)) for dt in tables}
    assert line == {torch.float32: 24, torch.bfloat16: 16}
    for dt, c, n in ((torch.float32, 25, 4), (torch.bfloat16, 17, 1), (torch.float32, 16, 9)):
        assert not fits(c, n, dt)
        x = torch.empty(c, 10, 12, dtype=dt, device="meta")
        ws, bs = torch.empty(n, c, c, 3, 3, device="meta"), torch.empty(n, c, device="meta")
        with pytest.raises(ValueError, match="shared memory"):
            plane_conv._convchain_launch(x, ws, bs)


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
