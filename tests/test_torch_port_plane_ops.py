"""The plane-primitive kernels (K7) of the port against the Pallas kernels.

The JAX side is the nine Pallas bodies of ``tools/probe_mosaic_ops.py``
(``k`` and its ``pallas_call`` in each ``probe_*``), copied verbatim with
C, H, W as parameters and ``interpret=True``: the tool's probes build their
own inputs and assert inside, so no test can feed them its inputs.  The
port's side is ``PlaneOpsKernels`` on CPU tensors, which runs the plain
versions.  The same numpy inputs, made from a seed, go through both, at the
probe's size (8, 64, 256) and at a ragged one (5, 12, 18; even where a
Pallas ``out_shape`` needs it).

Tolerances: the slices, upsamples, the row mask and the pad copy bits, and
a 0/1 selection product gives one input value per output: equal.  The conv
and products with a random matrix sum float32 in another order than XLA:
atol 1e-5, rtol 1e-4, the plane convs' tolerance.

The CUDA kernels cannot run here; ``test_select_matmul_tile_replay``
replays the product's tiling in torch from the constants of
``csrc/plane_ops.cu``.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from gdb_nerf_tpu_torch.kernels import plane_ops
from gdb_nerf_tpu_torch.kernels.measure import bound_ms
from gdb_nerf_tpu_torch.kernels.plane_ops import PlaneOpsKernels
from gdb_nerf_tpu_torch.tools import probe_ops

ATOL, RTOL = 1e-5, 1e-4
SIZES = [(8, 64, 256), (5, 12, 18)]


def mosaic_probes(C, H, W):
    """The Pallas kernels of tools/probe_mosaic_ops.py:45-288, each a
    function of the probe's inputs, with ``interpret=True``."""

    def sublane_stride2(x):
        def k(x_ref, o_ref):
            x = x_ref[...]
            o_ref[...] = jax.lax.slice(x, (0, 0, 0), (C, H, W), (1, 2, 1))

        return pl.pallas_call(
            k,
            out_shape=jax.ShapeDtypeStruct((C, H // 2, W), x.dtype),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            interpret=True,
        )(x)

    def lane_stride2(x):
        def k(x_ref, o_ref):
            x = x_ref[...]
            o_ref[...] = jax.lax.slice(x, (0, 0, 0), (C, H, W), (1, 1, 2))

        return pl.pallas_call(
            k,
            out_shape=jax.ShapeDtypeStruct((C, H, W // 2), x.dtype),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            interpret=True,
        )(x)

    def lane_downsample_matmul(x, sel):
        def k(x_ref, s_ref, o_ref):
            s = s_ref[...]
            for c in range(C):
                o_ref[c] = jnp.dot(
                    x_ref[c], s, preferred_element_type=jnp.float32
                )

        return pl.pallas_call(
            k,
            out_shape=jax.ShapeDtypeStruct((C, H, W // 2), x.dtype),
            in_specs=[
                pl.BlockSpec(memory_space=pltpu.VMEM),
                pl.BlockSpec(memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            interpret=True,
        )(x, sel)

    def sublane_downsample_matmul(x, sel):
        def k(x_ref, s_ref, o_ref):
            s = s_ref[...]
            for c in range(C):
                o_ref[c] = jnp.dot(
                    s, x_ref[c], preferred_element_type=jnp.float32
                )

        return pl.pallas_call(
            k,
            out_shape=jax.ShapeDtypeStruct((C, H // 2, W), x.dtype),
            in_specs=[
                pl.BlockSpec(memory_space=pltpu.VMEM),
                pl.BlockSpec(memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            interpret=True,
        )(x, sel)

    def repeat_upsample(x):
        def k(x_ref, o_ref):
            x = x_ref[...]
            o_ref[...] = jnp.repeat(jnp.repeat(x, 2, axis=1), 2, axis=2)

        return pl.pallas_call(
            k,
            out_shape=jax.ShapeDtypeStruct((C, 2 * H, 2 * W), x.dtype),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            interpret=True,
        )(x)

    def upsample_matmul(x, sh, sw):
        def k(x_ref, sh_ref, sw_ref, o_ref):
            sh = sh_ref[...]
            sw = sw_ref[...]
            for c in range(C):
                o_ref[c] = jnp.dot(
                    sh,
                    jnp.dot(x_ref[c], sw, preferred_element_type=jnp.float32),
                    preferred_element_type=jnp.float32,
                )

        return pl.pallas_call(
            k,
            out_shape=jax.ShapeDtypeStruct((C, 2 * H, 2 * W), x.dtype),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            interpret=True,
        )(x, sh, sw)

    def grouped_conv3(x, w):
        def k(x_ref, w_ref, o_ref):
            x = x_ref[...].astype(jnp.float32)
            w = w_ref[...]
            outs = []
            for co in range(C):
                acc = None
                for t, (ky, kx) in enumerate(
                    (a, b) for a in range(3) for b in range(3)
                ):
                    tap = x[:, ky : ky + H, kx : kx + W]
                    term = jnp.sum(tap * w[co, t][:, :, None], axis=0)
                    acc = term if acc is None else acc + term
                outs.append(acc)
            o_ref[...] = jnp.stack(outs)

        return pl.pallas_call(
            k,
            out_shape=jax.ShapeDtypeStruct((C, H, W), x.dtype),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            interpret=True,
        )(x, w)

    def dyn_row_mask(x):
        def k(x_ref, o1_ref, o2_ref):
            i = pl.program_id(0)
            x = x_ref[...]
            rows = jax.lax.broadcasted_iota(jnp.int32, (1, H // 2, 1), 1)
            g = rows + i * (H // 2)
            o1_ref[...] = jnp.where(g < H - 5, x, 0.0)
            o2_ref[...] = jax.lax.slice(x, (0, 0, 0), (C, H // 2, W), (1, 1, 1))[
                :, : H // 4, : W // 2
            ]

        return pl.pallas_call(
            k,
            grid=(2,),
            out_shape=(
                jax.ShapeDtypeStruct((C, H, W), x.dtype),
                jax.ShapeDtypeStruct((C, H // 2, W // 2), x.dtype),
            ),
            in_specs=[
                pl.BlockSpec((C, H // 2, W), lambda i: (0, i, 0),
                             memory_space=pltpu.VMEM)
            ],
            out_specs=(
                pl.BlockSpec((C, H // 2, W), lambda i: (0, i, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((C, H // 4, W // 2), lambda i: (0, i, 0),
                             memory_space=pltpu.VMEM),
            ),
            interpret=True,
        )(x)

    def pad_value(x):
        def k(x_ref, o_ref):
            o_ref[...] = jnp.pad(x_ref[...], ((0, 0), (1, 1), (1, 1)))

        return pl.pallas_call(
            k,
            out_shape=jax.ShapeDtypeStruct((C, H + 2, W + 2), x.dtype),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            interpret=True,
        )(x)

    return {"sublane_stride2": sublane_stride2, "lane_stride2": lane_stride2,
            "lane_downsample_matmul": lane_downsample_matmul,
            "sublane_downsample_matmul": sublane_downsample_matmul,
            "repeat_upsample": repeat_upsample, "upsample_matmul": upsample_matmul,
            "grouped_conv3": grouped_conv3, "dyn_row_mask": dyn_row_mask,
            "pad_value": pad_value}


def numpy_inputs(name, C, H, W, seed):
    """The probe's inputs as numpy float32 arrays from ``seed``: x, and the
    selection matrices (as the probes build them) or the conv's weights."""
    rng = np.random.default_rng(seed)
    if name == "grouped_conv3":
        return (rng.standard_normal((C, H + 2, W + 2)).astype(np.float32),
                (rng.standard_normal((C, 9, C, 1)) * 0.2).astype(np.float32))
    x = rng.standard_normal((C, H, W)).astype(np.float32)
    sel = {
        "lane_downsample_matmul": [((W, W // 2), np.arange(0, W, 2), np.arange(W // 2))],
        "sublane_downsample_matmul": [((H // 2, H), np.arange(H // 2), np.arange(0, H, 2))],
        "upsample_matmul": [((2 * H, H), np.arange(2 * H), np.arange(2 * H) // 2),
                            ((W, 2 * W), np.arange(2 * W) // 2, np.arange(2 * W))],
    }.get(name, [])
    mats = []
    for shape, r, c in sel:
        s = np.zeros(shape, np.float32)
        s[r, c] = 1.0
        mats.append(s)
    return (x, *mats)


def _assert_outputs(name, got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        if name == "grouped_conv3":
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL)
        else:
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", plane_ops.KERNELS)
def test_plane_op_matches_pallas(name, size):
    arrays = numpy_inputs(name, *size, seed=plane_ops.KERNELS.index(name))
    kernels = PlaneOpsKernels()
    got = getattr(kernels, name)(*(torch.from_numpy(a) for a in arrays))
    assert kernels.launches[name] == 0
    _assert_outputs(name, got, mosaic_probes(*size)[name](*(jnp.asarray(a) for a in arrays)))


def test_grouped_conv3_probe_reference_differs_on_the_border():
    """The TPU probe's own reference (tools/probe_mosaic_ops.py:222-228)
    drops x's one-pixel ring and pads the interior back with zeros; its
    kernel convolves the ring's values.  They agree in the interior and
    differ on the output's border; the port computes the kernel's function."""
    C, H, W = 4, 16, 24
    xa, wa = numpy_inputs("grouped_conv3", C, H, W, seed=7)
    x, w = jnp.asarray(xa), jnp.asarray(wa)
    xn = x[:, 1:-1, 1:-1].transpose(1, 2, 0)[None]
    wn = w[..., 0].reshape(C, 3, 3, C).transpose(1, 2, 3, 0)
    probe_want = np.asarray(jax.lax.conv_general_dilated(
        xn, wn, (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST,
    )[0].transpose(2, 0, 1))
    kernel = np.asarray(mosaic_probes(C, H, W)["grouped_conv3"](x, w))
    port = PlaneOpsKernels().grouped_conv3(torch.from_numpy(xa), torch.from_numpy(wa)).numpy()
    np.testing.assert_allclose(port, kernel, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(kernel[:, 1:-1, 1:-1], probe_want[:, 1:-1, 1:-1], atol=1e-5)
    border = np.ones((H, W), bool)
    border[1:-1, 1:-1] = False
    assert np.abs(kernel - probe_want)[:, border].max() > 0.1
    # The port's probe tool holds the kernel to the valid conv instead.
    valid = probe_ops.expected("grouped_conv3", (torch.from_numpy(xa), torch.from_numpy(wa)))[0]
    np.testing.assert_allclose(port, valid.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("side", ["right", "left"])
def test_select_matmul_is_a_general_product(side):
    """With a random matrix the products equal numpy's float64 product
    within the conv tolerance; entries ~ N(0, 1/K) keep the outputs near 1."""
    rng = np.random.default_rng(11)
    C, H, W = 3, 20, 36
    x = rng.standard_normal((C, H, W)).astype(np.float32)
    kernels = PlaneOpsKernels()
    if side == "right":
        s = (rng.standard_normal((W, 13)) / np.sqrt(W)).astype(np.float32)
        got = kernels.lane_downsample_matmul(torch.from_numpy(x), torch.from_numpy(s))
        want = x.astype(np.float64) @ s.astype(np.float64)
    else:
        s = (rng.standard_normal((7, H)) / np.sqrt(H)).astype(np.float32)
        got = kernels.sublane_downsample_matmul(torch.from_numpy(x), torch.from_numpy(s))
        want = s.astype(np.float64) @ x.astype(np.float64)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    sh = (rng.standard_normal((9, H)) / np.sqrt(H)).astype(np.float32)
    sw = (rng.standard_normal((W, 11)) / np.sqrt(W)).astype(np.float32)
    got = kernels.upsample_matmul(*(torch.from_numpy(a) for a in (x, sh, sw)))
    want = sh.astype(np.float64) @ (x.astype(np.float64) @ sw.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert kernels.launches == dict.fromkeys(plane_ops.KERNELS, 0)


def test_odd_sizes_take_ceil_semantics():
    """H and W odd: the slices and the selection products give ceil(n/2)
    rows or columns, as ``::2`` does."""
    kernels = PlaneOpsKernels()
    size = (5, 37, 45)
    for name in plane_ops.KERNELS:
        if name == "dyn_row_mask":
            continue
        args = probe_ops.inputs(name, *size, "cpu")
        got = getattr(kernels, name)(*args)
        err, ok = probe_ops.agree(name, got, probe_ops.expected(name, args))
        assert ok, (name, err)
    assert kernels.sublane_stride2(args[0][:, :, :4].contiguous()).shape == (5, 19, 4)


def test_wrappers_take_plain_path_on_cpu_only_and_check_shapes():
    kernels = PlaneOpsKernels()
    args = {name: probe_ops.inputs(name, 3, 8, 10, "cpu") for name in plane_ops.KERNELS}
    for name, a in args.items():
        got = getattr(kernels, name)(*a)
        assert probe_ops.agree(name, got, plane_ops.REFERENCES[name](*a))[1], name
    assert kernels.launches == dict.fromkeys(plane_ops.KERNELS, 0)
    # Off the CPU there is no plain fallback: the wrapper launches or raises.
    for name, a in args.items():
        with pytest.raises(ValueError, match="CUDA"):
            getattr(kernels, name)(*(t.to("meta") for t in a))
    # Shapes the probes do not take, on any device.
    x = torch.zeros(3, 10, 10)
    with pytest.raises(ValueError, match="multiple of 4"):
        kernels.dyn_row_mask(x)
    with pytest.raises(ValueError, match="even"):
        kernels.dyn_row_mask(torch.zeros(3, 8, 9))
    with pytest.raises(ValueError, match="rows"):
        kernels.lane_downsample_matmul(x, torch.zeros(9, 5))
    with pytest.raises(ValueError, match="planes"):
        kernels.pad_value(torch.zeros(10, 10))
    with pytest.raises(ValueError, match="9, 3, 1"):
        kernels.grouped_conv3(x, torch.zeros(3, 9, 2, 1))
    assert kernels.launches == dict.fromkeys(plane_ops.KERNELS, 0)


def test_work_and_bound_at_the_fpn_plane_size():
    """Bytes and operations at C8, 512x640 float32: the products are bound
    by float32 operations (lane downsample 1.68 GFLOP, 25 us at 67 TFLOP/s;
    the upsample 6.7 + 10.7 GFLOP), the conv and the copies by bytes."""
    C, H, W = 8, 512, 640
    plane = C * H * W * 4
    got = {name: plane_ops.work(name, probe_ops.inputs(name, C, H, W, "meta"))
           for name in plane_ops.KERNELS}
    assert got["sublane_stride2"] == (plane, 0)  # half read, half written
    assert got["lane_stride2"] == (plane + plane // 2, 0)
    assert got["repeat_upsample"] == (5 * plane, 0)
    assert got["dyn_row_mask"] == (plane + plane + plane // 4, 0)
    assert got["pad_value"] == (plane + C * (H + 2) * (W + 2) * 4, 0)
    assert got["lane_downsample_matmul"] == (plane + 640 * 320 * 4 + plane // 2,
                                             2 * C * H * W * 320)
    assert got["sublane_downsample_matmul"][1] == 2 * C * 256 * H * W
    assert got["upsample_matmul"][1] == 2 * C * H * W * 1280 + 2 * C * 1024 * H * 1280
    assert got["grouped_conv3"][1] == 2 * 9 * C * C * H * W
    for name, (n_bytes, flops) in got.items():
        ms, by = bound_ms(n_bytes, flops, torch.float32)
        matmul = name.endswith("matmul")
        assert by == ("operations" if matmul else "bytes"), name
    assert round(bound_ms(*got["lane_downsample_matmul"], torch.float32)[0], 4) == 0.0250
    assert round(bound_ms(*got["upsample_matmul"], torch.float32)[0], 3) == 0.260
    assert 0.0028 < bound_ms(*got["sublane_stride2"], torch.float32)[0] < 0.0064


def test_probe_tool_on_cpu_exits_0():
    out = subprocess.run([sys.executable, "-m", "gdb_nerf_tpu_torch.tools.probe_ops",
                          "--device", "cpu"], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("[ok]") == 9 and "9/9 probes ok" in out.stdout


def test_probe_tool_fails_on_a_wrong_probe_and_without_gpu(monkeypatch, capsys):
    monkeypatch.setitem(plane_ops.REFERENCES, "pad_value", lambda x: F.pad(x, (1, 1, 1, 1), value=1.0))
    with pytest.raises(AssertionError, match="pad_value"):
        probe_ops.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "[FAIL] pad_value" in out and "8/9 probes ok" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        probe_ops.main([])
    assert exc.value.code not in (None, 0)


def _cu_constants() -> dict:
    return {k: int(v) for k, v in
            re.findall(r"\b(k\w+) = (\d+)", plane_ops.SOURCE.read_text())}


@pytest.mark.parametrize("M, K, N", [(64, 16, 64), (37, 45, 19), (130, 33, 70)])
def test_select_matmul_tile_replay(M, K, N):
    """The product's tiling, replayed in torch: blocks of kTileM x kTileN
    outputs, K in steps of kTileK with the tile's edge filled with zeros,
    each output a fused sum over k in order (float64 products rounded once,
    as fmaf rounds).  On ragged sizes every output is written once, and with
    a random matrix the replay equals the plain version within the tolerance;
    with a 0/1 matrix, bit for bit."""
    k = _cu_constants()
    tm, tn, tk, micro = k["kTileM"], k["kTileN"], k["kTileK"], k["kMicro"]
    assert (tm // micro) * (tn // micro) == k["kThreads"]
    g = torch.Generator().manual_seed(M)
    a = torch.randn(2, M, K, generator=g)
    for b, zero_one in ((torch.randn(K, N, generator=g) / K**0.5, False),
                        ((torch.rand(K, N, generator=g) < 0.05).float(), True)):
        out = torch.full((2, M, N), float("nan"))
        for m0 in range(0, M, tm):
            for n0 in range(0, N, tn):
                acc = torch.zeros(2, tm, tn)
                for k0 in range(0, K, tk):
                    sa = torch.zeros(2, tm, tk)
                    sb = torch.zeros(tk, tn)
                    sa[:, :min(tm, M - m0), :min(tk, K - k0)] = a[:, m0:m0 + tm, k0:k0 + tk]
                    sb[:min(tk, K - k0), :min(tn, N - n0)] = b[k0:k0 + tk, n0:n0 + tn]
                    for kk in range(tk):
                        prod = sa[:, :, kk, None].double() * sb[kk].double()
                        acc = (acc.double() + prod).float()  # one rounding: fmaf
                hh, ww = min(tm, M - m0), min(tn, N - n0)
                assert out[:, m0:m0 + hh, n0:n0 + ww].isnan().all()  # written once
                out[:, m0:m0 + hh, n0:n0 + ww] = acc[:, :hh, :ww]
        want = plane_ops.matmul_right(a, b)
        if zero_one:
            assert torch.equal(out, want)
        else:
            torch.testing.assert_close(out, want, atol=ATOL, rtol=RTOL)


def test_smoke_library_calls_equal_the_plain_versions():
    """chip_smoke.py times PyTorch's own call beside each K7 kernel and holds
    it to the plain version (a 0/1 product in TF32 would differ); on the CPU
    the two agree as they must on the card."""
    import chip_smoke

    for name in plane_ops.KERNELS:
        args = probe_ops.inputs(name, 3, 12, 18, "cpu")
        err, ok = probe_ops.agree(name, chip_smoke.probe_library_call(name, args)(),
                                  plane_ops.REFERENCES[name](*args))
        assert ok, (name, err)


def test_smoke_replaces_lines_name_the_probes():
    tool = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tools", "probe_mosaic_ops.py")
    lines = open(tool).read().splitlines()
    assert set(chip_smoke.PROBE_REPLACES) == set(plane_ops.KERNELS)
    for name, line in chip_smoke.PROBE_REPLACES.items():
        assert lines[line - 1].startswith(f"def probe_{name}("), (name, line)
