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
replays the product's tiling of each tile row,
``test_strided_slice_path_replay`` the slice's paths and loops,
``test_grouped_conv3_replay`` the conv's tiling, window and weight offsets
and store paths, and ``test_row_mask_path_replay`` the row mask's paths,
in torch from the constants of ``csrc/plane_ops.cu``;
``test_wrapper_tile_choice`` holds the wrapper's choice of tile row and
``test_grouped_conv3_shape_line`` the conv's channel line.
"""

import os
import re
import shutil
import subprocess
import sys
from types import SimpleNamespace

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


def test_tile_table_is_the_kernels():
    k = _cu_constants()
    assert k["kMatmulTiles"] == len(plane_ops.MATMUL_TILES)
    assert plane_ops.MATMUL_TILES == tuple((k[f"kTile{i}M"], k[f"kTile{i}N"])
                                           for i in range(k["kMatmulTiles"]))


# Each product launch of the probes at the FPN's plane size (C8, 512x640):
# its blocks per tile row (64x128, 32x128), and the row the wrapper picks on
# 132 SMs.
TILE_TABLE = {
    "lane_downsample_matmul": [([192, 384], "32x128")],
    "sublane_downsample_matmul": [([160, 320], "32x128")],
    "upsample_matmul": [([640, 1280], "64x128"), ([1280, 2560], "64x128")],
}


@pytest.mark.parametrize("size, want", [
    ((8, 512, 640), {n: [t for _, t in rows] for n, rows in TILE_TABLE.items()}),
    ((8, 64, 256), {"lane_downsample_matmul": ["32x128"], "sublane_downsample_matmul": ["64x128"],
                    "upsample_matmul": ["32x128", "32x128"]}),
    ((5, 509, 637), {"lane_downsample_matmul": ["64x128"], "sublane_downsample_matmul": ["64x128"],
                     "upsample_matmul": ["64x128", "64x128"]}),
], ids=["fpn", "probe", "ragged"])
def test_wrapper_tile_choice(size, want):
    """The tile row the wrapper passes for each product launch: the largest
    whose blocks fill 132 SMs within 20 % of the most even row.  At C8
    512x640 the downsamples' 192 or 160 blocks of 64x128 leave a quarter to
    a third of the card idle in their last wave (fill 0.73, 0.61), so they
    take 32x128 (fill 0.97, 0.81); the upsample's products stay on 64x128
    (fill 0.81, 0.97), as the probe size's 16 blocks of either row take
    64x128.  A right product counts its batch folded into M."""
    for name in plane_ops.PRODUCTS:
        args = probe_ops.inputs(name, *size, "meta")
        got = [plane_ops.tile_name(i) for i in plane_ops.product_tiles(name, args, sms=132)]
        assert got == want[name], name
        if size == (8, 512, 640):
            counts = [plane_ops.tile_counts(b, M, N, ab, bb)
                      for b, M, _, N, ab, bb in plane_ops.product_launches(name, args)]
            assert counts == [c for c, _ in TILE_TABLE[name]], name
    assert float(plane_ops.tile_fill(2560, 132)) == pytest.approx(2560 / 2640)
    # Another card changes the choice: on 96 SMs the 192 blocks of 64x128
    # fill two waves exactly.
    assert plane_ops.select_tile(8, 512, 320, True, False, sms=96) == 0


def test_tile_cases_take_each_row():
    """probe_ops.TILE_CASES, which the card tests and the smoke run, make
    the wrapper pick each tile row on 132 SMs for the right product and for
    the left one, and take both the 16-byte path (K and N multiples of 4)
    and the 4-byte one on either side."""
    rows = {}
    for name, C, H, W, width in probe_ops.TILE_CASES:
        args = probe_ops.random_product_inputs(name, C, H, W, width, "meta")
        (tile,) = plane_ops.product_tiles(name, args, sms=132)
        (_, _, K, N, _, _), = plane_ops.product_launches(name, args)
        rows.setdefault(name, set()).add(tile)
        rows.setdefault((name, "16-byte"), set()).add(K % 4 == 0 and N % 4 == 0)
    assert rows == {"lane_downsample_matmul": {0, 1}, "sublane_downsample_matmul": {0, 1},
                    ("lane_downsample_matmul", "16-byte"): {True, False},
                    ("sublane_downsample_matmul", "16-byte"): {True, False}}


@pytest.mark.parametrize("size", [(8, 512, 640), (8, 64, 256), (5, 509, 637)],
                         ids=["fpn", "probe", "ragged"])
@pytest.mark.parametrize("name", plane_ops.PRODUCTS)
def test_wrapper_launches_are_product_launches(monkeypatch, name, size):
    """The product wrapper, with its launches caught before the library on
    meta tensors of a 132-SM card, launches what product_launches lists, in
    that order, each in the tile row product_tiles reports."""
    launched = []
    monkeypatch.setattr(plane_ops, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(plane_ops.PlaneOpsKernels, "_launch",
                        lambda self, name, entry, *args: launched.append((entry, args)))
    kernels = plane_ops.PlaneOpsKernels()
    args = probe_ops.inputs(name, *size, "meta")
    getattr(kernels, name)(*args)
    assert [e for e, _ in launched] == ["plane_select_matmul"] * len(launched)
    assert [(b, M, K, N, bool(ab), bool(bb)) for _, (_, _, _, b, M, K, N, ab, bb, _) in launched] \
        == plane_ops.product_launches(name, args)
    assert [t for _, (*_, t) in launched] == plane_ops.product_tiles(name, args, sms=132)
    assert kernels.launches[name] == 1


def _replay_select_matmul(a, b, tile):
    """out = a @ b as select_matmul_kernel computes it with tile row
    ``tile``: a right product (a batched, b shared) folds the batch into M;
    each block takes K in stages of kTile<i>K with the edges zero-filled, and
    each output is a chain of fmaf over k in order (float64 products, exact
    for float32 inputs, rounded once to float32 a step).  Checks that the
    block's threads own each output once and that a stage's pieces of A and
    B are each loaded once; returns out with NaN where nothing was written,
    and asserts nothing is written twice."""
    k = _cu_constants()
    bm, bn, tk = k[f"kTile{tile}M"], k[f"kTile{tile}N"], k[f"kTile{tile}K"]
    tm, tn = k[f"kTile{tile}TM"], k[f"kTile{tile}TN"]
    threads = (bm // tm) * (bn // tn)
    assert k["kMatmulThreadsPerSM"] // threads * threads == k["kMatmulThreadsPerSM"]
    # The thread layout: warps of 4 x 8 threads; rows p pm + ty*4 + i,
    # columns q pn + tx*4 + j, in 4x4 patches pm = bm / (tm / 4) apart.
    owned = torch.zeros(bm, bn, dtype=torch.int32)
    a_pieces = torch.zeros(bm, tk // 4, dtype=torch.int32)
    warps_n, pm, pn = bn // tn // 8, bm // (tm // 4), bn // (tn // 4)
    for t in range(threads):
        warp, lane = divmod(t, 32)
        ty, tx = (warp // warps_n) * 4 + lane // 8, (warp % warps_n) * 8 + lane % 8
        rows = [(i // 4) * pm + ty * 4 + i % 4 for i in range(tm)]
        cols = [(j // 4) * pn + tx * 4 + j % 4 for j in range(tn)]
        owned[torch.tensor(rows)[:, None], torch.tensor(cols)] += 1
        for q in range(bm * tk // 4 // threads):
            e = t + q * threads
            a_pieces[e % 16 + 16 * ((e // 32) % (bm // 16)),
                     (e % 32) // 16 + 2 * ((e // 32) // (bm // 16))] += 1
    assert bool((owned == 1).all()) and bool((a_pieces == 1).all())
    assert (tk * bn // 4) % threads == 0  # B's 16-byte pieces split evenly

    right = a.dim() == 3 and b.dim() == 2
    if right:
        C, M, K = a.shape
        A, B = a.reshape(1, C * M, K), b[None]
    else:
        A, B = (a[None] if a.dim() == 2 else a), b
    batch = max(A.shape[0], B.shape[0])
    M, K, N = A.shape[1], A.shape[2], B.shape[2]
    out = torch.full((batch, M, N), float("nan"))
    for z in range(batch):
        Az, Bz = A[z % A.shape[0]], B[z % B.shape[0]]
        for m0 in range(0, M, bm):
            for n0 in range(0, N, bn):
                acc = torch.zeros(bm, bn)
                for k0 in range(0, K, tk):
                    sa = torch.zeros(bm, tk)
                    sb = torch.zeros(tk, bn)
                    sa[:min(bm, M - m0), :min(tk, K - k0)] = Az[m0:m0 + bm, k0:k0 + tk]
                    sb[:min(tk, K - k0), :min(bn, N - n0)] = Bz[k0:k0 + tk, n0:n0 + bn]
                    for kk in range(tk):
                        acc = (acc.double() + sa[:, kk, None].double() * sb[kk].double()).float()
                hh, ww = min(bm, M - m0), min(bn, N - n0)
                assert out[z, m0:m0 + hh, n0:n0 + ww].isnan().all()  # written once
                out[z, m0:m0 + hh, n0:n0 + ww] = acc[:hh, :ww]
    return out.reshape(a.shape[0], -1, N) if right else out


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("tile", range(len(plane_ops.MATMUL_TILES)),
                         ids=[plane_ops.tile_name(i) for i in range(len(plane_ops.MATMUL_TILES))])
def test_select_matmul_tile_replay(tile, side):
    """The product's tiling of each table row, replayed in torch from the
    constants of csrc/plane_ops.cu on ragged sizes (M, N and K not multiples
    of any tile or stage; the right product's planes straddle row tiles once
    folded): every output is written once, a 0/1 matrix gives the plain
    version's bits, a random one is within the tolerance."""
    g = torch.Generator().manual_seed(tile)
    C, H, W = 2, 69, 37
    x = torch.randn(C, H, W, generator=g)
    width = 130 if side == "right" else 67
    for zero_one in (False, True):
        if side == "right":
            s = ((torch.rand(W, width, generator=g) < 0.05).float() if zero_one
                 else torch.randn(W, width, generator=g) / W**0.5)
            got, want = _replay_select_matmul(x, s, tile), plane_ops.matmul_right(x, s)
        else:
            s = ((torch.rand(width, H, generator=g) < 0.05).float() if zero_one
                 else torch.randn(width, H, generator=g) / H**0.5)
            got, want = _replay_select_matmul(s, x, tile), plane_ops.matmul_left(s, x)
        if zero_one:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def _replay_strided_slice(x, sh, sw):
    """out = x[:, ::sh, ::sw] as plane_strided_slice computes it from a
    16-byte aligned x: its path (a contiguous row copy if sw == 1 and W % 4
    == 0, pairs of 16-byte loads if sw == 2 and W % 8 == 0, else 4-byte
    elements), its block shape and grid, and the row and piece loops of
    strided_slice_kernel, from the constants of csrc/plane_ops.cu.  Returns
    (path, out, writes per output, whether every 16-byte access was aligned)."""
    k = _cu_constants()
    C, H, W = x.shape
    Ho, Wo = -(-H // sh), -(-W // sw)
    rows = C * Ho
    if sw == 1 and W % 4 == 0:
        path = k["kSliceRows"]
    elif sw == 2 and W % 8 == 0:
        path = k["kSlicePairs"]
    else:
        path = k["kSliceScalar"]
    units = Wo if path == k["kSliceScalar"] else Wo // 4
    bx = min(k["kThreads"], -(-units // 32) * 32)
    by = k["kThreads"] // bx
    gx, gy = -(-units // (bx * k["kSliceUnits"])), min(-(-rows // by), 65535)
    row = np.concatenate([np.arange(y, rows, gy * by) for y in range(gy * by)])
    u = np.concatenate([np.arange(t, units, gx * bx) for t in range(gx * bx)])
    row, u = np.repeat(row, len(u)), np.tile(u, len(row))
    c = row // Ho
    base_in = (c * H + (row - c * Ho) * sh) * W
    base_out = row * Wo
    if path == k["kSliceRows"]:
        src = base_in[:, None] + 4 * u[:, None] + np.arange(4)
        dst = base_out[:, None] + 4 * u[:, None] + np.arange(4)
        aligned = bool((src[:, 0] % 4 == 0).all() and (dst[:, 0] % 4 == 0).all())
    elif path == k["kSlicePairs"]:
        src = base_in[:, None] + 8 * u[:, None] + 2 * np.arange(4)
        dst = base_out[:, None] + 4 * u[:, None] + np.arange(4)
        aligned = bool((src[:, 0] % 4 == 0).all() and (dst[:, 0] % 4 == 0).all())
    else:
        src, dst, aligned = base_in + u * sw, base_out + u, True
    flat = x.reshape(-1).numpy()
    out = np.full(rows * Wo, np.nan, np.float32)
    writes = np.zeros(rows * Wo, np.int64)
    np.add.at(writes, dst.reshape(-1), 1)
    out[dst.reshape(-1)] = flat[src.reshape(-1)]
    return path, torch.from_numpy(out.reshape(C, Ho, Wo)), writes, aligned


@pytest.mark.parametrize("W", [637, 644, 648, 640])
def test_strided_slice_path_replay(W):
    """Which path each stride takes at W: 637 (odd) the scalar one for both;
    644 (W % 4 == 0, not % 8) the row copy for sh = 2 but the scalar path
    for sw = 2, whose output rows of 322 floats start 16-byte aligned only
    on even rows; 648 and 640 the vector paths for both.  Every output is
    written once and equals x[:, ::sh, ::sw]; every 16-byte access of a
    vector path is aligned."""
    k = _cu_constants()
    C, H = 2, 7
    x = torch.arange(C * H * W, dtype=torch.float32).reshape(C, H, W)
    want_path = {
        (2, 1): k["kSliceRows"] if W % 4 == 0 else k["kSliceScalar"],
        (1, 2): k["kSlicePairs"] if W % 8 == 0 else k["kSliceScalar"],
    }
    for (sh, sw), want in want_path.items():
        path, out, writes, aligned = _replay_strided_slice(x, sh, sw)
        assert path == want, (sh, sw)
        assert (writes == 1).all() and aligned, (sh, sw)
        assert torch.equal(out, x[:, ::sh, ::sw])
    if W == 644:  # why sw = 2 needs W % 8 == 0: odd output rows start at 322 * r
        assert 322 % 4 != 0


def _replay_grouped_conv3(x, w):
    """out = the valid 3x3 conv of x with w as grouped_conv3_kernel computes
    it, from the constants of csrc/plane_ops.cu: one block a kConv3TH x
    kConv3TW tile; the weights staged [group][ci][tap][kGroup] (zero past
    c); the frame of the tile's rows and columns and halo at kConv3Pitch,
    zero outside x (by column pairs where Wp is even: a pair is inside x
    or outside it whole); thread i on tile row 4 (i / 32) + i % 32 / 8 and
    columns kConv3Px (i % 8) ..; per (ci, ky) a window of float2 loads that
    stays in the frame and hits 32 banks a half-warp; fmaf in (ci, ky, kx)
    order (float64 products, one rounding a step); stores as 16-byte
    pieces (W % 4 == 0, each inside the row whole and 16-byte aligned) or 4
    bytes.  Returns (out, writes per output, the store widths used)."""
    k = _cu_constants()
    th, tw, px, pitch, grp = (k[n] for n in ("kConv3TH", "kConv3TW", "kConv3Px", "kConv3Pitch",
                                             "kGroup"))
    threads, fr = 32 * th // 4, th + 2
    C, Hp, Wp = x.shape
    H, W = Hp - 2, Wp - 2
    G = -(-C // grp)
    i = torch.arange(G * C * 9 * grp)
    j, rest = i % grp, i // grp
    tap, gci = rest % 9, rest // 9
    co = gci // C * grp + j
    sw = torch.where(co < C, w[co.clamp(max=C - 1), tap, gci % C, 0], 0.0).view(G, C, 9, grp)
    t = torch.arange(threads)
    lane = t % 32
    row, j0 = t // 32 * 4 + lane // 8, lane % 8 * px
    assert int(j0.max()) + px + 2 <= pitch and pitch % 4 == 2 and threads % 32 == 0
    for ky in range(3):  # float2 window loads: aligned, 32 banks a half-warp
        start = (row + ky) * pitch + j0
        assert bool((start % 2 == 0).all())
        for e in range((px + 2) // 2):
            for half in (start // 2 + e).view(-1, 16):
                assert len(set((2 * half % 32).tolist())) == 16
    pairs = Wp % 2 == 0
    vec = W % 4 == 0
    xp = F.pad(x, (0, tw + pitch, 0, th + 2))  # zero outside x
    out = torch.full((C, H, W), float("nan"))
    writes = torch.zeros(C, H, W, dtype=torch.int64)
    widths = set()
    for oy in range(0, H, th):
        for ox in range(0, W, tw):
            if pairs:  # a pair starting inside x ends inside it
                q = ox + 2 * torch.arange(pitch // 2)
                assert bool(((q < Wp) == (q + 1 < Wp)).all())
            frame = xp[:, oy:oy + fr, ox:ox + pitch]
            y, x0 = oy + row, ox + j0
            for g in range(G):
                acc = torch.zeros(threads, px, grp, dtype=torch.float64)
                for ci in range(C):
                    for ky in range(3):
                        win = frame[ci, row + ky][torch.arange(threads)[:, None],
                                                  j0[:, None] + torch.arange(px + 2)]
                        for kx in range(3):
                            wt = sw[g, ci, 3 * ky + kx].double()
                            prod = win[:, kx:kx + px, None].double() * wt
                            acc = (acc + prod).float().double()
                co = g * grp + torch.arange(grp)
                rows = (y < H)[:, None] & (co < C)  # (thread, channel) pieces stored
                if vec:
                    rows &= (x0 < W)[:, None]
                    assert bool((x0[(x0 < W)] + px <= W).all())
                    start = (co[None] * H + y[:, None]) * W + x0[:, None]
                    assert bool((start[rows] % 4 == 0).all())
                widths |= {16 if vec else 4}
                for p in range(px):
                    keep = rows & (x0 + p < W)[:, None]
                    n, jj = keep.nonzero(as_tuple=True)
                    out[co[jj], y[n], x0[n] + p] = acc[n, p, jj].float()
                    writes[co[jj], y[n], x0[n] + p] += 1
    return out, writes, widths


@pytest.mark.parametrize("C, H, W", [(12, 21, 70), (5, 20, 64), (3, 17, 37)],
                         ids=["two-groups-pairs-4byte", "pairs-16byte", "4byte-frame"])
def test_grouped_conv3_replay(C, H, W):
    """The grouped conv's tiling replayed in torch from csrc/plane_ops.cu's
    constants (``_replay_grouped_conv3``) on ragged planes: 12 channels (two
    groups of 8, the second cut) with column pairs and 4-byte stores (W % 4
    == 2), 16-byte stores (W % 4 == 0), and a 4-byte frame (W odd); every
    output written once, within 1e-5 / 1e-4 of the plain version."""
    g = torch.Generator().manual_seed(C)
    x = torch.randn(C, H + 2, W + 2, generator=g)
    w = torch.randn(C, 9, C, 1, generator=g) * 0.2
    out, writes, widths = _replay_grouped_conv3(x, w)
    assert bool((writes == 1).all())
    assert widths == ({16} if W % 4 == 0 else {4})
    torch.testing.assert_close(out, plane_ops.grouped_conv3_reference(x, w), atol=ATOL, rtol=RTOL)


def test_grouped_conv3_shape_line(monkeypatch):
    """The wrapper's tile, pitch and shared-memory limit are the source's,
    and its line between the channel counts the conv launches and those it
    refuses with ``ValueError`` before the launch: the tile's frame and the
    weights fit a block's shared memory up to c = 52 (the earlier kernel,
    8x32 tiles without a pitch, took up to 63)."""
    k = _cu_constants()
    assert plane_ops.CONV3_TILE == (k["kConv3TH"], k["kConv3TW"])
    assert plane_ops.CONV3_PITCH == k["kConv3Pitch"] and plane_ops.MAX_SMEM == k["kMaxSmem"]
    assert max(c for c in range(1, 80) if plane_ops.grouped_conv3_fits(c)) == 52
    launched = []
    monkeypatch.setattr(plane_ops, "_check", lambda *a: None)
    monkeypatch.setattr(plane_ops.PlaneOpsKernels, "_launch",
                        lambda self, name, entry, *args: launched.append(entry))
    kernels = plane_ops.PlaneOpsKernels()
    for c in (52, 53):
        args = (torch.empty(c, 7, 9, device="meta"), torch.empty(c, 9, c, 1, device="meta"))
        if c == 53:
            with pytest.raises(ValueError, match="shared memory"):
                kernels.grouped_conv3(*args)
        else:
            kernels.grouped_conv3(*args)
    assert launched == ["plane_grouped_conv3"] and kernels.launches["grouped_conv3"] == 1


def _replay_row_mask(x, limit):
    """(o1, o2) as plane_row_mask computes them from a 16-byte aligned x: its
    path (16-byte pieces if W % 4 == 0, else 4-byte elements), the grid of
    row_launch and the row loop of row_mask_kernel, from the constants of
    csrc/plane_ops.cu; o2 from the same vectors where W/2 % 4 == 0, else as
    8-byte halves.  Returns (path, o1, o2, writes of o1 and of o2, whether
    every vector access was aligned, the rows read)."""
    k = _cu_constants()
    C, H, W = x.shape
    half, quarter, Wo = H // 2, H // 4, W // 2
    path = k["kMaskRows"] if W % 4 == 0 else k["kMaskScalar"]
    v = 4 if path == k["kMaskRows"] else 1
    units, rows = W // v, C * H
    bx = min(k["kThreads"], -(-units // 32) * 32)
    by = k["kThreads"] // bx
    gx, gy = -(-units // (bx * k["kSliceUnits"])), min(-(-rows // by), 65535)
    flat = x.reshape(-1)
    o1, o2 = torch.full((C * H * W,), float("nan")), torch.full((C * half * Wo,), float("nan"))
    w1, w2 = torch.zeros(o1.shape, dtype=torch.int64), torch.zeros(o2.shape, dtype=torch.int64)
    aligned, read = True, set()
    us = np.concatenate([np.arange(t, units, gx * bx) for t in range(gx * bx)])
    for row in np.concatenate([np.arange(r, rows, gy * by) for r in range(gy * by)]):
        c, r = divmod(int(row), H)
        blk = 0 if r < half else 1
        rr = r - blk * half
        keep, take = r < limit, rr < quarter
        d2 = ((2 * c + blk) * quarter + rr) * Wo
        if keep or take:
            read.add((c, r))
        for u in us:
            col = int(u) * v
            vals = flat[row * W + col:row * W + col + v] if keep or take else torch.zeros(v)
            o1[row * W + col:row * W + col + v] = vals if keep else 0.0
            w1[row * W + col:row * W + col + v] += 1
            aligned &= (row * W + col) % v == 0
            if take and col < Wo:
                if v == 1 or Wo % 4 == 0:
                    pieces = [(d2 + col, v)]
                else:  # 8-byte halves, the second only inside o2's row
                    pieces = [(d2 + col, 2)] + ([(d2 + col + 2, 2)] if col + 2 < Wo else [])
                for at, n in pieces:
                    o2[at:at + n] = vals[at - d2 - col:at - d2 - col + n]
                    w2[at:at + n] += 1
                    aligned &= at % n == 0
    return path, o1.view(C, H, W), o2.view(C, half, Wo), w1, w2, aligned, read


@pytest.mark.parametrize("W", [24, 20, 18])
def test_row_mask_path_replay(W):
    """The row mask's paths replayed from csrc/plane_ops.cu's constants at H
    = 12 (limit 7: masked rows 7 and 8 sit in o2's second block): W = 24
    the 16-byte path with o2 from the same vectors (W/2 % 4 == 0), 20 the
    16-byte path with o2 in 8-byte halves (W/2 = 10), 18 the 4-byte path
    (W % 4 == 2).  Both outputs equal the plain version's, every element is
    written once, every vector access is aligned, and of the masked rows
    only those that o2 takes are read."""
    k = _cu_constants()
    C, H = 2, 12
    x = torch.arange(C * H * W, dtype=torch.float32).reshape(C, H, W) + 1
    path, o1, o2, w1, w2, aligned, read = _replay_row_mask(x, H - plane_ops.ROW_MASK_OFFSET)
    assert path == (k["kMaskRows"] if W % 4 == 0 else k["kMaskScalar"])
    want1, want2 = plane_ops.dyn_row_mask_reference(x)
    assert torch.equal(o1, want1) and torch.equal(o2, want2)
    assert bool((w1 == 1).all()) and bool((w2 == 1).all()) and aligned
    assert read == {(c, r) for c in range(C) for r in (*range(7), 7, 8)}


def test_ab_tool_needs_a_gpu_and_takes_the_smokes_library_calls(monkeypatch):
    """The A/B tool stops without a GPU; on the card it runs the probes that
    the redesigned kernels serve (the slice, the product, the grouped conv
    and the row mask), in turns that give each version two places, one
    early and one late."""
    from gdb_nerf_tpu_torch.tools import ab_plane_ops

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        ab_plane_ops.main([str(plane_ops.SOURCE.parents[2])])
    assert exc.value.code not in (None, 0)
    assert set(ab_plane_ops.NAMES) == set(plane_ops.PRODUCTS) | {
        "sublane_stride2", "lane_stride2", "grouped_conv3", "dyn_row_mask"}
    order = ab_plane_ops.ORDER
    assert order == order[::-1] and sorted(order) == sorted(2 * ("library", "other", "this"))


def test_cut_tool_edits_the_source_and_needs_a_gpu(monkeypatch):
    """Each cut of tools/cut_grouped_conv3.py finds its anchor in
    csrc/plane_ops.cu once and changes the text (a cut that no longer
    applies raises, not times the whole kernel twice); the tool stops
    without a GPU."""
    from gdb_nerf_tpu_torch.tools import cut_grouped_conv3

    text = plane_ops.SOURCE.read_text()
    assert set(cut_grouped_conv3.CUTS) == {"whole", "no_load", "no_fma", "no_store"}
    for cut, edits in cut_grouped_conv3.CUTS.items():
        assert (cut_grouped_conv3.cut_source(text, cut) == text) == (not edits), cut
    with pytest.raises(ValueError, match="occurs 0 times"):
        cut_grouped_conv3.cut_source(text.replace("load_conv3_frame(", "load("), "no_load")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        cut_grouped_conv3.main([])
    assert exc.value.code not in (None, 0)


def test_ab_tool_imports_the_other_trees_wrappers(tmp_path):
    """The A/B tool imports another tree's plane_ops beside this one: that
    tree's source and build directory, this tree's modules left in place,
    and on CPU tensors that tree's plain versions."""
    from gdb_nerf_tpu_torch.tools.ab_common import import_from_tree

    package = plane_ops.SOURCE.parents[1]
    shutil.copytree(package, tmp_path / package.name,
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    before = dict(sys.modules)
    other = import_from_tree(tmp_path, "kernels.plane_ops")
    assert other is not plane_ops and sys.modules == before
    assert other.SOURCE == tmp_path / package.name / "csrc" / "plane_ops.cu"
    assert other.build_library.__globals__["BUILD_DIR"] == tmp_path / "build" / "kernels"
    args = probe_ops.inputs("upsample_matmul", 3, 12, 18, "cpu")
    assert torch.equal(other.PlaneOpsKernels().upsample_matmul(*args),
                       plane_ops.upsample_matmul_reference(*args))


def test_smoke_library_calls_equal_the_plain_versions():
    """chip_smoke.py times PyTorch's own call (probe_ops.library_call)
    beside each K7 kernel and holds it to the plain version (a 0/1 product
    in TF32 would differ); on the CPU the two agree as they must on the
    card."""
    for name in plane_ops.KERNELS:
        args = probe_ops.inputs(name, 3, 12, 18, "cpu")
        err, ok = probe_ops.agree(name, probe_ops.library_call(name, args)(),
                                  plane_ops.REFERENCES[name](*args))
        assert ok, (name, err)


def test_smoke_replaces_lines_name_the_probes():
    tool = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tools", "probe_mosaic_ops.py")
    lines = open(tool).read().splitlines()
    assert set(chip_smoke.PROBE_REPLACES) == set(plane_ops.KERNELS)
    for name, line in chip_smoke.PROBE_REPLACES.items():
        assert lines[line - 1].startswith(f"def probe_{name}("), (name, line)
