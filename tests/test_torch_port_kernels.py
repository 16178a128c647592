"""The CUDA kernels on the card: agreement with their plain versions and the
wrappers' checks (the bundle head K1; the plane convs K2-K4; the gathers
K5-K6; the plane primitives K7).

These tests need a CUDA device (the kernel has no CPU mode) and skip
without one.  The GPU machine has no jax, and tests/conftest.py imports it,
so they run there with the conftest left out:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_kernels.py
"""

import os

import numpy as np
import pytest
import torch

from gdb_nerf_tpu_torch.kernels import gather, plane_ops
from gdb_nerf_tpu_torch.kernels.bundle_head import BundleHeadKernel, bundle_head_reference
from gdb_nerf_tpu_torch.kernels.gather import GatherKernels
from gdb_nerf_tpu_torch.kernels.plane_conv import PlaneConvKernels
from gdb_nerf_tpu_torch.kernels.plane_ops import PlaneOpsKernels
from gdb_nerf_tpu_torch.models.layers import cast_weights
from gdb_nerf_tpu_torch.models.nerf_head import BundleNeRF
from gdb_nerf_tpu_torch.runtime.renderer import set_float32_numerics
from gdb_nerf_tpu_torch.tools import microbench_conv, microbench_gather, probe_ops

pytestmark = pytest.mark.cuda
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "dtu_eval_golden.npz")


@pytest.fixture
def head():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bundle-head kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    h = BundleNeRF(64, 16, 8)
    with torch.no_grad():
        for p in h.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.3, p.shape).astype(np.float32)))
    return h.cuda().eval()


@pytest.fixture
def bf16_head():
    """The golden fixture's head cast as the bf16 network casts it (sigma's
    layer float32): the head of chip_smoke.py's phase 2, whose outputs are
    of order 1, where the bf16 tolerance is set."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bundle-head kernel has no CPU mode")
    g = np.load(GOLDEN)
    h = BundleNeRF(64, 16, 8).eval()
    h.load_state_dict({k[len("sd/nerf."):]: torch.from_numpy(np.array(g[k]))
                       for k in g.files if k.startswith("sd/nerf.")})
    cast_weights(h, torch.bfloat16, keep=(h.sigma[0],))
    return h.cuda()


def inputs(n, V, dtype=torch.float32):
    rng = np.random.default_rng(1)
    arrays = (rng.standard_normal((n, 8)), rng.uniform(0, 1, (V, n, 31)),
              rng.standard_normal((V, n, 23)))
    return tuple(torch.from_numpy(a.astype(np.float32)).cuda().to(dtype) for a in arrays)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [2, 3, 4])
@pytest.mark.parametrize("n", [1, 1000, 40_005])
@torch.no_grad()
def test_kernel_matches_plain_version(request, V, n, dtype):
    """n: one sample, a ragged tile, and more than one wave of 264 resident
    128-sample blocks, ragged."""
    head = request.getfixturevalue("head" if dtype == torch.float32 else "bf16_head")
    kernel = BundleHeadKernel()
    vox, payload, frd = inputs(n, V, dtype)
    sigma, feat = kernel(head, vox, payload, frd)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    assert sigma.dtype == torch.float32 and feat.dtype == dtype
    s_ref, f_ref = bundle_head_reference(head, vox, payload, frd)
    if dtype == torch.float32:
        # float32 on both sides; the sums run in another order: 1e-4.
        torch.testing.assert_close(sigma, s_ref, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(feat, f_ref, rtol=1e-4, atol=1e-4)
    else:
        # bf16 rounded at the same points, summed in another order: chip_smoke.BF16_ATOL.
        assert float((sigma - s_ref).abs().max()) <= 0.03
        assert float((feat.float() - f_ref.float()).abs().max()) <= 0.03


@torch.no_grad()
def test_wrapper_raises_on_what_the_kernel_does_not_take(head):
    kernel = BundleHeadKernel()
    w = head.packed_weights()
    vox, payload, frd = inputs(256, 3)
    bad = {
        "float16": (vox.half(), payload.half(), frd.half()),
        "mixed dtypes": (vox, payload.bfloat16(), frd),
        "non-contiguous": (vox, payload.transpose(0, 1).contiguous().transpose(0, 1), frd),
        "payload width": (vox, payload[..., :30].contiguous(), frd),
        "five views": (vox, payload.repeat(2, 1, 1)[:5].contiguous(),
                       frd.repeat(2, 1, 1)[:5].contiguous()),
        "one on the CPU": (vox.cpu(), payload, frd),
    }
    for what, args in bad.items():
        with pytest.raises(ValueError):
            kernel.launch(w, *args)
        assert kernel.launches == 0, what
    with pytest.raises(ValueError):
        kernel.launch(w[:-1], vox, payload, frd)
    assert kernel.launches == 0


@pytest.fixture
def plane_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the plane-conv kernels have no CPU mode")
    return PlaneConvKernels()


# Ragged planes: H and W not multiples of the kernels' tiles, channel
# counts not multiples of their groups of 8, c_in != c_out for conv1; and
# one plane smaller than a tile.  conv1 and fpnprim also take two groups of
# 8 (12 channels), float32 weights that are not bf16 values, and planes of
# several tiles each way (conv1 float32: 32 x 40 tiles; fpnprim: o1 tiles
# of 4 x 80 in bf16, 32 x 20 in float32) with an odd o1 width.
PLANE_CASES = [
    ("conv1", dict(c=5, c_out=12, H=37, W=45)),
    ("conv1", dict(c=8, H=3, W=5)),
    ("conv1", dict(c=12, c_out=5, H=70, W=83, float32_params=True)),
    ("convchain", dict(c=6, n=3, H=37, W=45)),
    ("convchain", dict(c=8, n=4, H=5, W=7)),
    ("convchain", dict(c=12, n=3, H=37, W=71)),
    ("convchain", dict(c=5, n=2, H=37, W=71, float32_params=True)),
    ("fpnprim", dict(c=8, H=38, W=70, scale=0.1)),
    ("fpnprim", dict(c=3, H=4, W=6, scale=0.1)),
    ("fpnprim", dict(c=12, H=38, W=70, scale=0.1)),
    ("fpnprim", dict(c=5, H=70, W=174, scale=0.1, float32_params=True)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name, shape", PLANE_CASES)
@torch.no_grad()
def test_plane_conv_kernel_matches_plain_version(plane_kernels, name, shape, dtype):
    x, w, b = microbench_conv.inputs(name, dtype=dtype, device="cuda", **shape)
    # The wrapper casts weights and bias to float32; float32 ones that are
    # not bf16 values take the bf16 chain's lo MMAs.
    args = (x, w, b) if shape.get("float32_params") else (x, w.to(dtype), b.to(dtype))
    got = getattr(plane_kernels, name)(*args)
    torch.cuda.synchronize()
    assert plane_kernels.launches[name] == 1
    want = microbench_conv.REFERENCES[name](*args)
    # float32 on both sides, the kernel with fused multiply-adds: 1e-5 / 1e-4;
    # bf16: a flipped rounding, within 4 ulps at the largest magnitude.
    err, ok = microbench_conv.agree(got, want, atol=1e-5, rtol=1e-4)
    assert ok, err
    if shape.get("float32_params"):
        # The kernel keeps the float32 weights: nearer the plain version on
        # them than on the weights rounded to bf16.
        full, rounded, kept = microbench_conv.weight_rounding_errors(name, got, args)
        assert kept, (full, rounded)


@torch.no_grad()
def test_plane_conv_wrappers_raise_on_what_the_kernels_do_not_take(plane_kernels):
    x, w, b = microbench_conv.inputs("conv1", 4, 8, 8, torch.float32, "cuda")
    bad = {
        "float16": (x.half(), w, b),
        "non-contiguous": (x.transpose(1, 2), w, b),
        "channels": (x[:3].contiguous(), w, b),
        "bias width": (x, w, b[:3]),
        "weights on the CPU": (x, w.cpu(), b),
    }
    for what, args in bad.items():
        with pytest.raises(ValueError):
            plane_kernels.conv1(*args)
        assert plane_kernels.launches["conv1"] == 0, what
    x, w, b = microbench_conv.inputs("fpnprim", 4, 8, 8, torch.float32, "cuda")
    with pytest.raises(ValueError, match="even"):
        plane_kernels.fpnprim(x[:, :-1].contiguous(), w, b)
    x, ws, bs = microbench_conv.inputs("convchain", 4, 8, 8, torch.float32, "cuda", n=2)
    with pytest.raises(ValueError):
        plane_kernels.convchain(x, ws[:, :, :3].contiguous(), bs)
    # The shape lines (tests/test_torch_port_plane_conv.py holds them to the
    # source): bf16 at most 16 channels a side, float32 a block's shared
    # memory; fpnprim's x on a column pair's boundary.
    for dt, c_in, c_out in ((torch.bfloat16, 17, 8), (torch.float32, 20, 20)):
        x, w, b = microbench_conv.inputs("conv1", c_in, 8, 8, dt, "cuda", c_out=c_out)
        with pytest.raises(ValueError, match="shared memory"):
            plane_kernels.conv1(x, w, b)
    for dt, c in ((torch.bfloat16, 17), (torch.float32, 14)):
        with pytest.raises(ValueError, match="shared memory"):
            plane_kernels.fpnprim(*microbench_conv.inputs("fpnprim", c, 8, 8, dt, "cuda"))
    for dt in (torch.bfloat16, torch.float32):
        x, w, b = microbench_conv.inputs("fpnprim", 3, 8, 8, dt, "cuda")
        shifted = torch.empty(x.numel() + 1, dtype=dt, device="cuda")[1:].view(x.shape)
        shifted.copy_(x)
        with pytest.raises(ValueError, match="boundary"):
            plane_kernels.fpnprim(shifted, w, b)
    assert plane_kernels.launches == {"conv1": 0, "convchain": 0, "fpnprim": 0}


@pytest.mark.parametrize("dtype, c, n, refused", [
    (torch.float32, 24, 4, (25, 4)), (torch.float32, 16, 8, (16, 9)),
    (torch.bfloat16, 16, 17, (16, 18)), (torch.bfloat16, 8, 30, (17, 1))])
@torch.no_grad()
def test_convchain_at_the_shared_memory_line(plane_kernels, dtype, c, n, refused):
    """The largest shapes the wrapper lets through (plane_conv.convchain_fits)
    launch and agree with the plain version; the next ones are refused
    before the launch."""
    x, ws, bs = microbench_conv.inputs("convchain", c, 21, 35, dtype, "cuda", n=n, scale=0.1)
    err, ok = microbench_conv.agree(plane_kernels.convchain(x, ws, bs),
                                    microbench_conv.REFERENCES["convchain"](x, ws, bs), 1e-5, 1e-4)
    assert ok, err
    x, ws, bs = microbench_conv.inputs("convchain", refused[0], 21, 35, dtype, "cuda", n=refused[1])
    with pytest.raises(ValueError, match="shared memory"):
        plane_kernels.convchain(x, ws, bs)
    assert plane_kernels.launches["convchain"] == 1


@pytest.fixture
def gather_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the gather kernels have no CPU mode")
    return GatherKernels()


# Ragged gathers: rows not a power of two, N not a multiple of any tile
# (256 threads, 256-row loop tiles, 64-row ring tiles) or of the ring's 8
# slots, N = 1, rows = 1; C giving 16-byte rows and narrower ones (13 bf16 =
# 26 B; 6 float32 = 24 B) for the kernels that take them (dma_ring needs rows
# of a multiple of 16 bytes: 24 bf16 = 48 B, 12 float32 = 48 B).
GATHER_CASES = [(1000, 16, 100_003), (777, 128, 4097), (3, 16, 1), (1, 24, 77)]
GATHER_NARROW = [(1000, 13, 5001), (91, 6, 300)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", gather.KERNELS)
@torch.no_grad()
def test_gather_kernel_matches_plain_version(gather_kernels, name, dtype):
    cases = GATHER_CASES + (GATHER_NARROW if name != "dma_ring" else [])
    for k, (rows, C, N) in enumerate(cases):
        table, idx = microbench_gather.inputs(rows, C, N, dtype, "cuda", idx_2d=k % 2 == 0)
        if k == 0:  # out of range on both sides: clamped
            idx.view(-1)[:5] = torch.tensor([-7, rows, rows + 1000, -1, 2**31 - 1],
                                            dtype=torch.int32)
        got = getattr(gather_kernels, name)(table, idx)
        torch.cuda.synchronize()
        assert gather_kernels.launches[name] == k + 1
        assert torch.equal(got, gather.REFERENCES[name](table, idx)), (rows, C, N)


@torch.no_grad()
def test_gather_wrappers_raise_on_what_the_kernels_do_not_take(gather_kernels):
    table, idx = microbench_gather.inputs(64, 16, 100, torch.bfloat16, "cuda")
    bad = {
        "int64 indices": (table, idx.long()),
        "table on the CPU": (table.cpu(), idx),
        "indices on the CPU": (table, idx.cpu()),
        "non-contiguous table": (table.t().contiguous().t(), idx),
        "3-D index": (table, idx.reshape(10, 10, 1)),
        "float16 table": (table.half(), idx),
    }
    for name in gather.KERNELS:
        for what, args in bad.items():
            with pytest.raises(ValueError):
                getattr(gather_kernels, name)(*args)
            assert gather_kernels.launches[name] == 0, (name, what)
    # A bulk copy needs rows of a multiple of 16 bytes: 6 bf16 are 12 B.
    narrow, idx = microbench_gather.inputs(64, 6, 100, torch.bfloat16, "cuda")
    with pytest.raises(ValueError, match="16-byte"):
        gather_kernels.dma_ring(narrow, idx)
    assert gather_kernels.launches == dict.fromkeys(gather.KERNELS, 0)
    # ... and a table 2 bytes past a 16-byte boundary.
    shifted = torch.empty(64 * 16 + 1, dtype=torch.bfloat16, device="cuda")[1:].view(64, 16)
    shifted.copy_(table)
    with pytest.raises(ValueError, match="16-byte"):
        gather_kernels.dma_ring(shifted, idx)
    assert gather_kernels.launches == dict.fromkeys(gather.KERNELS, 0)
    # The other kernels take both, in narrower pieces.
    for name in ("take", "take_along", "row_loop"):
        for t in (narrow, shifted):
            assert torch.equal(getattr(gather_kernels, name)(t, idx), gather.take_reference(t, idx))
        assert gather_kernels.launches[name] == 2


@pytest.fixture
def probe_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the plane-primitive kernels have no CPU mode")
    set_float32_numerics(tf32=False)
    return PlaneOpsKernels()


# The probe's size, then ragged planes: C5, H and W odd and not multiples of
# any tile (product tiles of 64 and 128, 8x32 conv tiles), and one plane
# smaller than a tile; the row mask takes H % 4 == 0 and W even.
PROBE_CASES = [(8, 64, 256), (5, 37, 45), (3, 5, 7)]
ROW_MASK_CASES = [(8, 64, 256), (5, 36, 46), (3, 4, 2)]


@pytest.mark.parametrize("name", plane_ops.KERNELS)
@torch.no_grad()
def test_plane_op_kernel_matches_plain_version(probe_kernels, name):
    cases = (ROW_MASK_CASES if name == "dyn_row_mask" else PROBE_CASES) + \
        probe_ops.PATH_SIZES.get(name, [])
    for k, size in enumerate(cases):
        args = probe_ops.inputs(name, *size, "cuda", seed=k)
        got = getattr(probe_kernels, name)(*args)
        torch.cuda.synchronize()
        assert probe_kernels.launches[name] == k + 1
        # Copies and 0/1 products: equal; the conv within 1e-5 / 1e-4.
        err, ok = probe_ops.agree(name, got, plane_ops.REFERENCES[name](*args))
        assert ok, (size, err)
        err, ok = probe_ops.agree(name, got, probe_ops.expected(name, args))
        assert ok, (size, err)


@pytest.mark.parametrize("size", [(8, 64, 256), (5, 37, 45)])
@torch.no_grad()
def test_select_matmul_with_a_random_matrix(probe_kernels, size):
    """A general product, the matrix on the right and on the left: entries
    ~ N(0, 1/K) keep the outputs near 1; float32 in another order than the
    plain version (FMAs): atol 1e-5, rtol 1e-4."""
    C, H, W = size
    g = torch.Generator().manual_seed(H)
    x = torch.randn(C, H, W, generator=g).cuda()
    right = (torch.randn(W, 29, generator=g) / W**0.5).cuda()
    left = (torch.randn(23, H, generator=g) / H**0.5).cuda()
    for name, args in (("lane_downsample_matmul", (x, right)),
                       ("sublane_downsample_matmul", (x, left)),
                       ("upsample_matmul", (x, left, right))):
        got = getattr(probe_kernels, name)(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, plane_ops.REFERENCES[name](*args), atol=1e-5, rtol=1e-4)
    assert probe_kernels.launches["upsample_matmul"] == 1


@pytest.mark.parametrize("case", probe_ops.TILE_CASES, ids=lambda c: "-".join(map(str, c)))
@torch.no_grad()
def test_select_matmul_at_each_tile_row(probe_kernels, case):
    """A random matrix on the right and on the left at sizes where the
    wrapper picks each tile row (probe_ops.TILE_CASES), within 1e-5 / 1e-4
    of the plain version; then the same product from planes 4 bytes past a
    16-byte boundary, which the kernel loads in 4-byte pieces."""
    name, C, H, W, width = case
    args = probe_ops.random_product_inputs(name, C, H, W, width, "cuda", seed=W)
    want = plane_ops.REFERENCES[name](*args)
    got = getattr(probe_kernels, name)(*args)
    torch.cuda.synchronize()
    err, ok = probe_ops.close(got, want)
    assert ok, err
    x = args[0]
    shifted = torch.empty(x.numel() + 1, device="cuda")[1:].view(x.shape)
    shifted.copy_(x)
    err, ok = probe_ops.close(getattr(probe_kernels, name)(shifted, args[1]), want)
    assert ok, err
    assert probe_kernels.launches[name] == 2


@pytest.mark.parametrize("W", probe_ops.SLICE_WIDTHS)
@torch.no_grad()
def test_strided_slice_at_each_path(probe_kernels, W):
    """Widths that take each path of the strided slice (W % 8 == 0, W % 4
    == 0 only, W odd), and a plane 4 bytes past a 16-byte boundary (the
    scalar path): equal to the plain versions bit for bit."""
    x = torch.randn(probe_ops.SLICE_C, probe_ops.SLICE_H, W, device="cuda")
    shifted = torch.empty(x.numel() + 1, device="cuda")[1:].view(x.shape)
    shifted.copy_(x)
    for name in ("sublane_stride2", "lane_stride2"):
        for t in (x, shifted):
            assert torch.equal(getattr(probe_kernels, name)(t), plane_ops.REFERENCES[name](t)), name
        assert probe_kernels.launches[name] == 2


@torch.no_grad()
def test_plane_op_wrappers_raise_on_what_the_kernels_do_not_take(probe_kernels):
    x = torch.randn(3, 8, 10, device="cuda")
    s = torch.randn(10, 5, device="cuda")
    bad = {
        "float64": ("pad_value", (x.double(),)),
        "bf16": ("repeat_upsample", (x.bfloat16(),)),
        "non-contiguous": ("lane_stride2", (x.transpose(1, 2),)),
        "rank 2": ("sublane_stride2", (x[0],)),
        "rank 4": ("pad_value", (x[None],)),
        "matrix on the CPU": ("lane_downsample_matmul", (x, s.cpu())),
        "matrix rows": ("lane_downsample_matmul", (x, s[:9].contiguous())),
        "non-contiguous matrix": ("lane_downsample_matmul", (x, s.t().contiguous().t())),
        "matrix bf16": ("sublane_downsample_matmul", (x, torch.randn(4, 8, device="cuda").bfloat16())),
        "conv weights": ("grouped_conv3", (x, torch.randn(3, 9, 2, 1, device="cuda"))),
        "conv channels": ("grouped_conv3", (torch.randn(53, 5, 6, device="cuda"),
                                            torch.randn(53, 9, 53, 1, device="cuda"))),
        "row mask H": ("dyn_row_mask", (torch.randn(3, 10, 10, device="cuda"),)),
        "row mask W": ("dyn_row_mask", (torch.randn(3, 8, 9, device="cuda"),)),
    }
    for what, (name, args) in bad.items():
        with pytest.raises(ValueError):
            getattr(probe_kernels, name)(*args)
        assert probe_kernels.launches == dict.fromkeys(plane_ops.KERNELS, 0), what
