"""The CUDA kernels on the card: agreement with their plain versions and the
wrappers' checks (the bundle head K1; the plane convs K2-K4).

These tests need a CUDA device (the kernel has no CPU mode) and skip
without one.  The GPU machine has no jax, and tests/conftest.py imports it,
so they run there with the conftest left out:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_kernels.py
"""

import numpy as np
import pytest
import torch

from gdb_nerf_tpu_torch.kernels.bundle_head import BundleHeadKernel, bundle_head_reference
from gdb_nerf_tpu_torch.kernels.plane_conv import PlaneConvKernels
from gdb_nerf_tpu_torch.models.nerf_head import BundleNeRF
from gdb_nerf_tpu_torch.tools import microbench_conv

pytestmark = pytest.mark.cuda


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


def inputs(n, V, dtype=torch.float32):
    rng = np.random.default_rng(1)
    arrays = (rng.standard_normal((n, 8)), rng.uniform(0, 1, (V, n, 31)),
              rng.standard_normal((V, n, 23)))
    return tuple(torch.from_numpy(a.astype(np.float32)).cuda().to(dtype) for a in arrays)


@pytest.mark.parametrize("V", [2, 3, 4])
@pytest.mark.parametrize("n", [1, 1000])
@torch.no_grad()
def test_kernel_matches_plain_version(head, V, n):
    kernel = BundleHeadKernel()
    vox, payload, frd = inputs(n, V)
    sigma, feat = kernel(head, vox, payload, frd)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    s_ref, f_ref = bundle_head_reference(head, vox, payload, frd)
    # float32 on both sides; the sums run in another order: 1e-4.
    torch.testing.assert_close(sigma, s_ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(feat, f_ref, rtol=1e-4, atol=1e-4)


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
# one plane smaller than a tile.
PLANE_CASES = [
    ("conv1", dict(c=5, c_out=12, H=37, W=45)),
    ("conv1", dict(c=8, H=3, W=5)),
    ("convchain", dict(c=6, n=3, H=37, W=45)),
    ("convchain", dict(c=8, n=4, H=5, W=7)),
    ("fpnprim", dict(c=8, H=38, W=70, scale=0.1)),
    ("fpnprim", dict(c=3, H=4, W=6, scale=0.1)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name, shape", PLANE_CASES)
@torch.no_grad()
def test_plane_conv_kernel_matches_plain_version(plane_kernels, name, shape, dtype):
    x, w, b = microbench_conv.inputs(name, dtype=dtype, device="cuda", **shape)
    args = (x, w.to(dtype), b.to(dtype))  # the wrapper casts weights and bias to float32
    got = getattr(plane_kernels, name)(*args)
    torch.cuda.synchronize()
    assert plane_kernels.launches[name] == 1
    want = microbench_conv.REFERENCES[name](*args)
    # float32 on both sides, the kernel with fused multiply-adds: 1e-5 / 1e-4;
    # bf16: a flipped rounding, within 4 ulps at the largest magnitude.
    err, ok = microbench_conv.agree(got, want, atol=1e-5, rtol=1e-4)
    assert ok, err


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
    assert plane_kernels.launches == {"conv1": 0, "convchain": 0, "fpnprim": 0}
