"""The CUDA bundle-head kernel on the card: agreement and the wrapper's checks.

These tests need a CUDA device (the kernel has no CPU mode) and skip
without one.  The GPU machine has no jax, and tests/conftest.py imports it,
so they run there with the conftest left out:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_kernels.py
"""

import numpy as np
import pytest
import torch

from gdb_nerf_tpu_torch.kernels.bundle_head import BundleHeadKernel, bundle_head_reference
from gdb_nerf_tpu_torch.models.nerf_head import BundleNeRF

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
