"""The fused BundleNeRF head: CUDA kernel wrapper and its plain version.

Replaces ``gdb_nerf_tpu/ops/pallas/fused_nerf.py::fused_bundle_nerf`` (the
Pallas kernel, body ``_kernel``), which runs the whole head per sample tile
with every intermediate kept in VMEM.

On Hopper the head is a chain of about twelve small dense layers (widths 4
to 88) with two softmaxes over the 2-4 source views: ~32.6 kFLOP per
sample against ~0.84 KB of float32 input and output.  The library
(``csrc/bundle_head.cu``) has one kernel per input type behind one entry
point; both restage the same float32 pack (``pack_weights``) in shared
memory once per resident block.  float32 is bound by FMA issue: a thread
per sample, float32 FMAs only, every weight row padded to a float4 so one
broadcast shared-memory load feeds four FMAs.  bf16 is bound by its bytes:
a warp per 16 samples runs every dense layer on the tensor cores
(``mma.sync`` m16n8k16, float32 accumulation), rounds to bf16 where the
plain version rounds, and keeps the view statistics and softmaxes in
float32; its weights are bf16 values (``cast_weights``), sigma's layer
float32.

``BundleHeadKernel`` is the wrapper: on CPU tensors it runs
``bundle_head_reference``; on CUDA tensors it builds the kernel (``nvcc``,
at first use, into ``build/kernels/``) and launches it, or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gdb_nerf_tpu_torch.kernels.build import CSRC, build_library
from gdb_nerf_tpu_torch.runtime import tracing

SOURCE = CSRC / "bundle_head.cu"
LAUNCHES = "bundle_head.launches"  # the tracing counter of the kernel's launches

# Widths the kernel is compiled for: the dtu_eval head (feature 16 + rgb 3,
# payload 3*2*2 + 19, voxel 8, hidden 64).  Must match csrc/bundle_head.cu.
FEAT_RGB_DIM, PAYLOAD_DIM, VOXEL_DIM, HIDDEN_DIM = 19, 31, 8, 64
MAX_VIEWS = 4


def bundle_head_reference(head, vox: torch.Tensor, payload: torch.Tensor,
                          frd: torch.Tensor):
    """The BundleNeRF head's math on tensors (the kernel's plain version).

    Args: head (models.nerf_head.BundleNeRF); vox (N, voxel); payload (V, N, P);
    frd (V, N, F + 4), all in the dtype of the head's weights (float32, or
    bf16 for a head cast by ``cast_weights``).  Density (its layer kept
    float32) and the payload softmax run in float32.  Returns sigma (N,)
    float32, feat (N, P + voxel) in the inputs' dtype.
    """
    dt = payload.dtype
    img_feat = head.aggregate(frd)
    vox_img = torch.cat([vox, img_feat], dim=-1)
    x = head.lr0(vox_img)
    sigma = head.sigma(x.float())[..., 0]
    # weight.0 over cat([x, vox_img] (shared), frd (per view)), split.
    n_shared = x.shape[-1] + vox_img.shape[-1]
    w0 = head.weight[0].weight
    shared = F.linear(torch.cat([x, vox_img], dim=-1), w0[:, :n_shared], head.weight[0].bias)
    h = torch.relu(shared + F.linear(frd, w0[:, n_shared:]))
    w = head.weight[3](head.weight[2](h))
    w = torch.softmax(w.float(), dim=0).to(dt)
    blended = (payload * w).sum(dim=0)
    return sigma, torch.cat([blended, head.feat_head(x)], dim=-1)


def work(n: int, views: int, dtype: torch.dtype) -> tuple[int, int]:
    """(bytes, operations) of one head call on ``n`` samples and ``views``
    views, from the compiled widths: inputs read once (the 11,930 float32
    weights, vox, payload, frd), outputs written once (sigma float32, feat);
    a multiply-add counts 2.  Per view: view_fc, the per-view column block of
    global_fc, agg_w, the per-view block of weight.0, weight.2 and the payload
    blend.  Once per sample: global_fc's var and mean blocks, fc, lr0, sigma,
    the shared block of weight.0 and feat_head."""
    es = torch.tensor([], dtype=dtype).element_size()
    F_, P, vox, hid, g, img = FEAT_RGB_DIM, PAYLOAD_DIM, VOXEL_DIM, HIDDEN_DIM, 32, 16
    per_view = 2 * (4 * F_ + F_ * g + g + (F_ + 4) * hid + hid + P)
    once = 2 * (2 * F_ * g + g * img + (vox + img) * hid + hid + (hid + vox + img) * hid
                + hid * vox)
    n_bytes = n * ((vox + views * (P + F_ + 4) + P + vox) * es + 4) + 11930 * 4
    return n_bytes, n * (once + views * per_view)


def pack_weights(head) -> torch.Tensor:
    """All head weights as one contiguous float32 vector, in the kernel's
    order; the concat-linears split into their column blocks."""
    F_ = head.feat_rgb_dim
    n_shared = head.hid_dim + head.voxel_dim + 16

    def w(lin):
        return lin.weight.detach().float()

    def b(lin):
        return lin.bias.detach().float()

    g = w(head.global_fc[0])
    w0 = w(head.weight[0])
    parts = [
        w(head.view_fc[0]), b(head.view_fc[0]),
        g[:, :F_], g[:, F_:2 * F_], g[:, 2 * F_:], b(head.global_fc[0]),
        w(head.agg_w_fc[0]), b(head.agg_w_fc[0]),
        w(head.fc[0]), b(head.fc[0]),
        w(head.lr0[0]), b(head.lr0[0]),
        w(head.sigma[0]), b(head.sigma[0]),
        w0[:, :n_shared], b(head.weight[0]),
        w0[:, n_shared:],
        w(head.weight[2]), b(head.weight[2]),
        w(head.feat_head[0]), b(head.feat_head[0]),
    ]
    return torch.cat([p.reshape(-1) for p in parts]).contiguous()


class BundleHeadKernel:
    """Wrapper of the CUDA bundle-head kernel.  Each launch adds one to the
    counter ``LAUNCHES`` of ``runtime/tracing.py`` while tracing is on."""

    def __init__(self):
        self.build_log = ""
        self._lib = None

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the kernel library."""
        if self._lib is None:
            path, self.build_log = build_library(SOURCE)
            lib = ctypes.CDLL(str(path))
            lib.bundle_head_forward.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
                ctypes.c_void_p
            ]
            lib.bundle_head_forward.restype = ctypes.c_int
            lib.bundle_head_num_weights.argtypes = []
            lib.bundle_head_num_weights.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def __call__(self, head, vox: torch.Tensor, payload: torch.Tensor, frd: torch.Tensor):
        if vox.device.type == "cpu" and payload.device.type == "cpu" and frd.device.type == "cpu":
            return bundle_head_reference(head, vox, payload, frd)
        return self.launch(head.packed_weights(), vox, payload, frd)

    def launch(self, weights: torch.Tensor, vox: torch.Tensor, payload: torch.Tensor,
               frd: torch.Tensor):
        """Run the kernel on CUDA tensors; returns sigma (N,) f32, feat (N, P + voxel)."""
        V, N, P = payload.shape
        dt = payload.dtype
        for name, t in (("weights", weights), ("vox", vox), ("payload", payload), ("frd", frd)):
            if t.device.type != "cuda" or t.device != payload.device:
                raise ValueError(f"bundle_head: {name} must be on {payload.device} (CUDA), got {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"bundle_head: {name} must be contiguous")
        if dt not in (torch.float32, torch.bfloat16) or vox.dtype != dt or frd.dtype != dt:
            raise ValueError(f"bundle_head: vox/payload/frd must share float32 or bfloat16, got "
                             f"{vox.dtype}/{payload.dtype}/{frd.dtype}")
        if weights.dtype != torch.float32 or weights.dim() != 1:
            raise ValueError("bundle_head: weights must be a 1-D float32 pack (pack_weights)")
        if (P != PAYLOAD_DIM or tuple(vox.shape) != (N, VOXEL_DIM)
                or tuple(frd.shape) != (V, N, FEAT_RGB_DIM + 4)):
            raise ValueError(f"bundle_head: shapes vox {tuple(vox.shape)}, payload {tuple(payload.shape)}, "
                             f"frd {tuple(frd.shape)} are not the compiled widths "
                             f"(voxel {VOXEL_DIM}, payload {PAYLOAD_DIM}, frd {FEAT_RGB_DIM + 4})")
        if not 2 <= V <= MAX_VIEWS:
            raise ValueError(f"bundle_head: the kernel takes 2..{MAX_VIEWS} views, got {V}")
        if N >= 2**31:
            raise ValueError(f"bundle_head: N={N} samples exceed the kernel's int32 count")
        lib = self.load()
        if weights.numel() != lib.bundle_head_num_weights():
            raise ValueError(f"bundle_head: weight pack has {weights.numel()} floats, the kernel "
                             f"expects {lib.bundle_head_num_weights()}")
        sigma = torch.empty(N, device=payload.device, dtype=torch.float32)
        feat = torch.empty(N, P + VOXEL_DIM, device=payload.device, dtype=dt)
        if N == 0:
            return sigma, feat
        with torch.cuda.device(payload.device):
            err = lib.bundle_head_forward(
                weights.data_ptr(), vox.data_ptr(), payload.data_ptr(), frd.data_ptr(),
                sigma.data_ptr(), feat.data_ptr(), N, V, FEAT_RGB_DIM, P, VOXEL_DIM,
                HIDDEN_DIM, int(dt == torch.bfloat16),
                torch.cuda.current_stream(payload.device).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"bundle_head kernel launch failed: cudaError {err}")
        tracing.count(LAUNCHES)
        return sigma, feat
