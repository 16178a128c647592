"""Plane-layout convolutions: CUDA kernel wrappers and their plain versions.

Replace the Pallas kernels of ``tools/microbench_pallas_conv.py``:

* ``conv1``     <- ``pallas_conv1``: ``relu(conv3x3(x) + b)``;
* ``convchain`` <- ``pallas_convchain``: n chained ``relu(conv3x3 + b)``,
  c -> c, intermediates kept on chip and rounded to ``x.dtype``;
* ``fpnprim``   <- ``pallas_fpnprim``: a 5x5 stride-2 conv + b (no ReLU),
  and the nearest 2x upsample of its float32 value with rows >= H - 3 zeroed.

The public functions keep the JAX layout and signatures: pre-padded planes
``(c, H + pad, W + pad)`` in float32 or bf16, weights ``(c_out, c_in, k, k)``,
bias ``(c_out,)``; outputs are in ``x.dtype``.  Each plain version writes
out the Pallas body's arithmetic (``_conv_body``, ``_conv_grouped``): a sum
of shifted planes times scalar weights, accumulated in float32.  At the
FPN's widths (c = 8) the convs are bound by device memory; the kernels
(``csrc/plane_conv.cu``) load each tile with its halo into shared memory
once and keep sums in registers, and the chain keeps its intermediates in
shared memory (see the source's note): in bf16 on the tensor cores
(``mma.sync``, the float32 weights split into two bf16 parts), in float32
on register tiles of FMAs.  The kernel picks the chain's tile; a shape
for which not even the smallest tile fits a block's shared memory
(``convchain_fits``; and bf16 with c > 16) is refused with ``ValueError``.

``PlaneConvKernels`` holds the three wrappers and their launch counts: on
CPU tensors a wrapper runs the plain version; on CUDA tensors it builds the
library (``nvcc``, at first use, into ``build/kernels/``) and launches the
kernel, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from gdb_nerf_tpu_torch.kernels.build import CSRC, build_library

SOURCE = CSRC / "plane_conv.cu"
KERNELS = ("conv1", "convchain", "fpnprim")
_DTYPES = (torch.float32, torch.bfloat16)

# convchain's smallest tile (rows, cols), the last row of both tile tables
# of csrc/plane_conv.cu.  The kernel picks each launch's row (pick_tile);
# the wrapper only refuses what no row fits, i.e. what this one does not.
# Constants of the source (kMaxSmem, kSteps, kF32Px, kMaxGroups), which
# tests/test_torch_port_plane_conv.py holds equal to these.
CHAIN_MIN_TILE = (16, 32)
MAX_SMEM = 232_448
_STEPS, _F32_PX, _BF16_MAX_GROUPS = 5, 5, 2


def _groups(c: int) -> int:
    return -(-c // 8)


def convchain_smem(c: int, n: int, dtype: torch.dtype, tile=CHAIN_MIN_TILE) -> int:
    """Bytes of shared memory a convchain block takes at ``tile``: bf16, two
    channel-last frames (16 bytes a pixel and group of 8 channels) and two
    layers' B fragments (hi and lo parts) and bias; float32, two layers'
    weights and bias and two planar frames at an odd row pitch, each with a
    thread's window of slack."""
    G, R, C = _groups(c), tile[0] + 2 * n, tile[1] + 2 * n
    if dtype == torch.bfloat16:
        return 2 * G * R * C * 16 + 2 * (2 * G * G * _STEPS * 32 * 8 + G * 8 * 4)
    return (2 * G * 8 * (9 * c + 1) + 2 * (c * R * (C | 1) + _F32_PX)) * 4


def convchain_fits(c: int, n: int, dtype: torch.dtype) -> bool:
    """Whether the chain kernel takes c channels and n layers in ``dtype``:
    its smallest tile fits a block's shared memory, and bf16 has c <= 16."""
    if dtype == torch.bfloat16 and _groups(c) > _BF16_MAX_GROUPS:
        return False
    return convchain_smem(c, n, dtype) <= MAX_SMEM


def _conv3x3_planes(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 conv of float32 padded planes xp (c_in, H+2, W+2) with w
    (c_out, c_in, 3, 3): the sum over (ci, ky, kx), in that order, of the
    shifted plane times its weight (one per output channel)."""
    H, W = xp.shape[1] - 2, xp.shape[2] - 2
    acc = None
    for ci in range(xp.shape[0]):
        for ky in range(3):
            for kx in range(3):
                term = xp[ci, ky:ky + H, kx:kx + W] * w[:, ci, ky, kx, None, None]
                acc = term if acc is None else acc + term
    return acc


def conv1_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``relu(conv3x3(x) + b)``: x (c_in, H+2, W+2), w (c_out, c_in, 3, 3),
    b (c_out,); returns (c_out, H, W) in x.dtype."""
    y = _conv3x3_planes(x.float(), w.float())
    return torch.relu(y + b.float()[:, None, None]).to(x.dtype)


def convchain_reference(x: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    """n chained ``relu(conv3x3 + b)``: x (c, H+2, W+2), ws (n, c, c, 3, 3),
    bs (n, c); returns (c, H, W) in x.dtype.  Each intermediate is rounded
    to x.dtype and zero-padded by one pixel, as the Pallas kernel's scratch
    (x.dtype, zero ring) holds it."""
    cur = x.float()
    n = ws.shape[0]
    for k in range(n):
        y = torch.relu(_conv3x3_planes(cur, ws[k].float()) + bs[k].float()[:, None, None])
        if k == n - 1:
            return y.to(x.dtype)
        cur = torch.nn.functional.pad(y.to(x.dtype).float(), (1, 1, 1, 1))
    raise ValueError("convchain: ws holds no conv")


def fpnprim_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """x (c, H+4, W+4), w (c, c, 5, 5), b (c,), H and W even.  Returns
    o1 (c, H/2, W/2) = conv5x5 stride 2 + b (no ReLU) and o2 (c, H, W) = the
    nearest 2x upsample of o1's float32 value with rows >= H - 3 set to 0,
    both in x.dtype.  Per tap the input channels are summed first, then the
    taps in order, as the Pallas kernel's grouped formulation sums."""
    H, W = x.shape[1] - 4, x.shape[2] - 4
    xf, wf = x.float(), w.float()
    acc = None
    for ky in range(5):
        for kx in range(5):
            tap = xf[:, ky:ky + H:2, kx:kx + W:2]  # (c_in, H/2, W/2)
            term = (tap[None] * wf[:, :, ky, kx, None, None]).sum(dim=1)
            acc = term if acc is None else acc + term
    y = acc + b.float()[:, None, None]
    up = y.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    rows = torch.arange(H, device=x.device)[None, :, None]
    up = torch.where(rows < H - 3, up, torch.zeros((), device=x.device))
    return y.to(x.dtype), up.to(x.dtype)


def _check_planes(name: str, x: torch.Tensor, *params: torch.Tensor) -> None:
    """Device, dtype, contiguity and size checks of a launch."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must be a CUDA tensor, got {x.device}")
    for p in params:
        if p.device != x.device:
            raise ValueError(f"{name}: weights and bias must be on {x.device} (CUDA), got {p.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous planes (c, H+pad, W+pad), got "
                         f"shape {tuple(x.shape)}")
    if x.numel() >= 2**31:
        raise ValueError(f"{name}: {x.numel()} elements exceed the kernel's int32 sizes")


def _pack(t: torch.Tensor) -> torch.Tensor:
    """Weights or bias as the kernel reads them: contiguous float32, in the
    JAX layout (co, ci, ky, kx)."""
    return t.detach().to(torch.float32).contiguous()


def work(name: str, args) -> tuple[int, int]:
    """(bytes, operations) of one call of kernel ``name`` on ``args``: each
    input read once (weights and bias as the kernel reads them, float32),
    each output written once; a multiply-add counts 2, bias and ReLU 1 each."""
    x, w, b = args
    es = x.element_size()
    if name == "fpnprim":
        c, H, W = x.shape[0], x.shape[1] - 4, x.shape[2] - 4
        out = c * H // 2 * W // 2 + c * H * W
        flops = (2 * 25 * c + 1) * c * (H // 2) * (W // 2)
    else:
        H, W = x.shape[1] - 2, x.shape[2] - 2
        layers = w.shape[0] if name == "convchain" else 1
        c_out, c_in = w.shape[-4], w.shape[-3]
        out = c_out * H * W
        flops = layers * (2 * 9 * c_in + 2) * c_out * H * W
    return (x.numel() + out) * es + (w.numel() + b.numel()) * 4, flops


def _conv1_launch(x, w, b):
    """conv1's output shapes and size arguments; raises on what it cannot take."""
    c_out, c_in = w.shape[:2]
    if tuple(w.shape) != (c_out, x.shape[0], 3, 3) or tuple(b.shape) != (c_out,):
        raise ValueError(f"conv1: w {tuple(w.shape)} and b {tuple(b.shape)} do not fit "
                         f"x {tuple(x.shape)} (want (c_out, {x.shape[0]}, 3, 3) and (c_out,))")
    H, W = x.shape[1] - 2, x.shape[2] - 2
    if H < 1 or W < 1:
        raise ValueError(f"conv1: x {tuple(x.shape)} holds no pixel inside its padding")
    return [(c_out, H, W)], (c_in, c_out, H, W)


def _convchain_launch(x, ws, bs):
    """convchain's output shapes and size arguments; raises on what it cannot take."""
    n, c = ws.shape[:2]
    if n < 1 or tuple(ws.shape) != (n, c, c, 3, 3) or x.shape[0] != c or tuple(bs.shape) != (n, c):
        raise ValueError(f"convchain: ws {tuple(ws.shape)} and bs {tuple(bs.shape)} do not fit "
                         f"x {tuple(x.shape)} (want (n, c, c, 3, 3) and (n, c), n >= 1)")
    H, W = x.shape[1] - 2, x.shape[2] - 2
    if H < 1 or W < 1:
        raise ValueError(f"convchain: x {tuple(x.shape)} holds no pixel inside its padding")
    if not convchain_fits(c, n, x.dtype):
        raise ValueError(f"convchain: c={c}, n={n} in {x.dtype} does not fit a block's shared "
                         f"memory even at a {CHAIN_MIN_TILE} tile (bf16 takes c <= 16)")
    return [(c, H, W)], (c, H, W, n)


def _fpnprim_launch(x, w, b):
    """fpnprim's output shapes and size arguments; raises on what it cannot take."""
    c = w.shape[0]
    if tuple(w.shape) != (c, c, 5, 5) or x.shape[0] != c or tuple(b.shape) != (c,):
        raise ValueError(f"fpnprim: w {tuple(w.shape)} and b {tuple(b.shape)} do not fit "
                         f"x {tuple(x.shape)} (want (c, c, 5, 5) and (c,))")
    H, W = x.shape[1] - 4, x.shape[2] - 4
    if H < 2 or W < 2 or H % 2 or W % 2:
        raise ValueError(f"fpnprim: H={H}, W={W} inside the padding must be even and >= 2")
    return [(c, H // 2, W // 2), (c, H, W)], (c, H, W)


# name -> (plain version, shape checks giving the outputs and size arguments)
_SPECS = {
    "conv1": (conv1_reference, _conv1_launch),
    "convchain": (convchain_reference, _convchain_launch),
    "fpnprim": (fpnprim_reference, _fpnprim_launch),
}


class PlaneConvKernels:
    """Wrappers of the three CUDA plane-conv kernels, with launch counts."""

    def __init__(self):
        self.launches = dict.fromkeys(KERNELS, 0)
        self.build_log = ""
        self._lib = None

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the kernel library."""
        if self._lib is None:
            path, self.build_log = build_library(SOURCE)
            lib = ctypes.CDLL(str(path))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.plane_conv1.argtypes = [p] * 4 + [i] * 5 + [p]
            lib.plane_convchain.argtypes = [p] * 4 + [i] * 5 + [p]
            lib.plane_fpnprim.argtypes = [p] * 5 + [i] * 4 + [p]
            for fn in (lib.plane_conv1, lib.plane_convchain, lib.plane_fpnprim):
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def _call(self, name: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
        """The plain version when every tensor lies on the CPU; otherwise the
        kernel, launched as ``plane_<name>(x, w, b, outputs..., sizes...,
        is_bf16, stream)``, or an error."""
        plain, launch_shapes = _SPECS[name]
        if x.device.type == "cpu" and w.device.type == "cpu" and b.device.type == "cpu":
            return plain(x, w, b)
        _check_planes(name, x, w, b)
        out_shapes, sizes = launch_shapes(x, w, b)
        outs = [torch.empty(s, device=x.device, dtype=x.dtype) for s in out_shapes]
        wk, bk = _pack(w), _pack(b)
        fn = getattr(self.load(), f"plane_{name}")
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), wk.data_ptr(), bk.data_ptr(), *(o.data_ptr() for o in outs),
                     *sizes, int(x.dtype == torch.bfloat16),
                     torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
        self.launches[name] += 1
        return outs[0] if len(outs) == 1 else tuple(outs)

    def conv1(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``relu(conv3x3(x) + b)``; see ``conv1_reference``."""
        return self._call("conv1", x, w, b)

    def convchain(self, x: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
        """n chained ``relu(conv3x3 + b)``; see ``convchain_reference``."""
        return self._call("convchain", x, ws, bs)

    def fpnprim(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
        """(o1, o2); see ``fpnprim_reference``."""
        return self._call("fpnprim", x, w, b)
