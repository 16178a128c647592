"""Plane primitives: CUDA kernel wrappers and their plain versions.

Replace the nine Pallas kernels of ``tools/probe_mosaic_ops.py``, one
Mosaic primitive each, on float32 planes ``x (C, H, W)``:

* ``sublane_stride2``           <- ``probe_sublane_stride2``: ``x[:, ::2, :]``;
* ``lane_stride2``              <- ``probe_lane_stride2``: ``x[:, :, ::2]``;
* ``lane_downsample_matmul``    <- ``probe_lane_downsample_matmul``: per
  channel ``x[c] @ s``, s (W, N);
* ``sublane_downsample_matmul`` <- ``probe_sublane_downsample_matmul``: per
  channel ``s @ x[c]``, s (M, H);
* ``repeat_upsample``           <- ``probe_repeat_upsample``: nearest 2x
  along H and W;
* ``upsample_matmul``           <- ``probe_upsample_matmul``: per channel
  ``sh @ (x[c] @ sw)``, sh (M, H), sw (W, N);
* ``grouped_conv3``             <- ``probe_grouped_conv3``: the valid 3x3
  conv of x (C, H+2, W+2) with w (C, 9, C, 1), ``out[co, h, w] = sum_t
  sum_ci x[ci, h + ky, w + kx] w[co, t, ci, 0]`` with t = 3 ky + kx;
* ``dyn_row_mask``              <- ``probe_dyn_row_mask``: o1 = x with rows
  >= H - 5 zeroed; o2 (C, H/2, W/2), whose row block i (of H/4 rows) is x's
  rows [i H/2, i H/2 + H/4), columns [0, W/2): the probe's grid of 2 row
  blocks.  H % 4 == 0 and W % 2 == 0;
* ``pad_value``                 <- ``probe_pad_value``: a zero ring of one pixel.

Odd sizes take ``::2`` semantics (ceil), which is the probe's on even sizes.
The products are general: the selection matrices the probes build are only
their inputs.  Each product's plain version sums over k in order, a
multiply and an add per term, and the kernel does the same with fused
multiply-adds, so a 0/1 matrix gives the same bits on both sides.  The
probe's own reference of ``grouped_conv3`` convolves the interior of x
re-padded with zeros, which is another function on the border; the port
holds the kernel to what the Pallas body computes.

``PlaneOpsKernels`` holds one wrapper per probe and one launch count per
probe (``upsample_matmul``'s two products count as one): on CPU tensors a
wrapper runs the plain version; on CUDA tensors it builds the library
(``csrc/plane_ops.cu``, ``nvcc`` at first use, into ``build/kernels/``) and
launches the kernel, or raises.  float32 only, as every probe is.

The product kernel takes one of two block tiles (``MATMUL_TILES``, the
table of ``csrc/plane_ops.cu``); ``select_tile`` picks the row per launch
from how evenly its blocks fill the card's SMs, here in Python where the
CPU tests reach it, and the wrapper passes its index to the entry point.
"""

from __future__ import annotations

import ctypes
from fractions import Fraction

import torch
import torch.nn.functional as F

from gdb_nerf_tpu_torch.kernels.build import CSRC, build_library

SOURCE = CSRC / "plane_ops.cu"
KERNELS = ("sublane_stride2", "lane_stride2", "lane_downsample_matmul",
           "sublane_downsample_matmul", "repeat_upsample", "upsample_matmul",
           "grouped_conv3", "dyn_row_mask", "pad_value")
# The CUDA entry point that each probe launches.
ENTRY_POINTS = {
    "sublane_stride2": "plane_strided_slice", "lane_stride2": "plane_strided_slice",
    "lane_downsample_matmul": "plane_select_matmul",
    "sublane_downsample_matmul": "plane_select_matmul",
    "repeat_upsample": "plane_repeat_upsample", "upsample_matmul": "plane_select_matmul",
    "grouped_conv3": "plane_grouped_conv3", "dyn_row_mask": "plane_row_mask",
    "pad_value": "plane_pad",
}
ROW_MASK_OFFSET = 5  # dyn_row_mask zeroes rows >= H - 5, as the probe does
PRODUCTS = ("lane_downsample_matmul", "sublane_downsample_matmul", "upsample_matmul")
# The product kernel's block tiles (rows M x columns N of out), by the index
# its entry point takes, largest first: csrc/plane_ops.cu's kTile<i>M,
# kTile<i>N.
MATMUL_TILES = ((64, 128), (32, 128))
# The smaller tile runs fewer FMAs per byte it stages: it is taken only where
# it fills the SMs more evenly by more than this share.
FILL_MARGIN = 0.2


def matmul_right(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Per channel ``x[c] @ s``: x (C, H, K), s (K, N) -> (C, H, N), summed
    over k in order, a multiply and an add per term."""
    acc = x[:, :, 0, None] * s[0]
    for k in range(1, s.shape[0]):
        acc += x[:, :, k, None] * s[k]
    return acc


def matmul_left(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per channel ``s @ x[c]``: s (M, K), x (C, K, W) -> (C, M, W), summed
    over k in order, a multiply and an add per term."""
    acc = s[None, :, 0, None] * x[:, None, 0]
    for k in range(1, s.shape[1]):
        acc += s[None, :, k, None] * x[:, None, k]
    return acc


def sublane_stride2_reference(x: torch.Tensor) -> torch.Tensor:
    return x[:, ::2, :].contiguous()


def lane_stride2_reference(x: torch.Tensor) -> torch.Tensor:
    return x[:, :, ::2].contiguous()


def lane_downsample_matmul_reference(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return matmul_right(x, s)


def sublane_downsample_matmul_reference(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return matmul_left(s, x)


def repeat_upsample_reference(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def upsample_matmul_reference(x: torch.Tensor, sh: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    return matmul_left(sh, matmul_right(x, sw))


def grouped_conv3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The Pallas body's sums: per tap the input channels, then the taps in
    order.  x (C, H+2, W+2), w (C, 9, C, 1) -> (C, H, W)."""
    H, W = x.shape[1] - 2, x.shape[2] - 2
    acc = None
    for t in range(9):
        ky, kx = divmod(t, 3)
        tap = x[:, ky:ky + H, kx:kx + W]                        # (ci, H, W)
        term = (tap[None] * w[:, t, :, 0, None, None]).sum(dim=1)  # (co, H, W)
        acc = term if acc is None else acc + term
    return acc


def dyn_row_mask_reference(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    C, H, W = x.shape
    rows = torch.arange(H, device=x.device)[None, :, None]
    o1 = torch.where(rows < H - ROW_MASK_OFFSET, x, torch.zeros((), device=x.device))
    o2 = x.view(C, 2, H // 2, W)[:, :, :H // 4, :W // 2].reshape(C, H // 2, W // 2)
    return o1, o2


def pad_value_reference(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x, (1, 1, 1, 1))


REFERENCES = {
    "sublane_stride2": sublane_stride2_reference, "lane_stride2": lane_stride2_reference,
    "lane_downsample_matmul": lane_downsample_matmul_reference,
    "sublane_downsample_matmul": sublane_downsample_matmul_reference,
    "repeat_upsample": repeat_upsample_reference, "upsample_matmul": upsample_matmul_reference,
    "grouped_conv3": grouped_conv3_reference, "dyn_row_mask": dyn_row_mask_reference,
    "pad_value": pad_value_reference,
}


def _ceil2(n: int) -> int:
    return (n + 1) // 2


def out_shapes(name: str, args) -> list[tuple[int, ...]]:
    """The output shapes of probe ``name`` on ``args``; raises on shapes
    that do not fit together."""
    x = args[0]
    if x.dim() != 3 or min(x.shape) < 1:
        raise ValueError(f"{name}: x must be planes (C, H, W) with every size >= 1, "
                         f"got shape {tuple(x.shape)}")
    C, H, W = x.shape
    for m in args[1:] if name != "grouped_conv3" else ():
        if m.dim() != 2 or min(m.shape) < 1:
            raise ValueError(f"{name}: a matrix must be 2-D and not empty, got {tuple(m.shape)}")
    if name == "sublane_stride2":
        return [(C, _ceil2(H), W)]
    if name == "lane_stride2":
        return [(C, H, _ceil2(W))]
    if name == "lane_downsample_matmul":
        if args[1].shape[0] != W:
            raise ValueError(f"{name}: s {tuple(args[1].shape)} must have W = {W} rows")
        return [(C, H, args[1].shape[1])]
    if name == "sublane_downsample_matmul":
        if args[1].shape[1] != H:
            raise ValueError(f"{name}: s {tuple(args[1].shape)} must have H = {H} columns")
        return [(C, args[1].shape[0], W)]
    if name == "repeat_upsample":
        return [(C, 2 * H, 2 * W)]
    if name == "upsample_matmul":
        sh, sw = args[1:]
        if sh.shape[1] != H or sw.shape[0] != W:
            raise ValueError(f"{name}: sh {tuple(sh.shape)} must have H = {H} columns and "
                             f"sw {tuple(sw.shape)} W = {W} rows")
        return [(C, sh.shape[0], sw.shape[1])]
    if name == "grouped_conv3":
        w = args[1]
        if tuple(w.shape) != (C, 9, C, 1) or H < 3 or W < 3:
            raise ValueError(f"{name}: w {tuple(w.shape)} must be (C, 9, C, 1) = ({C}, 9, {C}, 1) "
                             f"and x {tuple(x.shape)} at least 3 x 3 inside")
        return [(C, H - 2, W - 2)]
    if name == "dyn_row_mask":
        if H % 4 or W % 2:
            raise ValueError(f"{name}: H = {H} must be a multiple of 4 and W = {W} even "
                             "(two row blocks of H/2, each giving H/4 rows and W/2 columns)")
        return [(C, H, W), (C, H // 2, W // 2)]
    if name == "pad_value":
        return [(C, H + 2, W + 2)]
    raise ValueError(f"unknown plane probe {name!r}")


def work(name: str, args) -> tuple[int, int]:
    """(bytes, operations) of one call of probe ``name`` on ``args``: each
    input read once, each output written once, a multiply-add 2 operations;
    a copy, a select and a pad do no arithmetic.  Only the bytes the
    function must touch count: a stride along H skips whole rows, so
    ``sublane_stride2`` reads half of x; a stride along W does not (every
    32-byte sector holds selected elements), so ``lane_stride2`` reads all
    of it.  ``upsample_matmul``'s intermediate (C, H, sw's width) is neither
    input nor output and does not count."""
    outs = out_shapes(name, args)
    n_out = sum(torch.Size(s).numel() for s in outs)
    n_in = sum(a.numel() for a in args)
    if name == "sublane_stride2":
        n_in = n_out
    x = args[0]
    C, H, W = x.shape
    flops = 0
    if name == "lane_downsample_matmul":
        flops = 2 * C * H * W * args[1].shape[1]
    elif name == "sublane_downsample_matmul":
        flops = 2 * C * args[1].shape[0] * H * W
    elif name == "upsample_matmul":
        sh, sw = args[1:]
        flops = 2 * C * H * W * sw.shape[1] + 2 * C * sh.shape[0] * H * sw.shape[1]
    elif name == "grouped_conv3":
        flops = 2 * 9 * C * C * (H - 2) * (W - 2)
    return 4 * (n_in + n_out), flops


def tile_counts(batch: int, M: int, N: int, a_batched: bool, b_batched: bool) -> list[int]:
    """Blocks of each ``MATMUL_TILES`` row for ``out[b] = a[b] @ b[b]``
    (M, N) over ``batch``: a right product (a batched, b shared) folds the
    batch into M, as the entry point does; otherwise every b has its tiles."""
    if a_batched and not b_batched:
        batch, M = 1, batch * M
    return [batch * -(-M // tm) * -(-N // tn) for tm, tn in MATMUL_TILES]


def tile_fill(tiles: int, sms: int) -> Fraction:
    """How evenly ``tiles`` blocks fill ``sms`` SMs: tiles / (waves * sms),
    waves = ceil(tiles / sms); the busiest SM does 1 / fill times the
    average's work."""
    return Fraction(tiles, -(-tiles // sms) * sms)


def select_tile(batch: int, M: int, N: int, a_batched: bool, b_batched: bool,
                sms: int) -> int:
    """The first (largest) ``MATMUL_TILES`` row whose blocks fill ``sms``
    SMs within ``FILL_MARGIN`` of the most even row's fill."""
    fill = [tile_fill(n, sms) for n in tile_counts(batch, M, N, a_batched, b_batched)]
    best = max(fill)
    return next(i for i, f in enumerate(fill) if f >= (1 - Fraction(FILL_MARGIN)) * best)


def product_launches(name: str, args) -> list[tuple[int, int, int, int, bool, bool]]:
    """(batch, M, K, N, a_batched, b_batched) of each launch of the product
    kernel that probe ``name`` makes, in order: ``x @ s`` is a right product,
    ``s @ x`` a left one, and ``upsample_matmul`` makes ``mid = x @ sw``,
    then ``sh @ mid``.  What the wrapper launches, for reports and tests;
    the wrapper itself picks each launch's tile from its own operands."""
    C, H, W = args[0].shape
    if name == "lane_downsample_matmul":
        return [(C, H, W, args[1].shape[1], True, False)]
    if name == "sublane_downsample_matmul":
        return [(C, args[1].shape[0], H, W, False, True)]
    if name == "upsample_matmul":
        sh, sw = args[1:]
        return [(C, H, W, sw.shape[1], True, False), (C, sh.shape[0], H, sw.shape[1], False, True)]
    raise ValueError(f"{name} is not a product probe")


def product_tiles(name: str, args, sms: int) -> list[int]:
    """The tile row of each product launch of probe ``name`` on ``args``."""
    return [select_tile(b, M, N, ab, bb, sms) for b, M, _, N, ab, bb in product_launches(name, args)]


def tile_name(i: int) -> str:
    return "x".join(map(str, MATMUL_TILES[i]))


def _check(name: str, args, shapes) -> None:
    """Device, dtype, contiguity and size checks of a launch with outputs
    of ``shapes``."""
    x = args[0]
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must be a CUDA tensor, got {x.device}")
    for a in args:
        if a.device != x.device:
            raise ValueError(f"{name}: every input must be on {x.device} (CUDA), got {a.device}")
        if a.dtype != torch.float32:
            raise ValueError(f"{name}: inputs must be float32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous, got strides {a.stride()}")
        if a.numel() >= 2**31:
            raise ValueError(f"{name}: {a.numel()} elements exceed the kernel's int32 sizes")
    if max(max(s) for s in shapes) >= 2**31:
        raise ValueError(f"{name}: outputs {shapes} exceed the kernel's int32 sizes")


class PlaneOpsKernels:
    """Wrappers of the CUDA plane-primitive kernels, one per probe, with
    launch counts by probe."""

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
            argtypes = {
                "plane_strided_slice": [p, p] + [i] * 5 + [p],
                "plane_select_matmul": [p] * 3 + [i] * 7 + [p],
                "plane_repeat_upsample": [p, p] + [i] * 3 + [p],
                "plane_grouped_conv3": [p] * 3 + [i] * 3 + [p],
                "plane_row_mask": [p] * 3 + [i] * 4 + [p],
                "plane_pad": [p, p] + [i] * 3 + [p],
            }
            for fn_name, types in argtypes.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = types
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def _launch(self, name: str, entry: str, *args) -> None:
        """``entry(*args, stream)``, raising on a refused launch."""
        x = args[0]
        with torch.cuda.device(x.device):
            err = getattr(self.load(), entry)(
                *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
                torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")

    def _matmul(self, name: str, a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> None:
        """out (batch, M, N) = a @ b, one of the two a batch of planes (3-D),
        the other one shared matrix (2-D), in the tile row ``select_tile``
        picks for these operands on this card."""
        sms = torch.cuda.get_device_properties(out.device).multi_processor_count
        tile = select_tile(out.shape[0], a.shape[-2], b.shape[-1], a.dim() == 3, b.dim() == 3, sms)
        self.launch_matmul(name, a, b, out, tile)

    def launch_matmul(self, name: str, a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
                      tile: int) -> None:
        """``_matmul`` in block tiles ``MATMUL_TILES[tile]``."""
        M, K, N = a.shape[-2], a.shape[-1], b.shape[-1]
        self._launch(name, "plane_select_matmul", a, b, out, out.shape[0], M, K, N,
                     int(a.dim() == 3), int(b.dim() == 3), tile)

    def _call(self, name: str, *args):
        """The plain version when every tensor lies on the CPU; otherwise the
        probe's kernel, or an error."""
        shapes = out_shapes(name, args)
        if all(a.device.type == "cpu" for a in args):
            return REFERENCES[name](*args)
        _check(name, args, shapes)
        outs = [torch.empty(s, device=args[0].device, dtype=torch.float32) for s in shapes]
        x, C, H, W = args[0], *args[0].shape
        if name in ("sublane_stride2", "lane_stride2"):
            sh, sw = (2, 1) if name == "sublane_stride2" else (1, 2)
            self._launch(name, "plane_strided_slice", x, outs[0], C, H, W, sh, sw)
        elif name == "lane_downsample_matmul":
            self._matmul(name, x, args[1], outs[0])
        elif name == "sublane_downsample_matmul":
            self._matmul(name, args[1], x, outs[0])
        elif name == "upsample_matmul":
            sh, sw = args[1:]
            mid = torch.empty((C, H, sw.shape[1]), device=x.device, dtype=torch.float32)
            self._matmul(name, x, sw, mid)
            self._matmul(name, sh, mid, outs[0])
        elif name == "repeat_upsample":
            self._launch(name, "plane_repeat_upsample", x, outs[0], C, H, W)
        elif name == "grouped_conv3":
            self._launch(name, "plane_grouped_conv3", x, args[1], outs[0], C, H - 2, W - 2)
        elif name == "dyn_row_mask":
            self._launch(name, "plane_row_mask", x, *outs, C, H, W, H - ROW_MASK_OFFSET)
        else:
            self._launch(name, "plane_pad", x, outs[0], C, H, W)
        self.launches[name] += 1
        return outs[0] if len(outs) == 1 else tuple(outs)

    def sublane_stride2(self, x: torch.Tensor) -> torch.Tensor:
        """``x[:, ::2, :]``."""
        return self._call("sublane_stride2", x)

    def lane_stride2(self, x: torch.Tensor) -> torch.Tensor:
        """``x[:, :, ::2]``."""
        return self._call("lane_stride2", x)

    def lane_downsample_matmul(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """Per channel ``x[c] @ s``; see ``matmul_right``."""
        return self._call("lane_downsample_matmul", x, s)

    def sublane_downsample_matmul(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """Per channel ``s @ x[c]``; see ``matmul_left``."""
        return self._call("sublane_downsample_matmul", x, s)

    def repeat_upsample(self, x: torch.Tensor) -> torch.Tensor:
        """Nearest 2x upsample along H and W."""
        return self._call("repeat_upsample", x)

    def upsample_matmul(self, x: torch.Tensor, sh: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
        """Per channel ``sh @ (x[c] @ sw)``, two launches of the product."""
        return self._call("upsample_matmul", x, sh, sw)

    def grouped_conv3(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Valid 3x3 conv; see ``grouped_conv3_reference``."""
        return self._call("grouped_conv3", x, w)

    def dyn_row_mask(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(o1, o2); see ``dyn_row_mask_reference``."""
        return self._call("dyn_row_mask", x)

    def pad_value(self, x: torch.Tensor) -> torch.Tensor:
        """A zero ring of one pixel."""
        return self._call("pad_value", x)
