"""Row gathers from a table: CUDA kernel wrappers and their plain versions.

Replace the Pallas kernels of the two TPU gather probes:

* ``take``       <- ``tools/microbench_pallas_gather.py::pallas_take``:
  a row gather, ``jnp.take(table, idx, axis=0)``;
* ``take_along`` <- ``…::pallas_taa``: the same function as
  ``take_along_axis`` over the index broadcast to ``(N, C)`` (one index per
  element on the TPU); the kernel reads each row's index once, a warp's
  lanes loading 32 rows' indices together and sharing them by shuffles;
* ``row_loop``   <- ``tools/microbench_pallas_rowgather.py::pallas_vmem_loop``:
  a scalar-indexed loop of row copies;
* ``dma_ring``   <- ``…::pallas_dma_ring``: a ring of 8 in-flight one-row
  asynchronous copies (Hopper's bulk copy completing on an mbarrier).

Each computes ``out[i, :] = table[clamp(idx[i], 0, rows - 1), :]`` for a
table ``(rows, C)`` in float32 or bf16 and int32 indices ``(N,)`` or
``(N, 1)`` (the gather probe's layout); the output is ``(N, C)`` in the
table's type.  The TPU kernels disagree on indices out of range (``jnp.take``
fills, ``pl.ds`` clamps, a DMA does neither); here every kernel and plain
version clamps, so no kernel reads outside the table.  A gather copies bits,
so a kernel equals its plain version exactly.

``GatherKernels`` holds the four wrappers and their launch counts: on CPU
tensors a wrapper runs the plain version; on CUDA tensors it builds the
library (``csrc/gather.cu``, ``nvcc`` at first use, into ``build/kernels/``)
and launches the kernel, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from gdb_nerf_tpu_torch.kernels.build import CSRC, build_library

SOURCE = CSRC / "gather.cu"
KERNELS = ("take", "take_along", "row_loop", "dma_ring")
_DTYPES = (torch.float32, torch.bfloat16)
_INVALID_VALUE = 1  # cudaErrorInvalidValue: an entry point refused its sizes


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The clamped row of each index, as int64 (N,)."""
    return idx.reshape(-1).long().clamp(0, table.shape[0] - 1)


def take_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[clamp(idx, 0, rows - 1)]``: (N, C) in table.dtype."""
    return table[_rows(table, idx)]


def take_along_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_dim`` over the clamped index broadcast to (N, C)."""
    rows = _rows(table, idx)
    return torch.take_along_dim(table, rows[:, None].expand(rows.shape[0], table.shape[1]), dim=0)


# The row loop and the ring compute the row gather; only the kernels differ.
row_loop_reference = take_reference
dma_ring_reference = take_reference

REFERENCES = {"take": take_reference, "take_along": take_along_reference,
              "row_loop": row_loop_reference, "dma_ring": dma_ring_reference}


def work(name: str, rows: int, C: int, N: int, dtype: torch.dtype) -> tuple[int, int]:
    """(bytes, operations) of one call of kernel ``name``: the output
    written once (N C e), the indices (4N) and the table (rows C e) read
    once; a gather does no arithmetic.  The same for all four kernels."""
    if name not in KERNELS:
        raise ValueError(f"unknown gather kernel {name!r}")
    e = torch.empty((), dtype=dtype).element_size()
    return N * C * e + 4 * N + rows * C * e, 0


def _check(name: str, table: torch.Tensor, idx: torch.Tensor) -> None:
    """Device, dtype, rank, contiguity and size checks.  dma_ring's
    alignment and shared-memory rules are its entry point's own."""
    if table.device.type != "cuda":
        raise ValueError(f"{name}: table must be a CUDA tensor, got {table.device}")
    if idx.device != table.device:
        raise ValueError(f"{name}: idx must be on {table.device} (CUDA), got {idx.device}")
    if table.dtype not in _DTYPES:
        raise ValueError(f"{name}: table must be float32 or bfloat16, got {table.dtype}")
    if idx.dtype != torch.int32:
        raise ValueError(f"{name}: idx must be int32, got {idx.dtype}")
    if table.dim() != 2 or not table.is_contiguous() or table.shape[0] < 1:
        raise ValueError(f"{name}: table must be a contiguous (rows, C) tensor with rows >= 1, "
                         f"got shape {tuple(table.shape)}")
    if not (idx.dim() == 1 or (idx.dim() == 2 and idx.shape[1] == 1)) or not idx.is_contiguous():
        raise ValueError(f"{name}: idx must be a contiguous (N,) or (N, 1) tensor, "
                         f"got shape {tuple(idx.shape)}")
    if max(table.shape[0], idx.shape[0], table.shape[1]) >= 2**31:
        raise ValueError(f"{name}: sizes exceed the kernel's int32 arguments")


class GatherKernels:
    """Wrappers of the four CUDA gather kernels, with launch counts."""

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
            for name in KERNELS:
                fn = getattr(lib, f"gather_{name}")
                fn.argtypes = [p] * 3 + [i] * 4 + [p]
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def _call(self, name: str, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """The plain version when both tensors lie on the CPU; otherwise the
        kernel, launched as ``gather_<name>(table, idx, out, rows, C, N,
        is_bf16, stream)``, or an error."""
        if table.device.type == "cpu" and idx.device.type == "cpu":
            return REFERENCES[name](table, idx)
        _check(name, table, idx)
        (rows, C), N = table.shape, idx.shape[0]
        out = torch.empty((N, C), device=table.device, dtype=table.dtype)
        if N == 0 or C == 0:
            return out  # nothing to gather: no launch
        fn = getattr(self.load(), f"gather_{name}")
        with torch.cuda.device(table.device):
            err = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, C, N,
                     int(table.dtype == torch.bfloat16),
                     torch.cuda.current_stream(table.device).cuda_stream)
        if err == _INVALID_VALUE and name == "dma_ring":
            e = table.element_size()
            raise ValueError(f"dma_ring: a bulk copy needs 16-byte aligned rows and table, and "
                             f"8 row slots within a block's shared memory; got a row of {C} x "
                             f"{e} B = {C * e} B and a table {table.data_ptr() % 16} B past a "
                             f"16-byte boundary")
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
        self.launches[name] += 1
        return out

    def take(self, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Row gather; see ``take_reference``."""
        return self._call("take", table, idx)

    def take_along(self, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Element gather over the broadcast index; see ``take_along_reference``."""
        return self._call("take_along", table, idx)

    def row_loop(self, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Row gather, one warp per row at a time; see ``take_reference``."""
        return self._call("row_loop", table, idx)

    def dma_ring(self, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Row gather through a ring of bulk copies; see ``take_reference``."""
        return self._call("dma_ring", table, idx)
