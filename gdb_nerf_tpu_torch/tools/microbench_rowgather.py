"""Scalar-indexed row gathers against PyTorch's gathers: the port's row-gather microbench.

The port's counterpart of ``tools/microbench_pallas_rowgather.py``, with the
kernels ``row_loop`` (a warp walks its rows one at a time) and ``dma_ring``
(a ring of 8 one-row bulk copies in flight) of ``kernels/gather.py`` in
place of the Pallas VMEM loop and HBM DMA ring, and PyTorch's gathers in
place of XLA's ``take``.  Its shapes and seeds: a table (8192, 128) in bf16
(2 MB, a 256-byte row) from seed 0 and 262,144 int32 indices (N,) from
seed 1.

    python -m gdb_nerf_tpu_torch.tools.microbench_rowgather            # times, bf16
    python -m gdb_nerf_tpu_torch.tools.microbench_rowgather --check    # exactness, f32 and bf16

Output, checks, devices and ``--device cpu`` as in ``microbench_gather``,
whose functions it uses.
"""

from __future__ import annotations

import torch

from gdb_nerf_tpu_torch.kernels.gather import GatherKernels
from gdb_nerf_tpu_torch.tools.microbench_gather import Probe, run_bench, run_check
from gdb_nerf_tpu_torch.tools.microbench_gather import main as _main

# The ragged case has 48-byte rows: a multiple of 16 bytes, as the ring's
# bulk copies need, but not of the 256-byte row.
PROBE = Probe(rows=8192, C=128, N=262_144, kernels=("row_loop", "dma_ring"), idx_2d=False,
              ragged=(1000, 24, 100_003))


def check(kernels: GatherKernels, device, dtype=torch.float32) -> None:
    """row_loop and dma_ring at the probe's size and a ragged one."""
    run_check(PROBE, kernels, device, dtype)


def bench(kernels: GatherKernels, device) -> dict:
    """row_loop and dma_ring against PyTorch's gathers."""
    return run_bench(PROBE, kernels, device)


def main(argv: list[str] | None = None) -> None:
    _main(argv, check, bench, __doc__)


if __name__ == "__main__":
    main()
