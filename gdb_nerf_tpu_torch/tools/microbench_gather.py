"""Gathers from a resident table against PyTorch's own: the port's gather microbench.

The port's counterpart of ``tools/microbench_pallas_gather.py``, with the
kernels ``take`` and ``take_along`` of ``kernels/gather.py`` in place of the
Pallas ones and PyTorch's gathers (``index_select``, indexing,
``take_along_dim``; the fastest is the yardstick) in place of XLA's ``take``.  Its shapes and seeds: a table (8192, 16) in bf16
(256 KB) from seed 0 and 1,048,576 int32 indices (N, 1) from seed 1.

    python -m gdb_nerf_tpu_torch.tools.microbench_gather            # times, bf16
    python -m gdb_nerf_tpu_torch.tools.microbench_gather --check    # exactness, f32 and bf16

It prints the library gathers first, then each kernel's time, its rate in
M rows/s, its bound, its share of the bound and its ratio to the fastest
library call; each kernel's output must equal every library call's bit for bit (a gather copies), else it raises.  It runs
on ``cuda`` and exits non-zero without a GPU; ``--device cpu`` runs the
kernels' plain versions on the CPU instead (times then are host clock times
of the CPU, not device times).  On the GPU, times are CUDA events over many
calls after a warm-up, and a kernel that fails to build or launch raises:
nothing falls back.  ``tools/microbench_rowgather.py`` is the row-gather
probe's counterpart and shares these functions.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass

import torch

from gdb_nerf_tpu_torch.kernels.gather import GatherKernels, work
from gdb_nerf_tpu_torch.kernels.measure import bound_ms, timed_ms

ITERS = 20


@dataclass(frozen=True)
class Probe:
    """One TPU probe's shapes and the kernels it compares."""
    rows: int
    C: int
    N: int
    kernels: tuple[str, ...]
    idx_2d: bool                     # indices (N, 1) as the probe makes them, else (N,)
    ragged: tuple[int, int, int]     # (rows, C, N) of the check's ragged case


PROBE = Probe(rows=8192, C=16, N=1_048_576, kernels=("take", "take_along"), idx_2d=True,
              ragged=(1000, 13, 100_003))


def inputs(rows: int, C: int, N: int, dtype: torch.dtype, device, idx_2d: bool = False,
           seed: int = 0):
    """table (rows, C) ~ N(0, 1) in ``dtype`` from ``seed``, and int32
    indices in [0, rows) from ``seed + 1``, (N, 1) or (N,)."""
    g = torch.Generator().manual_seed(seed)
    table = torch.randn(rows, C, generator=g).to(dtype)
    g.manual_seed(seed + 1)
    idx = torch.randint(0, rows, (N, 1) if idx_2d else (N,), generator=g, dtype=torch.int32)
    return table.to(device), idx.to(device)


def library_calls(table: torch.Tensor, idx: torch.Tensor) -> dict:
    """PyTorch's single calls that compute the row gather on in-range
    indices, each given its indices in the type it takes (made once,
    outside the call): ``index_select`` on the int32 indices and on int64
    ones, indexing with int64 ones, and ``take_along_dim`` over the int64
    index broadcast to (N, C), one index per element.  The fastest is the
    yardstick of every kernel's time, and each is a reference of the
    checks; they are used nowhere else."""
    flat = idx.reshape(-1)
    wide = flat.long()
    full = wide[:, None].expand(flat.shape[0], table.shape[1])
    return {"index_select": lambda: torch.index_select(table, 0, flat),
            "index_select int64": lambda: torch.index_select(table, 0, wide),
            "table[int64]": lambda: table[wide],
            "take_along_dim": lambda: torch.take_along_dim(table, full, dim=0)}


def library_times(table: torch.Tensor, idx: torch.Tensor, device) -> dict[str, float]:
    """ms of each of ``library_calls`` on (table, idx)."""
    return {lib: timed_ms(fn, device, ITERS) for lib, fn in library_calls(table, idx).items()}


def agree(kernels: GatherKernels, name: str, table: torch.Tensor, idx: torch.Tensor) -> None:
    """Kernel ``name`` on (table, idx) must equal each library call bit for bit."""
    got = getattr(kernels, name)(table, idx)
    for lib, fn in library_calls(table, idx).items():
        if not torch.equal(got, fn()):
            raise AssertionError(f"{name} differs from {lib} at table {tuple(table.shape)} "
                                 f"{table.dtype}, N = {idx.shape[0]}")


def compare(kernels: GatherKernels, name: str, table: torch.Tensor, idx: torch.Tensor,
            device, library: dict[str, float] | None = None) -> dict:
    """Kernel against the fastest library call on (table, idx) (``library``:
    their times, if taken already): the times, that call's name and the bound."""
    ms = timed_ms(lambda: getattr(kernels, name)(table, idx), device, ITERS)
    library = library or library_times(table, idx, device)
    fastest = min(library, key=library.get)
    b_ms, bound_by = bound_ms(*work(name, *table.shape, idx.shape[0], table.dtype), table.dtype)
    return {"ms": ms, "library": fastest, "library_ms": library[fastest], "bound_ms": b_ms,
            "bound_by": bound_by}


def where(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{torch.cuda.get_device_name(device)}, CUDA events"
    return "cpu, host clock, plain versions"


def rate(N: int, ms: float) -> float:
    """M rows/s of N rows in ``ms``."""
    return N / ms / 1e3


def run_check(probe: Probe, kernels: GatherKernels, device, dtype) -> None:
    """Each of the probe's kernels at its full size and at its ragged size
    equals the library calls."""
    for rows, C, N in ((probe.rows, probe.C, probe.N), probe.ragged):
        table, idx = inputs(rows, C, N, dtype, device, probe.idx_2d)
        for name in probe.kernels:
            agree(kernels, name, table, idx)
        print(f"{', '.join(probe.kernels)} ({str(dtype)[6:]}) at table ({rows}, {C}), N = {N}: "
              f"equal to PyTorch's gathers")


def run_bench(probe: Probe, kernels: GatherKernels, device) -> dict:
    """The probe's bench in bf16 at its full size: the library calls, then
    each kernel, checked bit for bit first.  Returns ``compare``'s fields by
    kernel."""
    device = torch.device(device)
    table, idx = inputs(probe.rows, probe.C, probe.N, torch.bfloat16, device, probe.idx_2d)
    for name in probe.kernels:
        agree(kernels, name, table, idx)
    library = library_times(table, idx, device)
    results = {name: compare(kernels, name, table, idx, device, library)
               for name in probe.kernels}
    print(f"table ({probe.rows}, {probe.C}) bf16, N = {probe.N:,} ({where(device)})")
    for lib, ms in library.items():
        print(f"{lib:<18}: {ms:8.4f} ms  ({rate(probe.N, ms):8.1f} M rows/s)")
    for name, r in results.items():
        print(f"kernel {name:<11}: {r['ms']:8.4f} ms  ({rate(probe.N, r['ms']):8.1f} M rows/s)  "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f} % "
              f"of it; fastest library call {r['library']}: library/kernel "
              f"{r['library_ms'] / r['ms']:.2f}x")
    return results


def check(kernels: GatherKernels, device, dtype=torch.float32) -> None:
    """take and take_along at the probe's size and a ragged one."""
    run_check(PROBE, kernels, device, dtype)


def bench(kernels: GatherKernels, device) -> dict:
    """take and take_along against PyTorch's gathers."""
    return run_bench(PROBE, kernels, device)


def main(argv: list[str] | None = None, probe_check=check, probe_bench=bench,
         doc: str = __doc__) -> None:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--check", action="store_true", help="exactness, float32 and bf16")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; pass --device cpu to run the plain versions")
    kernels = GatherKernels()
    if args.check:
        for dtype in (torch.float32, torch.bfloat16):
            probe_check(kernels, device, dtype)
        print("numerics OK")
    else:
        probe_bench(kernels, device)
    if device.type == "cuda":
        print(f"kernel launches: {kernels.launches}")


if __name__ == "__main__":
    main()
