"""The gather kernels (K5-K6) of the port against the Pallas kernels.

The JAX side is the four Pallas bodies of the gather probes, copied verbatim
from ``tools/microbench_pallas_gather.py:50-94`` (``take_kernel``,
``taa_kernel`` and their ``pallas_call``) and
``tools/microbench_pallas_rowgather.py:59-153`` (``vmem_loop_kernel``,
``dma_ring_kernel`` and theirs): the tools define them inside ``main()``,
so no test can import them.  They run with ``interpret=True`` on the CPU at
small sizes (ROWS 64, C 16 / 128, N 512-1024, TILE 128-256, DEPTH 8).  The
port's side is ``GatherKernels`` on CPU tensors, which runs the plain
versions.  The same numpy inputs, made from a seed, go through both, in bf16
and float32, with in-range indices; a gather copies, so the two must be
equal bit for bit.

The CUDA kernels cannot run here; ``test_row_loop_schedule_replay`` and
``test_dma_ring_schedule_replay`` replay their schedules in torch from the
constants of ``csrc/gather.cu``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gdb_nerf_tpu_torch.kernels import gather
from gdb_nerf_tpu_torch.kernels.gather import GatherKernels
from gdb_nerf_tpu_torch.kernels.measure import bound_ms
from gdb_nerf_tpu_torch.tools import microbench_gather, microbench_rowgather

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def gather_probe(ROWS, C, N, TILE, dtype):
    """pallas_take and pallas_taa of tools/microbench_pallas_gather.py:50-94,
    with ``interpret=True``."""

    def take_kernel(idx_ref, tab_ref, out_ref):
        out_ref[:] = jnp.take(tab_ref[:], idx_ref[:, 0], axis=0)

    def pallas_take(tab, idx):
        return pl.pallas_call(
            take_kernel,
            out_shape=jax.ShapeDtypeStruct((N, C), dtype),
            grid=(N // TILE,),
            in_specs=[
                pl.BlockSpec((TILE, 1), lambda i: (i, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec((ROWS, C), lambda i: (0, 0), memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec(
                (TILE, C), lambda i: (i, 0), memory_space=pltpu.VMEM
            ),
            interpret=True,
        )(idx, tab)

    def taa_kernel(idx_ref, tab_ref, out_ref):
        ids = idx_ref[:]  # (TILE, 1)
        out_ref[:] = jnp.take_along_axis(
            tab_ref[:], jnp.broadcast_to(ids, (TILE, C)), axis=0
        )

    def pallas_taa(tab, idx):
        return pl.pallas_call(
            taa_kernel,
            out_shape=jax.ShapeDtypeStruct((N, C), dtype),
            grid=(N // TILE,),
            in_specs=[
                pl.BlockSpec((TILE, 1), lambda i: (i, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec((ROWS, C), lambda i: (0, 0), memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec(
                (TILE, C), lambda i: (i, 0), memory_space=pltpu.VMEM
            ),
            interpret=True,
        )(idx, tab)

    return {"take": pallas_take, "take_along": pallas_taa}


def rowgather_probe(ROWS, C, N, TILE, DEPTH, dtype):
    """pallas_vmem_loop and pallas_dma_ring of
    tools/microbench_pallas_rowgather.py:59-153, with ``interpret=True``."""

    def vmem_loop_kernel(idx_ref, tab_ref, out_ref):
        t = pl.program_id(0)

        def body(i, _):
            r = idx_ref[t * TILE + i]
            out_ref[pl.ds(i, 1), :] = tab_ref[pl.ds(r, 1), :]
            return 0

        jax.lax.fori_loop(0, TILE, body, 0)

    def pallas_vmem_loop(tab, idx):
        grid_spec = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(N // TILE,),
            in_specs=[pl.BlockSpec((ROWS, C), lambda i, s: (0, 0))],
            out_specs=pl.BlockSpec((TILE, C), lambda i, s: (i, 0)),
        )
        return pl.pallas_call(
            vmem_loop_kernel,
            out_shape=jax.ShapeDtypeStruct((N, C), dtype),
            grid_spec=grid_spec,
            interpret=True,
        )(idx, tab)

    def dma_ring_kernel(idx_ref, tab_hbm, out_ref):
        t = pl.program_id(0)

        def body(scratch, sems):
            def get_dma(slot, j):
                return pltpu.make_async_copy(
                    tab_hbm.at[pl.ds(idx_ref[t * TILE + j], 1), :],
                    scratch.at[pl.ds(slot, 1), :],
                    sems.at[slot],
                )

            def warm(j, _):
                get_dma(j, j).start()
                return 0

            jax.lax.fori_loop(0, DEPTH, warm, 0)

            def body2(j, _):
                slot = jax.lax.rem(j, DEPTH)
                get_dma(slot, j).wait()
                out_ref[pl.ds(j, 1), :] = scratch[pl.ds(slot, 1), :]

                nxt = j + DEPTH

                @pl.when(nxt < TILE)
                def _():
                    get_dma(slot, nxt).start()

                return 0

            jax.lax.fori_loop(0, TILE, body2, 0)

        pl.run_scoped(
            body,
            scratch=pltpu.VMEM((DEPTH, C), dtype),
            sems=pltpu.SemaphoreType.DMA((DEPTH,)),
        )

    def pallas_dma_ring(tab, idx):
        grid_spec = pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(N // TILE,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.ANY)],
            out_specs=pl.BlockSpec((TILE, C), lambda i, s: (i, 0)),
        )
        return pl.pallas_call(
            dma_ring_kernel,
            out_shape=jax.ShapeDtypeStruct((N, C), dtype),
            grid_spec=grid_spec,
            interpret=True,
        )(idx, tab)

    return {"row_loop": pallas_vmem_loop, "dma_ring": pallas_dma_ring}


def _inputs(seed, rows, C, N, idx_shape, dtype):
    """The same table and indices for JAX and torch: the table rounded to
    ``dtype`` in JAX, its values handed to torch; in-range int32 indices."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    tab_j = jnp.asarray(rng.standard_normal((rows, C)).astype(np.float32)).astype(jdt)
    idx = rng.integers(0, rows, idx_shape).astype(np.int32)
    tab_t = torch.from_numpy(np.array(tab_j.astype(jnp.float32))).to(tdt)
    return tab_j, jnp.asarray(idx), tab_t, torch.from_numpy(idx)


def _assert_equal(got: torch.Tensor, want):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


# (ROWS, C, N, TILE): the probe's kernels need N % TILE == 0.
PROBES = {
    "take": (64, 16, 1024, 256), "take_along": (64, 16, 1024, 256),
    "row_loop": (64, 128, 512, 128), "dma_ring": (64, 128, 512, 128),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", gather.KERNELS)
def test_gather_matches_pallas_and_jnp_take(name, dtype):
    rows, C, N, tile = PROBES[name]
    jdt = DTYPES[dtype][0]
    gather_tool = name in ("take", "take_along")
    tab_j, idx_j, tab_t, idx_t = _inputs(gather.KERNELS.index(name), rows, C, N,
                                         (N, 1) if gather_tool else (N,), dtype)
    if gather_tool:
        pallas = gather_probe(rows, C, N, tile, jdt)[name]
    else:
        pallas = rowgather_probe(rows, C, N, tile, 8, jdt)[name]
    kernels = GatherKernels()
    got = getattr(kernels, name)(tab_t, idx_t)
    assert got.dtype == tab_t.dtype and kernels.launches[name] == 0
    _assert_equal(got, pallas(tab_j, idx_j))
    _assert_equal(got, jnp.take(tab_j, idx_j.reshape(-1), axis=0))


def test_plain_versions_clamp_out_of_range_indices():
    """The kernels clamp as the Pallas loop's pl.ds does; jnp.take would fill."""
    table = torch.arange(12.0).reshape(4, 3)
    idx = torch.tensor([-5, 0, 3, 4, 2**31 - 1], dtype=torch.int32)
    want = table[[0, 0, 3, 3, 3]]
    for name in gather.KERNELS:
        assert torch.equal(gather.REFERENCES[name](table, idx), want), name
        assert torch.equal(gather.REFERENCES[name](table, idx[:, None]), want), name


def test_wrappers_take_plain_path_on_cpu_only():
    kernels = GatherKernels()
    table, idx = microbench_gather.inputs(50, 16, 300, torch.bfloat16, "cpu", idx_2d=True)
    for name in gather.KERNELS:
        assert torch.equal(getattr(kernels, name)(table, idx), table[idx[:, 0].long()])
    assert kernels.launches == dict.fromkeys(gather.KERNELS, 0)
    # Off the CPU there is no plain fallback: the wrapper launches or raises.
    for name in gather.KERNELS:
        with pytest.raises(ValueError, match="CUDA"):
            getattr(kernels, name)(table.to("meta"), idx.to("meta"))
    assert kernels.launches == dict.fromkeys(gather.KERNELS, 0)


def test_work_and_bound_at_the_tools_sizes():
    """Output + indices + table bytes, no operations: at 3.35 TB/s the gather
    probe's call takes at least 0.0113 ms and the row-gather probe's 0.0210 ms."""
    for tool, want_bytes, want_ms in ((microbench_gather, 38_010_880, 0.0113),
                                      (microbench_rowgather, 70_254_592, 0.0210)):
        p = tool.PROBE
        for name in p.kernels:
            n_bytes, flops = gather.work(name, p.rows, p.C, p.N, torch.bfloat16)
            assert (n_bytes, flops) == (want_bytes, 0)
            ms, by = bound_ms(n_bytes, flops, torch.bfloat16)
            assert by == "bytes" and round(ms, 4) == want_ms
    assert gather.work("take", 10, 3, 7, torch.float32) == (7 * 3 * 4 + 28 + 10 * 3 * 4, 0)


@pytest.mark.parametrize("tool", [microbench_gather, microbench_rowgather])
def test_tools_on_cpu_and_no_gpu_exit(tool, monkeypatch, capsys):
    """Each tool's bench and check with --device cpu (at a small probe: the
    control flow, not the CPU's times), and a non-zero exit on cuda without
    a GPU."""
    small = tool.PROBE.__class__(**{**tool.PROBE.__dict__, "rows": 100, "N": 4096,
                                    "ragged": (37, tool.PROBE.ragged[1], 1001)})
    monkeypatch.setattr(tool, "PROBE", small)
    tool.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "index_select" in out
    assert all(f"kernel {name}" in out for name in small.kernels)
    tool.main(["--check", "--device", "cpu"])
    assert "numerics OK" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        tool.main([])
    assert exc.value.code not in (None, 0)


def _cu_constants() -> dict:
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", gather.SOURCE.read_text())}


@pytest.mark.parametrize("N", [1, 255, 257, 1000, 3 * 256 + 7])
def test_row_loop_schedule_replay(N):
    """row_loop's schedule: a grid of ceil(N / kLoopTile) blocks; warp w of
    block b copies rows b * kLoopTile + w + k * kLoopWarps of its tile.
    Every output row is written exactly once."""
    k = _cu_constants()
    tile, warps = k["kLoopTile"], k["kLoopWarps"]
    writes = torch.zeros(N, dtype=torch.int64)
    for b in range((N + tile - 1) // tile):
        n = min(tile, N - b * tile)
        for w in range(warps):
            for j in range(w, n, warps):
                writes[b * tile + j] += 1
    assert (writes == 1).all()


@pytest.mark.parametrize("N", [1, 7, 8, 9, 63, 64, 65, 1000, 64 * 5 + 13])
def test_dma_ring_schedule_replay(N):
    """dma_ring's schedule, replayed with a torch table: per block of
    kRingTile rows, copies of rows 0..kRingDepth-1 are issued first; row j
    waits on slot j % kRingDepth with parity (j / kRingDepth) & 1, copies
    the slot out, and refills it with row j + kRingDepth if the tile has one.
    Each wait must find its slot's copy issued and not yet consumed, with the
    parity of that slot's issue count (its phase flips once per completed
    copy); every output row is written once; no copy is left unwaited."""
    k = _cu_constants()
    tile, depth = k["kRingTile"], k["kRingDepth"]
    assert k["kRingThreads"] == 32  # one warp per block
    rows, C = 37, 4
    g = torch.Generator().manual_seed(N)
    table = torch.randn(rows, C, generator=g)
    idx = torch.randint(-3, rows + 3, (N,), generator=g, dtype=torch.int32)
    out = torch.full((N, C), float("nan"))
    writes = torch.zeros(N, dtype=torch.int64)
    for b in range((N + tile - 1) // tile):
        n = min(tile, N - b * tile)
        rids = idx[b * tile:b * tile + n].long().clamp(0, rows - 1)  # the tile's prefetch
        slots = torch.full((depth, C), float("nan"))
        issued, consumed = [0] * depth, [0] * depth
        pending: list[int | None] = [None] * depth

        def issue(j):
            s = j % depth
            assert pending[s] is None  # the slot was drained before its refill
            pending[s] = j
            slots[s] = table[rids[j]]
            issued[s] += 1

        for j in range(min(depth, n)):
            issue(j)
        for j in range(n):
            s, parity = j % depth, (j // depth) & 1
            assert pending[s] == j and parity == (issued[s] - 1) & 1
            assert consumed[s] == issued[s] - 1  # the phase this wait completes
            consumed[s] += 1
            pending[s] = None
            out[b * tile + j] = slots[s]
            writes[b * tile + j] += 1
            if j + depth < n:
                issue(j + depth)
        assert pending == [None] * depth and issued == consumed
    assert (writes == 1).all()
    assert torch.equal(out, gather.dma_ring_reference(table, idx))
