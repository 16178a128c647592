"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device and build: the card's name and power limit, then the four CUDA
     libraries (csrc/bundle_head.cu, csrc/plane_conv.cu, csrc/gather.cu,
     csrc/plane_ops.cu) built from this checkout's sources, the nvcc runs
     started together (build seconds, ptxas info);
  2. the bundle-head kernel against its plain PyTorch version on the card
     at the dtu_eval head shapes (N = 245,760 samples, V = 3; V = 2; a
     ragged N), in float32 and bf16, with both times and the bound, after
     a check that ptxas spilled nothing in the kernel's build;
  2b. after a check that ptxas spilled nothing in plane_conv.cu's build, the
     conv microbench path (gdb_nerf_tpu_torch/tools/microbench_conv.py)
     driven in-process, with the plane-conv kernels' launch counts set to 0
     before it and read after: its check (float32 and bf16, against cuDNN)
     and its two benches (a chain of 4 C8 3x3 convs and fpnprim, 512x640
     bf16); then conv1, convchain and fpnprim each against its plain
     version in float32 and bf16 at the full size (C8, 512x640), at the
     check's own shapes and inputs, and at a ragged shape (each also with
     12 channels and with float32 weights that are not bf16 values, where
     the kernel must be nearer the plain version on those weights than on
     the weights rounded to bf16), with the kernel's, the plain version's
     and cuDNN's times and the bound at the full size;
  2c. after a check that ptxas spilled nothing in gather.cu's build, the
     gather microbench paths (gdb_nerf_tpu_torch/tools/microbench_gather.py
     and microbench_rowgather.py) driven in-process, with the gather kernels'
     launch counts set to 0 before them and read after: each tool's check
     (float32 and bf16, against PyTorch's gathers) and bench (bf16); then
     take, take_along, row_loop and dma_ring each equal to its plain version
     (torch.equal: a gather copies) at the tool's full size, timed with the
     plain version, the fastest of PyTorch's single gather calls and the
     bound, at ragged sizes (rows
     not a power of two, N not a multiple of any tile or of the ring, N = 1,
     rows narrower than 16 bytes where the kernel takes them) and in float32;
  2d. after a check that ptxas spilled nothing in plane_ops.cu's build, the
     probe tool's path (gdb_nerf_tpu_torch/tools/probe_ops.py) driven
     in-process, with the plane-primitive kernels' launch counts set to 0
     before it and read after: its check of the nine probes at their size
     (8, 64, 256); then each probe's kernel against its plain version at
     that size, at the FPN's plane size (C8, 512x640) and at a ragged size
     (C5, H and W odd and not multiples of any tile, 508x638 for the row
     mask) and at the sizes of the conv's and the row mask's other paths
     (probe_ops.PATH_SIZES), equal bit for bit (the conv: within the conv
     tolerance), with
     PyTorch's own calls held to the plain version too (a 0/1 product in
     TF32 would differ), and the kernel's, the plain version's and the
     library calls' times, the bound, its share and the achieved TFLOP/s
     or GB/s at 512x640, with the tile row of each product launch; then the
     card tests' sizes: a random-matrix product at each tile row on either
     side (probe_ops.TILE_CASES, within 1e-5 / 1e-4) and both strided
     slices at each path's width (probe_ops.SLICE_WIDTHS, bit for bit);
  3. the golden fixture (tests/golden/dtu_eval_golden.npz) rendered through
     the port in float32 with TF32 off: > 40 dB against the frozen render,
     the MVS depth check of tests/test_golden_protocol.py, and the kernel
     launched;
  4. serving: 5 requests in float32 and 5 in bf16 at 512x640 (the synthetic
     loader's scenes, made here) through the Renderer, with finite outputs,
     one kernel launch per request and slab, the mean latency (first request
     excluded), each request's host enqueue time, the peak device memory,
     and a check that the forward makes no synchronizing call;
  5. one JSON line of kernel results, then the JSON result line.

Needs one CUDA device, nvcc, torch and numpy; no network, no yaml, and
nothing of jax or of the JAX package (gdb_nerf_tpu): the config literal and
the requests below are made here, and tests/test_torch_port_imports.py
holds them equal to the JAX package's load_cfg and loader and to the
port's own.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden", "dtu_eval_golden.npz")

# The network's part of configs/dtu_eval.yaml (over configs/dtu_pretrain.yaml
# and the package defaults), as load_cfg merges it: every section that
# Network.from_config reads.  tests/test_torch_port_imports.py holds each
# section equal to load_cfg's.  A literal, because this script reads no yaml
# and imports nothing of the JAX package.
DTU_EVAL = {
    "network_module": "networks.gdb_nerf.network",
    "compute_dtype": "float32",
    "fpn": {"base_channels": 8, "feat_dims": [32, 16, 8], "feat_scales": [0.25, 0.5, 1.0]},
    "mvs": {
        "vol_levels": [0, 1], "vol_scales": [0.125, 0.5], "ci_scales": [1.0, 1.0],
        "voxel_dim": 8, "num_depth": [64, 8], "inv_depth": [True, False],
        "num_samples": [8], "loss_weight": [0.05],
    },
    "nerf": {
        "bundle_size": 2, "global_num_depth": 64, "max_num_samples": 3,
        "max_mipmap_level": 3, "nerf_hidden_dims": 64, "chunk_size": 1000000,
        "is_adaptive": True, "viewdir_agg": True, "dec_layers": 3, "reweighting": False,
    },
}

# bf16 kernel vs the plain version in bf16: both use the head's bf16 weights
# (sigma's layer float32) and round to bf16 at the same points, but sum in
# another order (the kernel on the tensor cores).  Replayed on the CPU with
# the golden head (tests/test_torch_port_head.py) the two differ by at most
# 0.0078 (1 bf16 ulp at 1-2) in feat and 0.0007 in sigma; the bound leaves
# ~4x room.
BF16_ATOL = 0.03
F32_ATOL = F32_RTOL = 1e-4
# Plane convs against their plain versions: float32 on both sides, the
# kernel with fused multiply-adds and the sums in the same order.  bf16 is
# held to 4 bf16 ulps at the output's largest magnitude (microbench_conv.bf16_tol).
CONV_F32_ATOL, CONV_F32_RTOL = 1e-5, 1e-4
REQUESTS = 5
ITERS = 20  # timed calls per kernel, plain version or library call


def namespace(d: dict) -> SimpleNamespace:
    """A config dict as the attribute namespace that the port's factories read."""
    return SimpleNamespace(**{k: namespace(v) if isinstance(v, dict) else v
                              for k, v in d.items()})


def synthetic_requests(n: int, hw=(512, 640), views: int = 3) -> list[dict]:
    """The first ``n`` requests of the synthetic test loader (``synthetic
    True``, one request per batch), network inputs only.

    Each scene is a procedurally textured plane at depth 600 seen by five
    DTU-like cameras (focal ~2900 px at 640 wide, translated by up to 40
    units); the first ``views`` are the sources and the last is the target.
    tests/test_torch_port_imports.py holds these batches equal to the JAX
    package's loader, bit for bit.
    """
    H, W = hw
    s = W / 640.0
    K = np.array([[2892.33 * s, 0, 0], [0, 2883.18 * s, 0], [0, 0, 1]], np.float32)
    K[0, 2], K[1, 2] = W / 2, H / 2
    rng = np.random.default_rng(1234)
    scenes = [rng.uniform(-40.0, 40.0, size=(5, 2)) for _ in range(8)]
    inv_K = np.linalg.inv(K)
    x, y = np.meshgrid(np.arange(W, dtype=np.float64) + 0.5,
                       np.arange(H, dtype=np.float64) + 0.5, indexing="xy")
    pix = np.stack([x, y, np.ones_like(x)], -1)

    def cam(o):
        ext = np.eye(4, dtype=np.float32)
        ext[0, 3], ext[1, 3] = o
        return ext

    def render(ext):
        c2w = np.linalg.inv(ext.astype(np.float64))
        dirs = pix @ (c2w[:3, :3] @ inv_K).T
        t = (600.0 - c2w[2, 3]) / dirs[..., 2]
        px, py = (c2w[:2, 3] + dirs[..., :2] * t[..., None]).transpose(2, 0, 1)
        return np.stack([0.5 + 0.5 * np.sin(0.05 * px) * np.cos(0.07 * py),
                         0.5 + 0.5 * np.cos(0.04 * px + 0.06 * py),
                         0.5 + 0.5 * np.sin(0.03 * px - 0.05 * py)], axis=-1).astype(np.float32)

    out = []
    for i in range(n):
        exts = [cam(o) for o in scenes[i % len(scenes)]]
        src = np.stack(exts[:views])
        out.append({
            "src_views": {"rgb": np.stack([render(e) for e in src])[None],
                          "extrinsics": src[None], "intrinsics": np.stack([K] * views)[None]},
            "tar_views": {"extrinsics": exts[-1][None], "intrinsics": K[None]},
            "near_far": np.array([[425.0, 905.0]], np.float32),
        })
    return out


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-20))


def golden_state_dict():
    import torch

    g = np.load(GOLDEN)
    return g, {k[3:]: torch.from_numpy(np.array(g[k])) for k in g.files if k.startswith("sd/")}


def phase_device_and_build():
    """The card, then the four kernel libraries, built at once.  Returns
    the bundle-head wrapper, the plane-conv, gather and plane-primitive
    wrappers."""
    import torch

    from gdb_nerf_tpu_torch.kernels.bundle_head import BundleHeadKernel
    from gdb_nerf_tpu_torch.kernels.gather import GatherKernels
    from gdb_nerf_tpu_torch.kernels.plane_conv import PlaneConvKernels
    from gdb_nerf_tpu_torch.kernels.plane_ops import PlaneOpsKernels

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this smoke needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    libraries = {"bundle_head": BundleHeadKernel(), "plane_conv": PlaneConvKernels(),
                 "gather": GatherKernels(), "plane_ops": PlaneOpsKernels()}
    t0 = time.time()
    with ThreadPoolExecutor(len(libraries)) as pool:
        futures = [pool.submit(k.load) for k in libraries.values()]
        for f in futures:
            f.result()
    print(f"[build] {', '.join(libraries)} built (nvcc in parallel) and loaded in "
          f"{time.time() - t0:.1f} s")
    for name, k in libraries.items():
        for line in k.build_log.splitlines():
            if any(s in line for s in ("entry function", "registers", "spill", "smem")):
                print(f"[build] {name}: {line.strip()}")
    return tuple(libraries.values())


def spilled_bytes(build_log: str) -> int:
    """Bytes of spill stores and loads that ptxas reports in a build log."""
    import re

    return sum(int(a) + int(b) for a, b in
               re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", build_log))


def assert_no_spill(source: str, build_log: str) -> None:
    """Fails if ptxas reports any spill (or no report) in ``source``'s build."""
    spill = spilled_bytes(build_log)
    if spill or "spill" not in build_log:
        raise AssertionError(f"{source}: ptxas reports {spill} bytes of spill (or no report)")


def phase_kernel_vs_plain(kernel, heads):
    """K1 against bundle_head_reference on the card, each dtype with its own
    head (``heads[dtype]``), after a check that ptxas spilled nothing in
    either instantiation.  Returns the JSON fields: float32's at the top,
    bf16's under ``bf16``."""
    import torch

    from gdb_nerf_tpu_torch.kernels.bundle_head import bundle_head_reference, work
    from gdb_nerf_tpu_torch.kernels.measure import bound_ms, timed_ms

    assert_no_spill("bundle_head.cu", kernel.build_log)
    print("[k1] ptxas: no spill in either instantiation")
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    result = {}
    n_full = 256 * 320 * 3  # bundles of a 512x640 frame x 3 samples
    for n, V in ((n_full, 3), (n_full, 2), (n_full - 37, 3)):
        base = (
            torch.randn(n, 8, device="cuda", generator=gen),
            torch.rand(V, n, 31, device="cuda", generator=gen),
            torch.randn(V, n, 23, device="cuda", generator=gen),
        )
        for dt, head in heads.items():
            packed = head.packed_weights()
            vox, payload, frd = (t.to(dt) for t in base)
            sigma, feat = kernel.launch(packed, vox, payload, frd)
            torch.cuda.synchronize()
            with torch.inference_mode():
                s_ref, f_ref = bundle_head_reference(head, vox, payload, frd)
            err_s = (sigma - s_ref).abs().max().item()
            err_f = (feat.float() - f_ref.float()).abs().max().item()
            if dt == torch.float32:
                ok = (bool(((sigma - s_ref).abs() <= F32_ATOL + F32_RTOL * s_ref.abs()).all())
                      and bool(((feat - f_ref).abs() <= F32_ATOL + F32_RTOL * f_ref.abs()).all()))
            else:
                ok = err_s <= BF16_ATOL and err_f <= BF16_ATOL
            line = (f"[k1] N={n} V={V} {str(dt)[6:]}: max|dsigma|={err_s:.3e} "
                    f"max|dfeat|={err_f:.3e}")
            if n == n_full and V == 3:
                with torch.inference_mode():
                    ms = timed_ms(lambda: kernel.launch(packed, vox, payload, frd), dev, 20)
                    plain_ms = timed_ms(lambda: bundle_head_reference(head, vox, payload, frd),
                                        dev, 20)
                line += f" kernel {ms:.4f} ms plain {plain_ms:.4f} ms"
                b_ms, b_by = bound_ms(*work(n, V, dt), dt)
                line += f" bound {b_ms:.4f} ms ({b_by})"
                fields = {"max_abs_err": max(err_s, err_f), "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                          "dtype": str(dt)[6:]}
                if dt == torch.float32:
                    result.update(fields)
                else:
                    result["bf16"] = fields
            print(line)
            if not ok:
                raise AssertionError(f"bundle_head kernel disagrees with its plain version: {line}")
    return result


# Each plane-conv kernel against its plain version: the bench's full size
# (timed), the microbench check's own shape and inputs (microbench_conv.check
# and check_prims: C8, 32x256 or 64x256, seed 0), then a ragged shape (H and
# W not multiples of the tiles, channels not a multiple of the groups of 8,
# conv1 with c_in != c_out, fpnprim's o1 of odd width); for each kernel
# also float32 weights that are not bf16 values (the bf16 kernels' lo MMAs)
# and 12 channels (two groups of 8: two n8 tiles on the tensor cores; conv1
# 12 -> 5, fpnprim at 512x640).  The chain's full size takes the first row of
# each dtype's tile table, the check shape the 16x32 one.
CONV_CASES = {
    "conv1": [dict(c=8, H=512, W=640), dict(c=8, H=32, W=256),
              dict(c=5, c_out=12, H=509, W=637),
              dict(c=12, c_out=5, H=509, W=637, float32_params=True)],
    "convchain": [dict(c=8, n=4, H=512, W=640), dict(c=8, n=3, H=32, W=256),
                  dict(c=6, n=3, H=509, W=637), dict(c=8, n=4, H=509, W=637, float32_params=True),
                  dict(c=12, n=4, H=512, W=640), dict(c=12, n=3, H=509, W=637, float32_params=True)],
    "fpnprim": [dict(c=8, H=512, W=640, scale=0.1), dict(c=8, H=64, W=256, scale=0.1),
                dict(c=5, H=510, W=634, scale=0.1),
                dict(c=5, H=510, W=634, scale=0.1, float32_params=True),
                dict(c=12, H=512, W=640, scale=0.1)],
}


REPLACES = {
    "conv1": "tools/microbench_pallas_conv.py:217",
    "convchain": "tools/microbench_pallas_conv.py:235",
    "fpnprim": "tools/microbench_pallas_conv.py:153",
}


def phase_plane_conv(kernels):
    """The conv microbench path with the launch counts set to 0 before it
    and read after, then K2-K4 against their plain versions.  Returns the
    JSON entries (numbers at the full size in bf16, the bench's type)."""
    import torch

    from gdb_nerf_tpu_torch.kernels.measure import timed_ms
    from gdb_nerf_tpu_torch.kernels.plane_conv import KERNELS
    from gdb_nerf_tpu_torch.runtime.renderer import set_float32_numerics
    from gdb_nerf_tpu_torch.tools import microbench_conv as mb

    assert_no_spill("plane_conv.cu", kernels.build_log)
    print("[conv] ptxas: no spill in plane_conv.cu")
    set_float32_numerics(tf32=False)
    kernels.launches = dict.fromkeys(KERNELS, 0)
    for dtype in (torch.float32, torch.bfloat16):
        mb.check(kernels, "cuda", dtype)
        mb.check_prims(kernels, "cuda", dtype)
    mb.bench(kernels, torch.device("cuda"))
    mb.bench_prims(kernels, torch.device("cuda"))
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    print(f"[conv] launches on the microbench path: {launches}")
    entries = []
    for name, shapes in CONV_CASES.items():
        plain = mb.REFERENCES[name]
        entry = {}
        for dtype in (torch.float32, torch.bfloat16):
            for i, shape in enumerate(shapes):
                args = mb.inputs(name, dtype=dtype, device="cuda", **shape)
                got = getattr(kernels, name)(*args)
                torch.cuda.synchronize()
                err, ok = mb.agree(got, plain(*args), CONV_F32_ATOL, CONV_F32_RTOL)
                line = f"[conv] {name} {shape} {str(dtype)[6:]}: max|err| vs plain {err:.3e}"
                if shape.get("float32_params"):
                    full, rounded, kept = mb.weight_rounding_errors(name, got, args)
                    line += (f" mean|err| vs plain {full:.3e}, vs plain on bf16-rounded weights "
                             f"{rounded:.3e}")
                    ok &= kept
                if i == 0:
                    dev = torch.device("cuda")
                    r = mb.compare(kernels, name, args, dev)
                    r["plain_ms"] = timed_ms(lambda: plain(*args), dev, mb.ITERS)
                    line += (f" kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms cuDNN "
                             f"{r['library_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
                             f"({r['bound_by']})")
                    if dtype == torch.bfloat16:
                        entry = {"max_abs_err": err, **r, "dtype": "bfloat16"}
                print(line)
                if not ok:
                    raise AssertionError(f"{name} kernel disagrees with its plain version: {line}")
        entries.append({"name": name, "route": "cuda",
                        "source": "gdb_nerf_tpu_torch/csrc/plane_conv.cu",
                        "replaces": REPLACES[name], "launches": launches[name], **entry})
    return entries


GATHER_REPLACES = {
    "take": "tools/microbench_pallas_gather.py:53",
    "take_along": "tools/microbench_pallas_gather.py:82",
    "row_loop": "tools/microbench_pallas_rowgather.py:69",
    "dma_ring": "tools/microbench_pallas_rowgather.py:142",
}


def gather_cases(probe, name):
    """(rows, C, N, dtype) of one gather kernel's comparisons: its tool's
    full size in bf16 (timed) and in float32, then ragged sizes: rows not a
    power of two and N not a multiple of any tile (256, 256-row loop tiles,
    64-row ring tiles) or of the ring's 8 slots; rows narrower than 16 bytes
    (13 bf16) where the kernel takes them, else 48-byte rows (24 bf16); N = 1."""
    import torch

    narrow = 24 if name == "dma_ring" else 13
    bf16 = torch.bfloat16
    return [(probe.rows, probe.C, probe.N, bf16), (probe.rows, probe.C, probe.N, torch.float32),
            (1000, probe.C, 100_003, bf16), (777, narrow, 4097, bf16), (3, probe.C, 1, bf16)]


def phase_gather(kernels):
    """The two gather microbench paths with the launch counts set to 0
    before them and read after, then K5-K6 against their plain versions.
    Returns the JSON entries (numbers at the tool's full size, bf16)."""
    import torch

    from gdb_nerf_tpu_torch.kernels.gather import KERNELS, REFERENCES
    from gdb_nerf_tpu_torch.kernels.measure import timed_ms
    from gdb_nerf_tpu_torch.tools import microbench_gather, microbench_rowgather

    tools = {"take": microbench_gather, "take_along": microbench_gather,
             "row_loop": microbench_rowgather, "dma_ring": microbench_rowgather}
    assert_no_spill("gather.cu", kernels.build_log)
    print("[gather] ptxas: no spill in gather.cu")
    dev = torch.device("cuda")
    kernels.launches = dict.fromkeys(KERNELS, 0)
    for tool in (microbench_gather, microbench_rowgather):
        for dtype in (torch.float32, torch.bfloat16):
            tool.check(kernels, dev, dtype)
        tool.bench(kernels, dev)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    print(f"[gather] launches on the microbench paths: {launches}")
    entries = []
    for name in KERNELS:
        tool, plain = tools[name], REFERENCES[name]
        entry, err = {}, 0.0
        for i, (rows, C, N, dtype) in enumerate(gather_cases(tool.PROBE, name)):
            table, idx = microbench_gather.inputs(rows, C, N, dtype, dev, tool.PROBE.idx_2d)
            got = getattr(kernels, name)(table, idx)
            torch.cuda.synchronize()
            want = plain(table, idx)
            same = torch.equal(got, want)
            err = max(err, float((got.float() - want.float()).abs().max()))
            line = (f"[gather] {name} table ({rows}, {C}) {str(dtype)[6:]} N={N}: "
                    f"{'equal to' if same else 'DIFFERS from'} its plain version")
            if i == 0:
                r = microbench_gather.compare(kernels, name, table, idx, dev)
                r["plain_ms"] = timed_ms(lambda: plain(table, idx), dev, microbench_gather.ITERS)
                line += (f"; kernel {r['ms']:.4f} ms ({microbench_gather.rate(N, r['ms']):.1f} M "
                         f"rows/s) plain {r['plain_ms']:.4f} ms library {r['library_ms']:.4f} ms "
                         f"({r['library']}) bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
                entry = {**r, "dtype": "bfloat16"}
            print(line)
            if not same:
                raise AssertionError(f"{name} kernel disagrees with its plain version: {line}")
        entries.append({"name": name, "route": "cuda", "source": "gdb_nerf_tpu_torch/csrc/gather.cu",
                        "replaces": GATHER_REPLACES[name], "launches": launches[name],
                        "max_abs_err": err, **entry})
    return entries


# Line of each probe's function in the TPU tool.
PROBE_REPLACES = {
    "sublane_stride2": 45, "lane_stride2": 64, "lane_downsample_matmul": 83,
    "sublane_downsample_matmul": 113, "repeat_upsample": 143, "upsample_matmul": 162,
    "grouped_conv3": 195, "dyn_row_mask": 235, "pad_value": 273,
}
PROBE_FULL = (8, 512, 640)  # the FPN's first-layer planes, where K2-K4 are timed


def probe_sizes(name):
    """(C, H, W) of one probe's comparisons: the probe's own size, the FPN's
    plane size (timed), then a ragged size (C5; H and W odd and not
    multiples of any tile; H a multiple of 4 and W even for the row mask),
    then the sizes that take the conv's and the row mask's other paths
    (probe_ops.PATH_SIZES)."""
    from gdb_nerf_tpu_torch.tools import probe_ops

    ragged = (5, 508, 638) if name == "dyn_row_mask" else (5, 509, 637)
    return [(probe_ops.C, probe_ops.H, probe_ops.W), PROBE_FULL, ragged,
            *probe_ops.PATH_SIZES.get(name, [])]


def rate(n_bytes: float, flops: float, by: str, ms: float) -> str:
    """What a kernel achieved in ``ms``: TFLOP/s if operations bound it,
    else GB/s."""
    return f"{flops / ms / 1e9:.1f} TFLOP/s" if by == "operations" else f"{n_bytes / ms / 1e6:.0f} GB/s"


def phase_plane_ops(kernels):
    """The probe tool's check with the launch counts set to 0 before it and
    read after, then K7a-K7i against their plain versions, then the card
    tests' tile-row and slice-path sizes.  Returns the JSON entries (numbers
    at the FPN's plane size, float32; ``max_abs_err`` over the probes'
    inputs, a product's ``random_max_abs_err`` over its random matrices)."""
    import torch

    from gdb_nerf_tpu_torch.kernels.measure import bound_ms, timed_ms
    from gdb_nerf_tpu_torch.kernels.plane_ops import (ENTRY_POINTS, KERNELS, PRODUCTS, REFERENCES,
                                                      product_tiles, tile_name, work)
    from gdb_nerf_tpu_torch.runtime.renderer import set_float32_numerics
    from gdb_nerf_tpu_torch.tools import probe_ops

    assert_no_spill("plane_ops.cu", kernels.build_log)
    print("[probe] ptxas: no spill in plane_ops.cu")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    set_float32_numerics(tf32=False)
    kernels.launches = dict.fromkeys(KERNELS, 0)
    probe_ops.check(kernels, dev)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    print(f"[probe] launches on the probe tool's path: {launches}")
    entries = []
    for name in KERNELS:
        kernel, plain = getattr(kernels, name), REFERENCES[name]
        entry, err = {}, 0.0
        for size in probe_sizes(name):
            args = probe_ops.inputs(name, *size, dev)
            got = kernel(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            e, ok = probe_ops.agree(name, got, want)
            err = max(err, e)
            line = f"[probe] {name} {size}: max|err| vs plain {e:.3e}"
            if size == PROBE_FULL:
                library = probe_ops.library_call(name, args)
                lib_err, lib_ok = probe_ops.agree(name, library(), want)
                ms = timed_ms(lambda: kernel(*args), dev, ITERS)
                plain_ms = timed_ms(lambda: plain(*args), dev, ITERS)
                library_ms = timed_ms(library, dev, ITERS)
                n_bytes, flops = work(name, args)
                b_ms, b_by = bound_ms(n_bytes, flops, torch.float32)
                line += (f", library vs plain {lib_err:.3e}; kernel {ms:.4f} ms plain "
                         f"{plain_ms:.4f} ms library {library_ms:.4f} ms bound {b_ms:.4f} ms "
                         f"({b_by}), {100 * b_ms / ms:.0f} % of it, "
                         f"{rate(n_bytes, flops, b_by, ms)}")
                entry = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": library_ms, "dtype": "float32"}
                if name in PRODUCTS:
                    entry["tile"] = [tile_name(i) for i in product_tiles(name, args, sms)]
                    line += f"; tile {' then '.join(entry['tile'])}"
                if not lib_ok:
                    raise AssertionError(f"{name}: PyTorch's calls disagree with the plain "
                                         f"version (TF32 on?): {line}")
            print(line)
            if not ok:
                raise AssertionError(f"{name} kernel disagrees with its plain version: {line}")
        entries.append({"name": name, "route": "cuda", "source": "gdb_nerf_tpu_torch/csrc/plane_ops.cu",
                        "kernel": ENTRY_POINTS[name],
                        "replaces": f"tools/probe_mosaic_ops.py:{PROBE_REPLACES[name]}",
                        "launches": launches[name], "max_abs_err": err, **entry})
    by_name = {e["name"]: e for e in entries}
    for case in probe_ops.TILE_CASES:
        name = case[0]
        args = probe_ops.random_product_inputs(*case, dev, seed=case[3])
        got = getattr(kernels, name)(*args)
        torch.cuda.synchronize()
        err, ok = probe_ops.close(got, REFERENCES[name](*args))
        entry = by_name[name]
        entry["random_max_abs_err"] = max(entry.get("random_max_abs_err", 0.0), err)
        line = (f"[probe] {name} random matrix {case[1:]}: tile "
                f"{tile_name(product_tiles(name, args, sms)[0])}, max|err| vs plain {err:.3e}")
        print(line)
        if not ok:
            raise AssertionError(f"{name} kernel disagrees with its plain version: {line}")
    for W in probe_ops.SLICE_WIDTHS:
        x = torch.randn(probe_ops.SLICE_C, probe_ops.SLICE_H, W, device=dev)
        for name in ("sublane_stride2", "lane_stride2"):
            same = torch.equal(getattr(kernels, name)(x), REFERENCES[name](x))
            print(f"[probe] {name} W={W}: {'equal to' if same else 'DIFFERS from'} its plain version")
            if not same:
                raise AssertionError(f"{name} kernel disagrees with its plain version at W={W}")
    return entries


def golden_batch(g, device):
    from gdb_nerf_tpu_torch.runtime.renderer import to_device

    return to_device({
        "src_views": {"rgb": g["batch/src_rgb"], "extrinsics": g["batch/src_ext"],
                      "intrinsics": g["batch/src_int"]},
        "tar_views": {"extrinsics": g["batch/tar_ext"], "intrinsics": g["batch/tar_int"]},
        "near_far": g["batch/near_far"],
    }, device)


def build_renderer(compute_dtype: str, sd):
    from gdb_nerf_tpu_torch.runtime.registry import make_network
    from gdb_nerf_tpu_torch.runtime.renderer import Renderer

    network = make_network(namespace({**DTU_EVAL, "compute_dtype": compute_dtype}))
    network.load_state_dict(sd, strict=True)
    return Renderer(network, "cuda", tf32=False)


def phase_golden(g, sd):
    """Golden render in float32 through the port.  Returns the f32 rgb."""
    renderer = build_renderer("float32", sd)
    kernel = renderer.network.nerf.kernel
    before = kernel.launches
    (ret, _), ms, _ = renderer.render_timed(golden_batch(g, "cuda"))
    rgb = ret["rgb"].cpu().numpy()
    agree = psnr(np.clip(rgb, 0, 1), np.clip(g["golden/rgb"], 0, 1))
    mvs_err = np.abs(ret["mvs_depth"].cpu().numpy() - g["golden/mvs_depth"]).max()
    print(f"[golden] rgb {agree:.2f} dB vs the frozen render; max |d mvs_depth| "
          f"{mvs_err:.3e}; kernel launches {kernel.launches - before}; {ms:.1f} ms")
    if not agree > 40.0:
        raise AssertionError(f"golden render agreement {agree:.2f} dB <= 40 dB")
    np.testing.assert_allclose(ret["mvs_depth"].cpu().numpy(), g["golden/mvs_depth"],
                               rtol=1e-2, atol=1e-2)
    if kernel.launches <= before:
        raise AssertionError("the golden render did not launch the bundle-head kernel")
    return rgb


def phase_serve(g, sd, rgb_f32_golden):
    """5 requests per dtype at 512x640.  Returns the main path's launch count."""
    import torch

    from gdb_nerf_tpu_torch.runtime.renderer import to_device

    batches = synthetic_requests(REQUESTS)
    renderers = {dt: build_renderer(dt, sd) for dt in ("float32", "bfloat16")}
    dev_batches = [to_device(b, "cuda") for b in batches]  # outside the timed region
    torch.cuda.synchronize()
    for r in renderers.values():
        r.network.nerf.kernel.launches = 0
    for dt, r in renderers.items():
        torch.cuda.reset_peak_memory_stats()
        mean_ms, times, enqueues, outs = r.mean_latency_ms(dev_batches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        H, W = batches[0]["src_views"]["rgb"].shape[2:4]
        for ret, _ in outs:
            for k, v in ret.items():
                if not torch.isfinite(v).all():
                    raise AssertionError(f"{dt}: non-finite {k}")
            if tuple(ret["rgb"].shape) != (1, H, W, 3):
                raise AssertionError(f"{dt}: rgb shape {tuple(ret['rgb'].shape)}")
        slabs = r.network.num_chunks(H // 2, W // 2)
        launches = r.network.nerf.kernel.launches
        print(f"[serve] {dt} {H}x{W} x{len(outs)}: mean forward {mean_ms:.2f} ms "
              f"(first excluded; each: {', '.join(f'{t:.2f}' for t in times)} ms; "
              f"host enqueue of each: {', '.join(f'{t:.2f}' for t in enqueues)} ms), "
              f"peak memory {peak:.2f} GiB, kernel launches {launches}")
        if launches != len(outs) * slabs:
            raise AssertionError(f"{dt}: {launches} kernel launches for {len(outs)} requests "
                                 f"x {slabs} slabs")
    launches = sum(r.network.nerf.kernel.launches for r in renderers.values())
    # The enqueue times above mean host time only if the forward never waits
    # for the device: PyTorch raises here on any synchronizing call it makes.
    torch.cuda.set_sync_debug_mode("error")
    try:
        for r in renderers.values():
            r.render(dev_batches[-1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("[serve] no synchronizing call inside the forward (sync debug mode 'error')")
    (ret, _), _, _ = renderers["bfloat16"].render_timed(golden_batch(g, "cuda"))
    rgb16 = ret["rgb"].float().cpu().numpy()
    print(f"[serve] golden batch bf16 vs f32: {psnr(rgb16, rgb_f32_golden):.2f} dB; "
          f"bf16 vs the frozen render: {psnr(np.clip(rgb16, 0, 1), np.clip(g['golden/rgb'], 0, 1)):.2f} dB")
    return launches


def main() -> None:
    import torch

    kernel, plane_kernels, gather_kernels, probe_kernels = phase_device_and_build()
    g, sd = golden_state_dict()

    # Each dtype's head as its network holds it (bf16 weights, sigma float32).
    heads = {getattr(torch, dt): build_renderer(dt, sd).network.nerf
             for dt in ("float32", "bfloat16")}
    k1 = phase_kernel_vs_plain(kernel, heads)
    convs = phase_plane_conv(plane_kernels)
    gathers = phase_gather(gather_kernels)
    probes = phase_plane_ops(probe_kernels)
    rgb = phase_golden(g, sd)
    launches = phase_serve(g, sd, rgb)
    kernels = [{
        "name": "bundle_head", "route": "cuda",
        "source": "gdb_nerf_tpu_torch/csrc/bundle_head.cu",
        "replaces": "gdb_nerf_tpu/ops/pallas/fused_nerf.py:89",
        "launches": launches, **k1,
    }, *convs, *gathers, *probes]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']}: no launch on its path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
