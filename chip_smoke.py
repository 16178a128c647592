"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device and build: the card's name and power limit, then the four CUDA
     libraries (csrc/bundle_head.cu, csrc/plane_conv.cu, csrc/gather.cu,
     csrc/plane_ops.cu) built from this checkout's sources, the nvcc runs
     started together (build seconds, ptxas info);
  2. the bundle-head kernel against its plain PyTorch version on the card
     at the dtu_eval head shapes (N = 245,760 samples, V = 3; V = 2; a
     ragged N) and at the per-scene fine-tune's largest (N = 960,000, the
     NeRF 800x800 frame at S = 6, V = 4; a ragged N at V = 4), in float32
     and bf16, with both times and the bound (V = 3 and V = 4), after a
     check that ptxas spilled nothing in the kernel's build;
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
     launched (counted on a second, untimed render under
     ``tracing.recording()``, so that the timed one runs untraced);
  4. serving: 5 requests in float32 and 5 in bf16 at 512x640 (the synthetic
     loader's scenes, made here) through the Renderer, with finite outputs,
     the mean latency (first request excluded), each request's host enqueue
     time and the peak device memory with tracing off, one kernel launch per
     request and slab on a second, untimed pass,
     and a check that the forward makes no synchronizing call;
  6. training (configs/dtu_pretrain.yaml, float32): (a) 11 steps of the
     port's Trainer at 512x640, B = 4, on the
     synthetic loader, each step's view count, loss and CUDA-event time,
     the peak device memory and the card's name and power limit, then one
     step at V = 4; (b) 20 steps on one 128x160 batch, the last loss below
     the first; (c) Trainer.val after (a) through the bundle-head kernel,
     its launches counted under ``tracing.recording()``, the kernel's pack
     refreshed after the optimizer steps and held to the plain head on the
     trained weights; (d) the evaluate path of ``run --type evaluate`` on 2
     requests from a checkpoint of (a), its launch count read the same way;
     (e) one step at 64x64 on the card against the same step on the CPU
     (loss and every parameter's gradient);
  7. data parallelism (configs/dtu_pretrain.yaml at 512x640, float32, TF32
     off, one fixed batch of B = 4, V = 3 from seeded weights): (a) one step
     in one process, then two ranks of this script on the one card over
     gloo (``--rank-of``, torchrun's environment), each taking the step on
     half the batch, held to the one-process step (loss, every gradient,
     the parameters and BatchNorm statistics after it), with each rank's
     step time, peak memory and the time of its gradient all-reduce alone;
     (b) one step through the same code over nccl in a world of one, held
     the same way (and (a) over nccl, one rank a card, where there are two
     cards); (c) on the same two ranks, ShardedRenderer on the golden batch
     in float32 and bf16, each rank's rows through the bundle-head kernel
     (its launches counted on each rank, on an untimed third render), held
     to the unsharded render,
     with debug_outputs on: the gathered per-bundle sample counts (spb)
     equal to the unsharded ones; (d) on the same two ranks, (a)'s step in
     bf16 on float32 master weights (train/mixed.py) from the same weights
     and halves: the ranks' float32 gradients, parameters and BatchNorm
     statistics equal bit for bit, the master weights float32, the loss
     within PARALLEL_BF16_LOSS_* of (a)'s float32 2-rank loss, each rank's
     step time and peak memory;
  8. the bf16 gate on trained weights, the sampling diagnostics and LPIPS:
     (a) tools/bf16_gate.py's recipe (configs/dtu_pretrain.yaml at 256x320,
     B = 4, V = 3, 3 epochs of 120 steps, float32, TF32 off) through
     bf16_gate.train, deterministic (the same weights on every run on the
     card), with the step time, the peak memory, the losses, which must be
     finite and fall (the last 20 steps' mean below the first 20's), and
     their digest; (b) its checkpoint loaded back and 4 dtu_eval scenes at 512x640
     rendered in float32 and bf16 through the bundle-head kernel
     (bf16_gate.gate; its launches counted in each dtype): the rows, the
     bf16-vs-float32 agreement and the worst PSNR delta against the target,
     which must be <= 0.05 dB; (c) tools/measure_fill.py and
     tools/measure_lod.py on those weights at dtu_eval 512x640, llff_eval
     640x960 and nerf_eval 800x800 in float32, 2 scenes each: spb in
     [1, S] for every bundle, every lod in the histogram; (d) LPIPS with
     seeded VGG16-shaped weights on two of (b)'s renders, the card against
     the CPU, then ``run --type evaluate`` with those weights in its
     workspace and (a)'s checkpoint, which must print a numeric lpips;
  9. bf16 training on float32 master weights (train/mixed.py): (a) the
     recipe of 6a (512x640, B = 4, TRAIN_STEPS steps) in bf16, its step time
     (first excluded) and peak memory beside 6a's float32 numbers; (b)
     OVERFIT_STEPS steps on one 128x160 batch, the last loss below 0.9 of the
     first (the JAX package's rule); (d) Trainer.val of (a) through the
     bf16 head kernel (its launches counted), then the checkpoint of (a)
     (float32 tensors only) loaded into float32 and bf16 Renderers; (c) one
     bf16 step at 64x64 on the card against the CPU's, BatchNorm on running
     statistics, with the card's float32 step as a control that must fail
     (BF16_* bounds); (e)
     tools/measure_train_step.py at 512x640, B = 4, --n 4 in float32 and
     bf16;
  10. the native image decoder (datasets/native.py over csrc/gdbn_io.cpp,
     built with g++): 512x640 RGB and RGBA PNGs written with zlib, a resize,
     a pool of 12 images, a PFM, the decode rate beside cv2's on the same
     files where cv2 imports; a missing prerequisite of the build is printed
     on its own line;
  11. the tools that profile and verify the model, in-process at dtu_eval
     512x640 V = 3 from seeded weights: (a) tools/profile_forward.py in
     float32 (TF32 off) and bf16, each stage's CUDA-event time, host enqueue
     time and time with the stream held, the stages' sum beside the whole
     forward, the bundle-head kernel's launches in the stages' first calls
     (> 0 in each dtype), and the stage chain held to the Renderer's
     forward; (b) tools/profile_encode.py in bf16, its pieces held to
     encode_samples' fields; (c) tools/microbench.py in full; (d)
     tools/roofline.py on (c)'s envelope, its floors beside (a)'s times;
     (e) tools/verify_scene.py on the card with its five checks; (f)
     tools/microbench_loader.py; the phase's seconds and one JSON line of
     the stage table;
  12. the per-scene fine-tune (FINETUNE: configs/dtu/scan114.yaml,
     configs/llff/fern.yaml, configs/nerf/lego.yaml, each read by the port's
     load_cfg at its full width, on the synthetic loader at its protocol
     size), warm-started from 8a's checkpoint: scan114 resumes its own
     directory from it (copied in as <epoch>.pth), fern and lego through
     train.pretrain; per config the evaluator's per-scene PSNR/SSIM with the
     warm-start weights, then train_net's main (before the first step the
     network equals the warm-start file, and the epoch and LR are the
     route's and the schedule's; every loss finite; the last epoch's
     checkpoint written; step time, peak memory), then run --type
     evaluate's main; the bundle-head kernel's launches at V = 4 counted in
     Trainer.val and in evaluate (> 0), and on one V = 4 frame of the
     fine-tuned weights the head stage's inputs through the kernel and the
     plain head in float32 and bf16 (phase 2's tolerances);
  13. tools/measure_frame.py in-process at dtu_eval 512x640, llff_eval
     640x960 and nerf_eval 800x800 in float32 (TF32 off) and bf16, and at
     dtu_eval 1088x1920 in bf16: one JSON line of the rows, the bundle-head
     kernel launched in each;
  14. one JSON line of the training numbers, one of phase 7's, one of phase
     8's, one of phases 9's and 10's, one of phase 12's, one of kernel
     results (the bundle head's with its launches in 6c, 6d, 7c, 8b, 8c, 9d,
     12 and 13), then the JSON result line, or, when the gate of 8b failed,
     the failure.

Needs one CUDA device, nvcc, torch, numpy and PyYAML (phase 12 and the
evaluate runs of 8d read the configs through the port's load_cfg); no
network, and nothing of jax or of the JAX package (gdb_nerf_tpu): the
config literals and the requests below are made here, and
tests/test_torch_port_imports.py holds them equal to the JAX package's
load_cfg and loader and to the port's own.
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
# Phase 8a trains under torch.use_deterministic_algorithms, which needs
# cuBLAS's deterministic workspace from the process's first product on.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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

# The trainer's part of configs/dtu_pretrain.yaml (over the package
# defaults), as load_cfg merges it: every section that the network, the
# trainer, the loader and the evaluator read.  tests/test_torch_port_imports.py
# holds each section equal to load_cfg's.
DTU_PRETRAIN = {
    "network_module": "networks.gdb_nerf.network",
    "evaluator_module": "evaluators.gdb_nerf",
    "compute_dtype": "float32",
    "fpn": DTU_EVAL["fpn"],
    "mvs": DTU_EVAL["mvs"],
    "nerf": {**DTU_EVAL["nerf"], "max_num_samples": 6, "is_adaptive": False},
    "train": {
        "pretrain": "pretrained", "epoch": 300, "num_workers": 4, "collator": "enerf",
        "batch_sampler": "enerf", "shuffle": True, "eps": 1e-08,
        "sampler_meta": {"input_views_num": [2, 3, 4], "input_views_prob": [0.1, 0.8, 0.1],
                         "render_scale": [1.0], "scale_prob": [1.0]},
        "optim": "adam", "lr": 0.0005, "weight_decay": 0.0,
        "scheduler": {"type": "exponential", "milestones": [80, 120, 200, 240], "gamma": 0.5,
                      "decay_epochs": 50},
        "batch_size": 4,
    },
    "test": {
        "batch_size": 1, "collator": "enerf", "epoch": -1, "batch_sampler": "enerf",
        "sampler_meta": {"input_views_num": [3], "input_views_prob": [1.0],
                         "render_scale": [1.0], "scale_prob": [1.0]},
        "eval_depth": False, "eval_center": False,
    },
    "ep_iter": 1000, "log_interval": 1, "eval_lpips": True, "save_result": False,
    "skip_eval": False, "resume": True,
}
TRAIN_STEPS = 11  # phase 6a; the first step is excluded from the step time
OVERFIT_STEPS = 20  # phase 6b
# Phase 6e, one step on the card against the same step on the CPU (float32,
# TF32 off): the loss within 1e-4 relative; each parameter's gradient g
# within 1e-3 relative L2, the tolerances that hold the port's CPU step to
# the JAX package's (tests/test_torch_port_train.py), plus a floor of 1e-6
# of the step's largest gradient element per element: a gradient that
# cancels to near 0 is held in absolute terms.  The head's view-weight
# layer (agg_w_fc) is one: a softmax over views ignores a shift shared by
# all views, and its gradient (1.3e-6 against a largest element of 0.146)
# differs by 6.1e-3 relative, 8.1e-9 absolute (NVIDIA H100 80GB HBM3).  The
# card sums its convolutions and gathers in another order.
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_GRAD_FLOOR = 1e-4, 1e-3, 1e-6


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


def held_to_plain(kernel, head, packed, vox, payload, frd) -> tuple[bool, float, float]:
    """``kernel`` on the pack ``packed`` against bundle_head_reference of
    ``head`` on the same inputs, at the tolerances for the inputs' dtype
    (F32_* or BF16_ATOL).  Returns (within them, max |d sigma|, max |d feat|)."""
    import torch

    from gdb_nerf_tpu_torch.kernels.bundle_head import bundle_head_reference

    with torch.inference_mode():
        sigma, feat = kernel.launch(packed, vox, payload, frd)
        s_ref, f_ref = bundle_head_reference(head, vox, payload, frd)
    err_s = (sigma - s_ref).abs().max().item()
    err_f = (feat.float() - f_ref.float()).abs().max().item()
    if payload.dtype == torch.float32:
        ok = (bool(((sigma - s_ref).abs() <= F32_ATOL + F32_RTOL * s_ref.abs()).all())
              and bool(((feat - f_ref).abs() <= F32_ATOL + F32_RTOL * f_ref.abs()).all()))
    else:
        ok = err_s <= BF16_ATOL and err_f <= BF16_ATOL
    return ok, err_s, err_f


# Phase 2's largest head call: the per-scene fine-tune configurations render
# their test views at V = 4 (configs/{dtu,llff,nerf}/*.yaml), and NeRF's
# 800x800 frame at S = 6 gives the most samples, 400 * 400 * 6.
K1_N_V4 = 400 * 400 * 6


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
    result = {"v4": []}
    n_full = 256 * 320 * 3  # bundles of a 512x640 frame x 3 samples
    for n, V in ((n_full, 3), (n_full, 2), (n_full - 37, 3), (K1_N_V4, 4), (K1_N_V4 - 37, 4)):
        base = (
            torch.randn(n, 8, device="cuda", generator=gen),
            torch.rand(V, n, 31, device="cuda", generator=gen),
            torch.randn(V, n, 23, device="cuda", generator=gen),
        )
        for dt, head in heads.items():
            packed = head.packed_weights()
            vox, payload, frd = (t.to(dt) for t in base)
            ok, err_s, err_f = held_to_plain(kernel, head, packed, vox, payload, frd)
            line = (f"[k1] N={n} V={V} {str(dt)[6:]}: max|dsigma|={err_s:.3e} "
                    f"max|dfeat|={err_f:.3e}")
            if (n == n_full and V == 3) or V == 4:
                with torch.inference_mode():
                    ms = timed_ms(lambda: kernel.launch(packed, vox, payload, frd), dev, 20)
                    plain_ms = timed_ms(lambda: bundle_head_reference(head, vox, payload, frd),
                                        dev, 20)
                line += f" kernel {ms:.4f} ms plain {plain_ms:.4f} ms"
                b_ms, b_by = bound_ms(*work(n, V, dt), dt)
                line += f" bound {b_ms:.4f} ms ({b_by}, {100 * b_ms / ms:.1f} % of it)"
                fields = {"max_abs_err": max(err_s, err_f), "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                          "dtype": str(dt)[6:]}
                if V == 4:
                    result["v4"].append({"n": n, "views": V, **fields})
                elif dt == torch.float32:
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


def build_renderer(compute_dtype: str, sd, debug_outputs: bool = False):
    from gdb_nerf_tpu_torch.models.network import Network
    from gdb_nerf_tpu_torch.runtime.renderer import Renderer

    network = Network.from_config(namespace({**DTU_EVAL, "compute_dtype": compute_dtype}),
                                  debug_outputs=debug_outputs)
    network.load_state_dict(sd, strict=True)
    return Renderer(network, "cuda", tf32=False)


def phase_golden(g, sd):
    """Golden render in float32 through the port.  Returns the f32 rgb."""
    from gdb_nerf_tpu_torch.kernels.bundle_head import LAUNCHES
    from gdb_nerf_tpu_torch.runtime import tracing

    renderer = build_renderer("float32", sd)
    batch = golden_batch(g, "cuda")
    (ret, _), ms, _ = renderer.render_timed(batch)
    with tracing.recording() as rec:  # an untimed render: the timed one runs untraced
        renderer.render(batch)
    launches = rec.counter(LAUNCHES)
    rgb = ret["rgb"].cpu().numpy()
    agree = psnr(np.clip(rgb, 0, 1), np.clip(g["golden/rgb"], 0, 1))
    mvs_err = np.abs(ret["mvs_depth"].cpu().numpy() - g["golden/mvs_depth"]).max()
    print(f"[golden] rgb {agree:.2f} dB vs the frozen render; max |d mvs_depth| "
          f"{mvs_err:.3e}; kernel launches {launches}; {ms:.1f} ms")
    if not agree > 40.0:
        raise AssertionError(f"golden render agreement {agree:.2f} dB <= 40 dB")
    np.testing.assert_allclose(ret["mvs_depth"].cpu().numpy(), g["golden/mvs_depth"],
                               rtol=1e-2, atol=1e-2)
    if launches <= 0:
        raise AssertionError("the golden render did not launch the bundle-head kernel")
    return rgb


def phase_serve(g, sd, rgb_f32_golden):
    """5 requests per dtype at 512x640.  Returns the main path's launch count."""
    import torch

    from gdb_nerf_tpu_torch.kernels.bundle_head import LAUNCHES
    from gdb_nerf_tpu_torch.runtime import tracing
    from gdb_nerf_tpu_torch.runtime.renderer import to_device

    batches = synthetic_requests(REQUESTS)
    renderers = {dt: build_renderer(dt, sd) for dt in ("float32", "bfloat16")}
    dev_batches = [to_device(b, "cuda") for b in batches]  # outside the timed region
    torch.cuda.synchronize()
    total = 0
    for dt, r in renderers.items():
        torch.cuda.reset_peak_memory_stats()
        mean_ms, times, enqueues, outs = r.mean_latency_ms(dev_batches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        with tracing.recording() as rec:  # an untimed pass: the timed one runs untraced
            for b in dev_batches:
                r.render(b)
        H, W = batches[0]["src_views"]["rgb"].shape[2:4]
        for ret, _ in outs:
            for k, v in ret.items():
                if not torch.isfinite(v).all():
                    raise AssertionError(f"{dt}: non-finite {k}")
            if tuple(ret["rgb"].shape) != (1, H, W, 3):
                raise AssertionError(f"{dt}: rgb shape {tuple(ret['rgb'].shape)}")
        slabs = r.network.num_chunks(H // 2, W // 2)
        launches = rec.counter(LAUNCHES)
        total += launches
        print(f"[serve] {dt} {H}x{W} x{len(outs)}: mean forward {mean_ms:.2f} ms "
              f"(first excluded; each: {', '.join(f'{t:.2f}' for t in times)} ms; "
              f"host enqueue of each: {', '.join(f'{t:.2f}' for t in enqueues)} ms), "
              f"peak memory {peak:.2f} GiB, kernel launches {launches} (an untimed pass)")
        if launches != len(dev_batches) * slabs:
            raise AssertionError(f"{dt}: {launches} kernel launches for {len(dev_batches)} requests "
                                 f"x {slabs} slabs")
    launches = total
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


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def train_cfg(hw, batch_size: int, ep_iter: int, dtype: str = "float32") -> SimpleNamespace:
    """DTU_PRETRAIN on the synthetic loader at ``hw`` in compute dtype
    ``dtype``, with its run directories under build/."""
    build = os.path.join(REPO, "build", "smoke_train" if dtype == "float32" else f"smoke_train_{dtype}")
    return namespace({
        **DTU_PRETRAIN, "compute_dtype": dtype,
        "train": {**DTU_PRETRAIN["train"], "batch_size": batch_size},
        "ep_iter": ep_iter, "synthetic": True, "synthetic_hw": list(hw),
        "train_dataset": {"split": "train"}, "test_dataset": {"split": "test"},
        "record_dir": os.path.join(build, "record"), "result_dir": os.path.join(build, "result"),
        "trained_model_dir": os.path.join(build, "trained_model"), "device": "cuda",
    })


def make_trainer(cfg, device="cuda", state=None, group=None):
    """A trainer of a network initialized from torch's generator seeded
    with 0 (or loaded with ``state``), data-parallel over ``group``."""
    import torch

    from gdb_nerf_tpu_torch.runtime.registry import make_network
    from gdb_nerf_tpu_torch.train.trainer import Trainer

    torch.manual_seed(0)
    network = make_network(cfg, torch.float32)
    if state is not None:
        network.load_state_dict(state, strict=True)
    return Trainer(cfg, network, device, group=group)


class ViewLog:
    """A loader that notes each batch's view count."""

    def __init__(self, loader):
        self.loader, self.views = loader, []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            self.views.append(batch["src_views"]["rgb"].shape[1])
            yield batch


def phase_train_recipe():
    """6a. The dtu_pretrain recipe: TRAIN_STEPS trainer steps at 512x640, B = 4,
    on the synthetic loader (23.87 GiB at its peak on an 80 GB H100);
    then one step of the worst case, V = 4.  Returns the trainer, its
    config, its head's pack before training, and the numbers."""
    import torch

    from gdb_nerf_tpu_torch.datasets import make_data_loader
    from gdb_nerf_tpu_torch.datasets.loader import collate
    from gdb_nerf_tpu_torch.train.recorder import Recorder

    B = DTU_PRETRAIN["train"]["batch_size"]
    cfg = train_cfg((512, 640), B, TRAIN_STEPS)
    trainer = make_trainer(cfg)
    packed_before = trainer.network.nerf.packed_weights().clone()
    recorder = Recorder(cfg)
    loader = make_data_loader(cfg, is_train=True, max_iter=TRAIN_STEPS)
    views = ViewLog(loader)
    torch.cuda.reset_peak_memory_stats()
    trainer.train_epoch(0, views, recorder)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = list(recorder.loss_stats["loss"].deque)
    ms = list(trainer.step_ms)
    smi = card()
    for k, (loss, t, v) in enumerate(zip(losses, ms, views.views)):
        print(f"[train] step {k}: V={v}, loss {loss:.6f}, {t:.2f} ms (CUDA events)")
    timed = ms[1:]
    print(f"[train] dtu_pretrain 512x640 B={B} float32, {len(ms)} steps: mean step "
          f"{sum(timed) / len(timed):.2f} ms (first excluded; min {min(timed):.2f}, max "
          f"{max(timed):.2f}), peak memory {peak:.2f} GiB "
          f"(torch.cuda.max_memory_allocated) on {smi}")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"train steps: {losses}")
    ds = loader.dataset
    if len(views.views) != len(ms):
        raise AssertionError(f"{len(views.views)} batches for {len(ms)} steps")
    torch.cuda.reset_peak_memory_stats()
    stats = trainer.train_step(collate([ds[(i, 4, 1.0)] for i in range(B)]))
    peak_v4 = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train] one step at V=4 (the sampler's largest view count), B={B}: "
          f"{trainer.step_ms[-1]:.2f} ms, loss {stats['loss']:.6f}, peak memory {peak_v4:.2f} GiB")
    if not np.isfinite(stats["loss"]):
        raise AssertionError("non-finite loss at V=4")
    return trainer, cfg, packed_before, {
        "batch_size": B, "steps": len(ms), "step_ms": timed, "peak_gib": peak,
        "peak_gib_v4": peak_v4, "card": smi}


def phase_overfit():
    """6b. OVERFIT_STEPS steps on one 128x160 batch: the loss must fall."""
    from gdb_nerf_tpu_torch.datasets import make_data_loader

    cfg = train_cfg((128, 160), 4, OVERFIT_STEPS)
    trainer = make_trainer(cfg)
    batch = next(iter(make_data_loader(cfg, is_train=True, max_iter=1)))
    losses = [trainer.train_step(batch)["loss"] for _ in range(OVERFIT_STEPS)]
    print(f"[overfit] 128x160 B=4, {OVERFIT_STEPS} steps on one batch: loss "
          + " ".join(f"{x:.5f}" for x in losses))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"overfitting one batch did not lower the loss: {losses}")


def phase_train_vs_cpu():
    """6e. One step at 64x64 on the card and the same step on the CPU, from
    the same weights and batch: the loss and every parameter's gradient."""
    from gdb_nerf_tpu_torch.datasets import make_data_loader

    cfg = train_cfg((64, 64), 1, 1)
    gpu = make_trainer(cfg)
    cpu = make_trainer(cfg, "cpu", {k: v.cpu() for k, v in gpu.network.state_dict().items()})
    batch = next(iter(make_data_loader(cfg, is_train=True, max_iter=1)))
    loss_gpu, loss_cpu = gpu.train_step(batch)["loss"], cpu.train_step(batch)["loss"]
    if not next(gpu.network.parameters()).is_cuda or next(cpu.network.parameters()).is_cuda:
        raise AssertionError("the two trainers are not on the card and the CPU")
    gmax = max(float(q.grad.abs().max()) for q in cpu.network.parameters())
    rows = []  # (share of the tolerance, relative L2, name, |g|)
    for (k, p), q in zip(gpu.network.named_parameters(), cpu.network.parameters()):
        a, b = p.grad.double().cpu(), q.grad.double()
        d, g = float((a - b).norm()), float(b.norm())
        tol = TRAIN_GRAD_RTOL * g + TRAIN_GRAD_FLOOR * gmax * b.numel() ** 0.5
        rows.append((d / tol, d / max(g, 1e-30), k, g))
    rows.sort()
    for share, rel, k, g in rows[-3:]:
        print(f"[train-vs-cpu] {k}: gradient relative L2 {rel:.3e} (|g| {g:.3e}), "
              f"{100 * share:.1f} % of its tolerance")
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    worst = max(r[1] for r in rows)
    print(f"[train-vs-cpu] 64x64 B=1 float32 TF32 off: loss card {loss_gpu:.8f} cpu "
          f"{loss_cpu:.8f} (relative {loss_err:.2e}, tolerance {TRAIN_LOSS_RTOL}); "
          f"{len(rows)} gradients, worst relative L2 {worst:.2e}, the largest element "
          f"{gmax:.3e}; every one within {TRAIN_GRAD_RTOL} relative L2 + {TRAIN_GRAD_FLOOR} "
          f"of the largest element: {rows[-1][0] <= 1.0}")
    if loss_err > TRAIN_LOSS_RTOL or rows[-1][0] > 1.0:
        raise AssertionError("the card's train step disagrees with the CPU's")


def phase_val(trainer, cfg, packed_before):
    """6c. Trainer.val after 6a, through the bundle-head kernel, with its
    launches counted under ``tracing.recording()``; the head's pack refreshed
    after the optimizer steps, and the kernel on the trained weights held to
    the plain head at the first val request's inputs.  Returns the launches."""
    import torch

    from gdb_nerf_tpu_torch.datasets import make_data_loader
    from gdb_nerf_tpu_torch.kernels.bundle_head import LAUNCHES, pack_weights
    from gdb_nerf_tpu_torch.runtime import tracing
    from gdb_nerf_tpu_torch.runtime.registry import make_evaluator

    head = trainer.network.nerf
    inputs = []
    hook = head.register_forward_pre_hook(lambda m, args: inputs.append(args[:3]) or None)
    loader = make_data_loader(cfg, is_train=False)
    with tracing.recording() as rec:
        result = trainer.val(0, loader, make_evaluator(cfg))
    launches = rec.counter(LAUNCHES)
    hook.remove()
    print(f"[val] {len(loader)} requests at 512x640 after training: psnr {result['psnr']:.3f}, "
          f"ssim {result['ssim']:.4f}; bundle-head kernel launches {launches}")
    if launches != len(inputs) or launches < len(loader) or not np.isfinite(result["psnr"]):
        raise AssertionError(f"val: {launches} launches for {len(inputs)} head calls, {result}")
    if not trainer.network.training:
        raise AssertionError("val left the network in eval mode")
    packed = head.packed_weights()
    if torch.equal(packed, packed_before) or not torch.equal(packed, pack_weights(head)):
        raise AssertionError("the head's kernel pack did not follow the optimizer steps")
    vox, payload, frd = inputs[0]
    ok, *errs = held_to_plain(head.kernel, head, packed, vox, payload, frd)
    err = max(errs)
    print(f"[val] kernel on the trained weights vs the plain head, N={vox.shape[0]}: max |d| "
          f"{err:.3e} (atol {F32_ATOL}, rtol {F32_RTOL}); pack refreshed after the steps")
    if not ok:
        raise AssertionError("bundle-head kernel disagrees with the plain head on trained weights")
    return launches


def phase_evaluate(trainer, cfg):
    """6d. run --type evaluate's path on 2 synthetic requests at 512x640,
    from a checkpoint of the trained network.  Returns the kernel launches."""
    from gdb_nerf_tpu_torch import run
    from gdb_nerf_tpu_torch.datasets import samplers, synthetic
    from gdb_nerf_tpu_torch.datasets.loader import DataLoader
    from gdb_nerf_tpu_torch.kernels.bundle_head import LAUNCHES
    from gdb_nerf_tpu_torch.runtime import tracing
    from gdb_nerf_tpu_torch.utils.checkpoint import save_model

    save_model(trainer.state_dict(), cfg.trained_model_dir, 0, last=True)
    renderer = run.build_renderer(cfg)
    requests = DataLoader(synthetic.Dataset(cfg, split="test", num_items=2),
                          samplers.EnerfBatchSampler(samplers.SequentialSampler(2), 1, False,
                                                     cfg.test.sampler_meta), num_workers=0)
    with tracing.recording() as rec:
        result = run.evaluate(cfg, renderer, requests)
    launches = rec.counter(LAUNCHES)
    print(f"[evaluate] 2 requests: {result}; bundle-head kernel launches {launches}")
    if launches != 2 or not np.isfinite(result["psnr"]):
        raise AssertionError(f"evaluate: {launches} launches, {result}")
    return launches


# Phase 7: the data-parallel step and the row-sharded render.  7a holds
# the 2-rank step to the one-process step with phase 6e's rule, but with
# the FPN's and the cost-regularization U-Nets' gradients (PARALLEL_SENSITIVE)
# at PARALLEL_SENSITIVE_RTOL: they move with the order of float32 sums alone
# (the CPU's 64x64 case, 2 threads against 1: 2.1e-2,
# tests/test_torch_port_parallel.py), grid_sample's backward adds its
# atomics in no fixed order, and the FPN's first layers came 8.7e-4 apart,
# 84 % of 1e-3, in a run on an NVIDIA H100 80GB HBM3.  The loss within
# PARALLEL_LOSS_RTOL relative; at most PARALLEL_PARAMS_APART of the
# parameters' elements more than 1e-6 from the other's after the step:
# adam's first step moves an element by about lr * sign(g), so an element
# whose gradient lies below the two runs' rounding difference lands 2 lr
# away (0.82-1.17 % of them in runs on an NVIDIA H100 80GB HBM3), while a
# step at another LR moves every element whose gradient is above adam's eps;
# the BatchNorm statistics within PARALLEL_BN_ATOL.  7c holds the float32 render within
# SHARDED_F32_ATOL of the unsharded one (tests/test_sharded_infer.py's bound)
# (absolute and relative, as np.testing.assert_allclose there) and bf16 at
# SHARDED_BF16_DB or more.
PARALLEL_WORLD = 2
PARALLEL_BATCH, PARALLEL_VIEWS = 4, 3
PARALLEL_SENSITIVE, PARALLEL_SENSITIVE_RTOL = ("feature_net.", "depth_net.cost_regs."), 1e-2
PARALLEL_LOSS_RTOL, PARALLEL_BN_ATOL = 1e-5, 1e-5
PARALLEL_PARAMS_APART = 0.03
SHARDED_F32_ATOL, SHARDED_BF16_DB = 1e-5, 60.0
# 7d: the bf16 2-rank step's loss against the float32 2-rank step's, the
# bf16 bound of tests/test_torch_port_train.py (as the CPU's 2-rank test).
PARALLEL_BF16_LOSS_RTOL, PARALLEL_BF16_LOSS_ATOL = 5e-3, 1e-3
PARALLEL_TIMEOUT = 600  # seconds for the ranks of one launch


def parallel_dir() -> str:
    return os.path.join(REPO, "build", "smoke_parallel")


def items(tree, sl):
    """The items ``sl`` of every array of a loader batch (other leaves as
    they are)."""
    if isinstance(tree, dict):
        return {k: items(v, sl) for k, v in tree.items()}
    if isinstance(tree, list):
        return [items(v, sl) for v in tree]
    return tree[sl] if isinstance(tree, np.ndarray) and tree.ndim else tree


def step_record(trainer, stats) -> dict:
    """What phase 7 compares of a trainer after one step, on the host."""
    import torch

    return {"stats": stats, "ms": trainer.step_ms[-1],
            "peak_gib": torch.cuda.max_memory_allocated(trainer.device) / 2**30,
            "grads": {k: p.grad.detach().cpu() for k, p in trainer.network.named_parameters()},
            "state": {k: v.detach().cpu() for k, v in trainer.network.state_dict().items()}}


def free_cuda() -> None:
    """Return the cached blocks of what the caller has deleted to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_parallel_single():
    """7a, first: one step of one process at dtu_pretrain 512x640, B = 4,
    V = 3, from seeded weights on one fixed batch of the synthetic loader;
    the weights and the batch are written for the ranks.  Returns the
    step's record."""
    import torch

    from gdb_nerf_tpu_torch.datasets import make_data_loader
    from gdb_nerf_tpu_torch.datasets.loader import collate

    cfg = train_cfg((512, 640), PARALLEL_BATCH, 1)
    trainer = make_trainer(cfg)
    ds = make_data_loader(cfg, is_train=True, max_iter=1).dataset
    batch = collate([ds[(i, PARALLEL_VIEWS, 1.0)] for i in range(PARALLEL_BATCH)])
    os.makedirs(parallel_dir(), exist_ok=True)
    torch.save({"state": {k: v.detach().cpu() for k, v in trainer.network.state_dict().items()},
                "batch": batch}, os.path.join(parallel_dir(), "case.pt"))
    torch.cuda.reset_peak_memory_stats()
    record = step_record(trainer, trainer.train_step(batch))
    print(f"[parallel] one process, B={PARALLEL_BATCH} V={PARALLEL_VIEWS} 512x640: loss "
          f"{record['stats']['loss']:.8f}, {record['ms']:.2f} ms, "
          f"peak {record['peak_gib']:.2f} GiB")
    del trainer
    free_cuda()
    return record


def rank_main(out_dir: str) -> None:
    """One rank of phase 7, started by ``spawn_ranks`` with torchrun's
    environment: 7a's step on this rank's half of the batch and the time of
    its gradient all-reduce alone, then 7c's sharded render of the golden
    batch in float32 and bf16 with the bundle-head kernel's launches."""
    import torch
    import torch.distributed as dist

    from gdb_nerf_tpu_torch.kernels.bundle_head import LAUNCHES
    from gdb_nerf_tpu_torch.models.network import Network
    from gdb_nerf_tpu_torch.parallel import ShardedRenderer, hosts
    from gdb_nerf_tpu_torch.parallel.collectives import all_reduce_mean_
    from gdb_nerf_tpu_torch.runtime import tracing

    device = hosts.maybe_initialize_distributed("cuda")
    group, rank = hosts.default_group(), hosts.rank()
    out = {"device": str(device), "backend": dist.get_backend(group)}
    case = torch.load(os.path.join(parallel_dir(), "case.pt"), weights_only=False)
    share = PARALLEL_BATCH // PARALLEL_WORLD
    cfg = train_cfg((512, 640), share, 1)
    trainer = make_trainer(cfg, device, case["state"], group)
    torch.cuda.reset_peak_memory_stats(device)
    half = items(case["batch"], slice(rank * share, (rank + 1) * share))
    out["step"] = step_record(trainer, trainer.train_step(half))
    grads = [p.grad.clone() for p in trainer.network.parameters()]
    trainer.train_step(half)  # warm: the first step of a process loads its kernels
    out["warm_ms"] = trainer.step_ms[-1]
    times = []  # host clock between two syncs: gloo waits on the host
    for _ in range(5):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        all_reduce_mean_(grads, group)
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    out["allreduce_ms"] = times
    out["allreduce_numel"] = sum(g.numel() for g in grads)
    del trainer, grads
    free_cuda()
    # 7d: the same step in bf16 on float32 master weights, from the same
    # weights on the same half.
    trainer = make_trainer(train_cfg((512, 640), share, 1, "bfloat16"), device, case["state"],
                           group)
    torch.cuda.reset_peak_memory_stats(device)
    out["step_bf16"] = step_record(trainer, trainer.train_step(half))
    out["step_bf16"]["master_dtypes"] = sorted({str(p.dtype) for p in trainer.network.parameters()})
    out["step_bf16"]["compute_dtype"] = str(trainer.mixed.compute.compute_dtype)
    trainer.train_step(half)
    out["step_bf16"]["warm_ms"] = trainer.step_ms[-1]
    del trainer
    free_cuda()
    g, sd = golden_state_dict()
    out["render"] = {}
    for dt in ("float32", "bfloat16"):
        network = Network.from_config(namespace({**DTU_EVAL, "compute_dtype": dt}),
                                      debug_outputs=True)
        network.load_state_dict(sd, strict=True)
        renderer = ShardedRenderer(network, device, group)
        batch = golden_batch(g, device)
        (ret, _), first_ms, _ = renderer.render_timed(batch)
        _, ms, _ = renderer.render_timed(batch)
        with tracing.recording() as rec:  # an untimed render: the timed ones run untraced
            renderer.render(batch)
        out["render"][dt] = {"ret": {k: v.cpu() for k, v in ret.items()}, "ms": ms,
                             "first_ms": first_ms, "launches": rec.counter(LAUNCHES)}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    hosts.shutdown()


def spawn_ranks(tag: str, visible: str | None) -> list:
    """Start PARALLEL_WORLD ranks of this script (``--rank-of``) with
    torchrun's environment on one host, wait for all, print their output,
    and return their records; fails if any rank fails.  ``visible`` sets
    CUDA_VISIBLE_DEVICES (one card for all ranks: gloo)."""
    import torch

    out_dir = os.path.join(parallel_dir(), tag)
    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    procs = []
    try:
        for rank in range(PARALLEL_WORLD):
            env = {**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                   "WORLD_SIZE": str(PARALLEL_WORLD), "RANK": str(rank), "LOCAL_RANK": str(rank),
                   "LOCAL_WORLD_SIZE": str(PARALLEL_WORLD)}
            if visible is not None:
                env["CUDA_VISIBLE_DEVICES"] = visible
            log = open(os.path.join(out_dir, f"rank{rank}.log"), "w")
            procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                            "--rank-of", out_dir], env=env, stdout=log,
                                           stderr=subprocess.STDOUT), log))
        deadline = time.time() + PARALLEL_TIMEOUT
        codes = []
        for proc, _ in procs:
            try:
                codes.append(proc.wait(timeout=max(deadline - time.time(), 1)))
            except subprocess.TimeoutExpired:
                codes.append("timeout")
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for rank in range(PARALLEL_WORLD):
        with open(os.path.join(out_dir, f"rank{rank}.log")) as f:
            for line in f.read().splitlines()[-40:]:
                print(f"[{tag} rank {rank}] {line}")
    if codes != [0] * PARALLEL_WORLD:
        raise AssertionError(f"phase 7 {tag}: the ranks exited with {codes}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(PARALLEL_WORLD)]


def compare_steps(label: str, got: dict, want: dict) -> dict:
    """Phase 6e's rule on the gradients (PARALLEL_SENSITIVE's at
    PARALLEL_SENSITIVE_RTOL), the loss within PARALLEL_LOSS_RTOL, at most
    PARALLEL_PARAMS_APART of the parameters' elements more than 1e-6 apart
    after the step and the BatchNorm statistics within PARALLEL_BN_ATOL.
    Returns the worst numbers; fails past any bound."""
    import torch

    loss_err = abs(got["stats"]["loss"] - want["stats"]["loss"]) / abs(want["stats"]["loss"])
    gmax = max(float(g.abs().max()) for g in want["grads"].values())
    rows = []  # (share of the tolerance, relative L2, name)
    for k, b in want["grads"].items():
        a, b = got["grads"][k].double(), b.double()
        d, n = float((a - b).norm()), float(b.norm())
        rtol = PARALLEL_SENSITIVE_RTOL if k.startswith(PARALLEL_SENSITIVE) else TRAIN_GRAD_RTOL
        rows.append((d / (rtol * n + TRAIN_GRAD_FLOOR * gmax * b.numel() ** 0.5),
                     d / max(n, 1e-30), k))
    rows.sort()
    param_err, moved, total, bn_err = 0.0, 0, 0, 0.0
    for k, b in want["state"].items():
        a = got["state"][k]
        if k in want["grads"]:
            diff = (a.double() - b.double()).abs()
            param_err = max(param_err, float(diff.max()))
            moved, total = moved + int((diff > 1e-6).sum()), total + diff.numel()
        elif b.is_floating_point():
            bn_err = max(bn_err, float((a - b).abs().max()))
        elif not torch.equal(a, b):
            raise AssertionError(f"{label}: {k} differs")
    for share, rel, k in rows[-3:]:
        print(f"[parallel] {label}: {k} gradient relative L2 {rel:.2e}, "
              f"{100 * share:.1f} % of its tolerance")
    print(f"[parallel] {label}: loss {got['stats']['loss']:.8f} against "
          f"{want['stats']['loss']:.8f} (relative {loss_err:.2e}); parameters after the step: "
          f"{moved} of {total} more than 1e-6 apart ({100 * moved / total:.3f} %, bound "
          f"{100 * PARALLEL_PARAMS_APART:.0f} %), within {param_err:.2e}; BatchNorm "
          f"statistics within {bn_err:.2e}")
    if (loss_err > PARALLEL_LOSS_RTOL or rows[-1][0] > 1.0
            or moved > PARALLEL_PARAMS_APART * total or bn_err > PARALLEL_BN_ATOL):
        raise AssertionError(f"{label}: the data-parallel step disagrees with one process")
    return {"loss_rel_err": loss_err, "worst_grad_share": rows[-1][0],
            "worst_grad_rel_l2": rows[-1][1], "worst_grad": rows[-1][2],
            "param_max_abs": param_err, "params_apart": moved, "bn_abs_err": bn_err}


def compare_bf16_ranks(ranks) -> dict:
    """7d. The two ranks' bf16 steps on float32 master weights (the rules of
    tests/test_torch_port_parallel.py::test_two_rank_bf16_step_takes_one_float32_update):
    their float32 gradients, parameters and BatchNorm statistics equal bit
    for bit, the master weights float32, the loss within PARALLEL_BF16_LOSS_RTOL
    relative (+ PARALLEL_BF16_LOSS_ATOL) of the float32 2-rank step's."""
    import torch

    a, b = (r["step_bf16"] for r in ranks)
    for k, g in a["grads"].items():
        if g.dtype != torch.float32 or not torch.equal(g, b["grads"][k]):
            raise AssertionError(f"7d: the ranks' bf16-step gradients differ at {k} ({g.dtype})")
    for k, v in a["state"].items():
        if not torch.equal(v, b["state"][k]):
            raise AssertionError(f"7d: the ranks differ after the bf16 step at {k}")
        if v.is_floating_point() and v.dtype != torch.float32:
            raise AssertionError(f"7d: {k} is {v.dtype} after the bf16 step, not float32")
    loss32, loss16 = ranks[0]["step"]["stats"]["loss"], a["stats"]["loss"]
    bound = PARALLEL_BF16_LOSS_RTOL * abs(loss32) + PARALLEL_BF16_LOSS_ATOL
    for rank, r in enumerate(ranks):
        s = r["step_bf16"]
        print(f"[parallel] 7d rank {rank} bf16 ({s['compute_dtype']}) on master weights "
              f"{s['master_dtypes']}: step {s['ms']:.2f} ms (CUDA events; the first bf16 step), "
              f"a second step {s['warm_ms']:.2f} ms, peak memory {s['peak_gib']:.2f} GiB")
    print(f"[parallel] 7d 2 gloo ranks bf16: gradients, parameters and BatchNorm statistics equal "
          f"bit for bit on both ranks, all float32; loss {loss16:.8f} against the float32 2-rank "
          f"step's {loss32:.8f} (|d| {abs(loss16 - loss32):.2e}, bound {bound:.2e})")
    if a["master_dtypes"] != ["torch.float32"] or abs(loss16 - loss32) > bound:
        raise AssertionError(f"7d: master weights {a['master_dtypes']}, loss {loss16} against "
                             f"{loss32}")
    return {"loss": loss16, "loss_float32": loss32, "loss_abs_err": abs(loss16 - loss32),
            "loss_bound": bound, "rank_step_ms": [r["step_bf16"]["ms"] for r in ranks],
            "rank_warm_step_ms": [r["step_bf16"]["warm_ms"] for r in ranks],
            "rank_peak_gib": [r["step_bf16"]["peak_gib"] for r in ranks]}


def phase_parallel(single: dict) -> dict:
    """7a: two gloo ranks on one card, each half of the batch, against the
    one-process step; 7b: one step through the same code over nccl in a
    world of one (and 7a over nccl, a rank a card, where there are two
    cards); 7c: the sharded render against the unsharded one, through the
    bundle-head kernel on every rank.  Returns the numbers."""
    import torch
    import torch.distributed as dist

    from gdb_nerf_tpu_torch.parallel import hosts

    t0 = time.time()
    ranks = spawn_ranks("gloo", visible="0")
    result = {"card": card(), "world": PARALLEL_WORLD, "backend": ranks[0]["backend"]}
    if {r["backend"] for r in ranks} != {"gloo"} or {r["device"] for r in ranks} != {"cuda:0"}:
        raise AssertionError(f"7a: ranks on {[(r['backend'], r['device']) for r in ranks]}")
    for rank, r in enumerate(ranks):
        ar = sorted(r["allreduce_ms"])
        print(f"[parallel] 7a rank {rank} ({r['backend']}, {r['device']}): step "
              f"{r['step']['ms']:.2f} ms (CUDA events; the process's first), a second step "
              f"{r['warm_ms']:.2f} ms, peak memory {r['step']['peak_gib']:.2f} GiB; "
              f"gradient all-reduce alone ({r['allreduce_numel']} floats) median "
              f"{ar[len(ar) // 2]:.2f} ms (min {ar[0]:.2f}, max {ar[-1]:.2f})")
    for k, v in ranks[0]["step"]["state"].items():
        if not torch.equal(v, ranks[1]["step"]["state"][k]):
            raise AssertionError(f"7a: the replicas differ after the step at {k}")
    result["gloo"] = compare_steps("7a 2 gloo ranks on one card vs one process",
                                   ranks[0]["step"], single)
    result["rank_step_ms"] = [r["step"]["ms"] for r in ranks]
    result["rank_warm_step_ms"] = [r["warm_ms"] for r in ranks]
    result["rank_peak_gib"] = [r["step"]["peak_gib"] for r in ranks]
    result["allreduce_ms"] = [sorted(r["allreduce_ms"])[2] for r in ranks]
    result["single_step_ms"], result["single_peak_gib"] = single["ms"], single["peak_gib"]
    result["bf16"] = compare_bf16_ranks(ranks)

    g, sd = golden_state_dict()
    launches = []
    for dt in ("float32", "bfloat16"):
        renderer = build_renderer(dt, sd, debug_outputs=True)
        (want, _), _, _ = renderer.render_timed(golden_batch(g, "cuda"))
        _, want_ms, _ = renderer.render_timed(golden_batch(g, "cuda"))
        for rank, r in enumerate(ranks):
            got = r["render"][dt]
            if got["launches"] <= 0:
                raise AssertionError(f"7c {dt}: rank {rank} never launched the bundle-head kernel")
            if dt == "float32":
                ok, shown = True, []
                for k in ("rgb", "nerf_depth", "opacity", "mvs_depth"):
                    a, b = got["ret"][k], want[k].float().cpu()
                    ok &= bool(((a - b).abs() <= SHARDED_F32_ATOL * (1 + b.abs())).all())
                    shown.append(f"{k} max |d| {float((a - b).abs().max()):.3e}")
                shown = (", ".join(shown) + f" (atol = rtol = {SHARDED_F32_ATOL})")
            else:
                db = psnr(got["ret"]["rgb"].numpy(), want["rgb"].float().cpu().numpy())
                ok, shown = db >= SHARDED_BF16_DB, f"rgb {db:.2f} dB (>= {SHARDED_BF16_DB})"
            spb = got["ret"]["spb"]
            spb_equal = spb.dtype == torch.int32 and torch.equal(spb, want["spb"].cpu())
            ok &= spb_equal
            print(f"[parallel] 7c {dt} rank {rank}: sharded render of the golden batch "
                  f"(128 of 256 bundle rows) {got['ms']:.2f} ms (the first {got['first_ms']:.2f}), "
                  f"unsharded {want_ms:.2f} ms; against the unsharded render {shown}; spb "
                  f"{'equal' if spb_equal else 'DIFFERS'} (mean {float(spb.float().mean()):.4f} "
                  f"of {DTU_EVAL['nerf']['max_num_samples']}); bundle-head kernel launches "
                  f"{got['launches']} (one untimed render)")
            if not ok:
                raise AssertionError(f"7c {dt}: rank {rank}'s render disagrees: {shown}")
        launches.append([r["render"][dt]["launches"] for r in ranks])
        result[f"sharded_ms_{dt}"] = [r["render"][dt]["ms"] for r in ranks]
        result[f"unsharded_ms_{dt}"] = want_ms
        del renderer, want
        free_cuda()
    result["launches_sharded"] = [sum(ls) for ls in zip(*launches)]

    device = hosts.maybe_initialize_distributed("cuda", env={
        "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{free_port()}", "JAX_NUM_PROCESSES": "1",
        "JAX_PROCESS_ID": "0"})
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"7b: backend {dist.get_backend()}, not nccl")
        case = torch.load(os.path.join(parallel_dir(), "case.pt"), weights_only=False)
        trainer = make_trainer(train_cfg((512, 640), PARALLEL_BATCH, 1), device, case["state"],
                               dist.group.WORLD)
        torch.cuda.reset_peak_memory_stats()
        nccl = step_record(trainer, trainer.train_step(case["batch"]))
        trainer.train_step(case["batch"])  # warm: the first one sets up the communicator
        nccl["warm_ms"] = trainer.step_ms[-1]
        del trainer
        free_cuda()
    finally:
        hosts.shutdown()
    print(f"[parallel] 7b nccl, a world of one on {device}: {nccl['ms']:.2f} ms (the first "
          f"step), a second step {nccl['warm_ms']:.2f} ms, peak {nccl['peak_gib']:.2f} GiB")
    result["nccl_world_1"] = compare_steps("7b nccl world of one vs one process", nccl, single)
    result["nccl_world_1"].update(step_ms=nccl["ms"], warm_step_ms=nccl["warm_ms"],
                                  peak_gib=nccl["peak_gib"])
    if torch.cuda.device_count() >= PARALLEL_WORLD:
        ranks = spawn_ranks("nccl", visible=None)
        if {r["backend"] for r in ranks} != {"nccl"}:
            raise AssertionError(f"7b: ranks over {[r['backend'] for r in ranks]}, not nccl")
        result["nccl"] = compare_steps("7b 2 nccl ranks, one a card, vs one process",
                                       ranks[0]["step"], single)
    else:
        print(f"[parallel] 7b: {torch.cuda.device_count()} card on this machine; 7a over nccl "
              f"with one rank a card needs {PARALLEL_WORLD}: not run")
    print(f"[parallel] phase 7 took {time.time() - t0:.1f} s")
    return result


# Phase 8: the bf16 gate on trained weights (tools/bf16_gate.py's recipe,
# PARITY.md's: dtu_pretrain at 256x320, B = 4, V = 3, 3 epochs of 120 steps,
# float32, TF32 off, from weights initialized from seed 0, deterministic), the sampling
# diagnostics on those weights, and LPIPS.  The gate's bar is
# bf16_gate.GATE_BAR (0.05 dB) over GATE_SCENES dtu_eval scenes at 512x640.
# The card's LPIPS is held to the CPU's within LPIPS_RTOL relative (float32,
# TF32 off on both).
GATE_HW, GATE_EPOCHS, GATE_EP_ITER, GATE_VIEWS = (256, 320), 3, 120, 3
GATE_SCENES, DIAG_SCENES = 4, 2
LPIPS_RTOL = 1e-4
# The network's part of configs/llff_eval.yaml and configs/nerf_eval.yaml, as
# load_cfg merges them (tests/test_torch_port_imports.py holds them equal),
# and each eval config's protocol frame size.
LLFF_EVAL = {**DTU_EVAL, "mvs": {**DTU_EVAL["mvs"], "num_depth": [36, 8]},
             "nerf": {**DTU_EVAL["nerf"], "reweighting": True}}
NERF_EVAL = {**DTU_EVAL, "nerf": {**DTU_EVAL["nerf"], "max_num_samples": 6, "reweighting": True}}
EVAL_CONFIGS = {"dtu_eval": (DTU_EVAL, (512, 640)), "llff_eval": (LLFF_EVAL, (640, 960)),
                "nerf_eval": (NERF_EVAL, (800, 800))}


def gate_workspace() -> str:
    return os.path.join(REPO, "build", "smoke_gate", "workspace")


def gate_dir() -> str:
    """Where 8a saves its checkpoint: dtu_eval's trained_model_dir under
    ``gate_workspace()`` (task gdb_nerf, experiment dtu_pretrain), so that
    ``run --type evaluate`` with that workspace loads it."""
    return os.path.join(gate_workspace(), "trained_model", "gdb_nerf", "dtu_pretrain")


def gate_train_cfg() -> SimpleNamespace:
    """tools/bf16_gate.py's recipe (RECIPE over configs/dtu_pretrain.yaml)."""
    cfg = train_cfg(GATE_HW, DTU_PRETRAIN["train"]["batch_size"], GATE_EP_ITER)
    cfg.train.epoch = GATE_EPOCHS
    cfg.train.sampler_meta.input_views_num = [GATE_VIEWS]
    cfg.train.sampler_meta.input_views_prob = [1.0]
    return cfg


def eval_cfg(name: str) -> SimpleNamespace:
    """configs/<name>.yaml on the synthetic loader at its protocol size."""
    net, hw = EVAL_CONFIGS[name]
    cfg = train_cfg(hw, 1, 1)
    for k, v in net.items():
        setattr(cfg, k, namespace(v) if isinstance(v, dict) else v)
    return cfg


def phase_gate_train() -> dict:
    """8a. The gate's recipe through bf16_gate.train: each epoch's losses, the
    step time (first step excluded), the peak memory; the loss finite, the
    last 20 steps' mean below the first 20's."""
    from gdb_nerf_tpu_torch.tools import bf16_gate

    cfg = gate_train_cfg()
    t0 = time.time()
    out = bf16_gate.train(cfg, gate_dir(), "cuda")
    wall = time.time() - t0
    losses, ms = out["losses"], out["step_ms"][1:]
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    smi = card()
    print(f"[gate-train] dtu_pretrain {GATE_HW[0]}x{GATE_HW[1]} B={cfg.train.batch_size} "
          f"V={sorted(set(out['views']))} float32, {len(losses)} steps in {wall:.1f} s: step "
          f"{np.mean(ms):.2f} ms mean, {np.median(ms):.2f} median (CUDA events, first excluded; "
          f"min {min(ms):.2f}, max {max(ms):.2f}), peak memory {out['peak_gib']:.2f} GiB; loss "
          f"first {losses[0]:.6f}, last {losses[-1]:.6f}, mean of the first 20 {first:.6f}, of "
          f"the last 20 {last:.6f}, digest {out['loss_digest']}; last stats {out['last_stats']} "
          f"on {smi}")
    if len(losses) != GATE_EPOCHS * GATE_EP_ITER or not np.isfinite(losses).all():
        raise AssertionError(f"8a: {len(losses)} steps, losses finite: {np.isfinite(losses).all()}")
    if set(out["views"]) != {GATE_VIEWS} or not last < first:
        raise AssertionError(f"8a: views {set(out['views'])}; loss {first} -> {last} did not fall")
    return {"steps": len(losses), "wall_s": wall, "step_ms_mean": float(np.mean(ms)),
            "step_ms_median": float(np.median(ms)), "peak_gib": out["peak_gib"],
            "first_loss": losses[0], "last_loss": losses[-1], "first20": first, "last20": last,
            "loss_digest": out["loss_digest"], "epoch_first_losses": losses[::GATE_EP_ITER], "card": smi}


def phase_gate(state: dict) -> dict:
    """8b. The checkpoint of 8a (loaded back by load_network) on GATE_SCENES
    dtu_eval scenes at 512x640 in float32 and bf16 through bf16_gate.gate:
    the rows, the worst delta against the bar, the bundle-head kernel's
    launches in each dtype (one a render).  ``main`` fails the smoke on a
    failed gate once 8c and 8d have run and every JSON line is printed."""
    from gdb_nerf_tpu_torch.tools import bf16_gate

    result = bf16_gate.gate(eval_cfg("dtu_eval"), state, "cuda", GATE_SCENES)
    for row in result["rows"]:
        print("[gate] " + json.dumps(row))
    agree = [r["agree_db"] for r in result["rows"]]
    print(f"[gate] worst |gt_bf16 - gt_f32| {result['worst_gate_delta_bf16_trained']:.4f} dB "
          f"(bar {result['gate_bar']}): {'pass' if result['pass'] else 'FAIL'}; bf16 against "
          f"float32 {min(agree):.2f}-{max(agree):.2f} dB; bundle-head kernel launches "
          f"{result['launches']}")
    if any(n < GATE_SCENES for n in result["launches"].values()):
        raise AssertionError(f"8b: the kernel did not launch for every render: {result['launches']}")
    return result


def phase_diagnostics(state: dict) -> dict:
    """8c. measure_fill and measure_lod on the trained weights, each eval
    config at its protocol size in float32 over DIAG_SCENES scenes, through
    the bundle-head kernel; spb in [1, S] (measure_fill raises otherwise),
    one count a bundle, one lod a sample and view, each in the histogram."""
    from gdb_nerf_tpu_torch.kernels.bundle_head import LAUNCHES
    from gdb_nerf_tpu_torch.runtime import tracing
    from gdb_nerf_tpu_torch.tools import measure_common, measure_fill, measure_lod

    out = {}
    for name, (_, (H, W)) in EVAL_CONFIGS.items():
        cfg = eval_cfg(name)
        batches = measure_common.first_batches(cfg, DIAG_SCENES)
        renderer = measure_common.renderer_for(cfg, "cuda", state, debug_outputs=True)
        t0 = time.time()
        with tracing.recording() as rec:
            counts = measure_fill.spb_counts(renderer, batches)
            fill = measure_fill.fill_stats(name, counts, f"{DIAG_SCENES} synthetic scenes, "
                                           "the weights of phase 8a")
            lod = measure_lod.measure(renderer, batches)
        launches = rec.counter(LAUNCHES)
        S, V = cfg.nerf.max_num_samples, GATE_VIEWS
        bundles = DIAG_SCENES * (H // 2) * (W // 2)
        print(f"[diagnostics] {json.dumps({**fill, 'hw': [H, W]})}")
        print(f"[diagnostics] {json.dumps({'config': name, **lod, 'hw': [H, W]})}")
        print(f"[diagnostics] {name}: {time.time() - t0:.1f} s, bundle-head kernel launches "
              f"{launches}")
        if (int(counts.sum()) != bundles or lod["n"] != bundles * V * S
                or sum(lod["hist_halves"].values()) != lod["n"] or launches < DIAG_SCENES):
            raise AssertionError(f"8c {name}: {int(counts.sum())} spb counts for {bundles} "
                                 f"bundles, {lod['n']} lods, {launches} launches")
        out[name] = {"fill": fill, "lod": lod, "launches": launches}
        del renderer
        free_cuda()
    return out


def lpips_weights(seed: int = 0) -> dict:
    """LPIPS weights of VGG16's shapes (the real ones are absent), in the JAX
    module's layout: He-normal HWIO convs, small biases, heads in [0, 1)."""
    rng = np.random.default_rng(seed)
    weights, cin, li = {}, 3, 0
    for i, (ch, n) in enumerate([(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]):
        for _ in range(n):
            weights[f"conv{li}_w"] = (rng.standard_normal((3, 3, cin, ch), np.float32)
                                      * np.float32(np.sqrt(2.0 / (9 * cin))))
            weights[f"conv{li}_b"] = (0.01 * rng.standard_normal(ch)).astype(np.float32)
            cin, li = ch, li + 1
        weights[f"lin{i}_w"] = rng.uniform(0, 1, ch).astype(np.float32)
    return weights


def phase_lpips(gate: dict) -> dict:
    """8d. LPIPS of two of 8b's float32 renders against their targets on the
    card and on the CPU (seeded VGG16-shaped weights), then ``run --type
    evaluate`` with those weights in its workspace, which must print a
    numeric lpips."""
    import ast

    from gdb_nerf_tpu_torch.eval.lpips import LPIPS

    weights = lpips_weights()
    on_card, on_cpu = LPIPS(weights, "cuda"), LPIPS(weights, "cpu")
    pairs = []
    for pred, gt in list(zip(gate["renders"]["float32"], gate["targets"]))[:2]:
        a, b = gt * 2 - 1, pred * 2 - 1  # the evaluator's order
        t0 = time.time()
        card_v = on_card(a, b)
        card_s = time.time() - t0
        cpu_v = on_cpu(a, b)
        rel = abs(card_v - cpu_v) / abs(cpu_v)
        pairs.append({"card": card_v, "cpu": cpu_v, "rel": rel, "card_s": card_s})
        print(f"[lpips] {a.shape[0]}x{a.shape[1]} render against its target: card {card_v:.8f} "
              f"({card_s:.3f} s on the host clock, the first call included), cpu {cpu_v:.8f}, "
              f"relative {rel:.2e} (bound {LPIPS_RTOL})")
        if not rel <= LPIPS_RTOL:
            raise AssertionError(f"8d: the card's LPIPS {card_v} against the CPU's {cpu_v}")
    os.makedirs(os.path.join(gate_workspace(), "weights"), exist_ok=True)
    np.savez(os.path.join(gate_workspace(), "weights", "lpips_vgg.npz"), **weights)
    t0 = time.time()
    run = subprocess.run(
        [sys.executable, "-m", "gdb_nerf_tpu_torch.run", "--type", "evaluate", "--cfg_file",
         "configs/dtu_eval.yaml", "synthetic", "True", "eval_lpips", "True"],
        cwd=REPO, env={**os.environ, "workspace": gate_workspace()}, capture_output=True,
        text=True, timeout=600)
    for line in run.stdout.splitlines()[-16:]:
        print(f"[lpips] evaluate: {line}")
    if run.returncode != 0:
        raise AssertionError(f"8d: run --type evaluate exited {run.returncode}: {run.stderr[-3000:]}")
    summary = ast.literal_eval(next(l for l in run.stdout.splitlines() if l.startswith("{'psnr'")))
    loaded = f"loaded {os.path.join(gate_dir(), 'latest.pth')}" in run.stdout
    print(f"[lpips] run --type evaluate with eval_lpips True: {summary} in "
          f"{time.time() - t0:.1f} s; the checkpoint of 8a loaded: {loaded}")
    if not isinstance(summary.get("lpips"), float) or not loaded:
        raise AssertionError(f"8d: evaluate printed lpips {summary.get('lpips')!r}, "
                             f"loaded the checkpoint of 8a: {loaded}")
    return {"pairs": pairs, "evaluate": summary}



# Phase 9: bf16 training on float32 master weights (train/mixed.py).  9c holds
# the card's bf16 step to the CPU's bf16 step from the same weights and batch,
# with BatchNorm on running statistics: on batch statistics, at B = 1, any
# change of rounding (1 CPU thread against 8) moves the bf16 step's FPN and
# U-Net gradients by 4.7e-2, on running statistics by 1e-7 (ROADMAP queue 3).
# The loss within BF16_LOSS_RTOL relative; the gradients of the FPN and
# U-Nets, and of the rest, each as one vector, no farther from the CPU's bf16
# ones than BF16_CARD_RATIO times the CPU float32 step's distance from them
# (0.29 and 0.56 measured, NVIDIA H100 80GB HBM3, 700.00 W; most of the
# rest's distance lies in the decoder's conv weight gradients, which cuDNN
# sums in another order than the CPU: the phase prints each group's largest
# shares).  The card's float32 step is the control that must fail that
# ratio (1.00 measured).
BF16_LOSS_RTOL, BF16_CARD_RATIO = 1e-3, 0.75
OVERFIT_BF16_FALL = 0.9  # 9b: the JAX package's rule (tests/test_train_step.py)


def grad_groups(names) -> dict:
    """Parameter names: the FPN and the cost-regularization U-Nets, and the rest."""
    deep = [k for k in names if k.startswith(("feature_net.", "depth_net.cost_regs."))]
    return {"fpn_unets": deep, "rest": [k for k in names if k not in deep]}


def group_rel_l2(a: dict, b: dict, names) -> float:
    x = np.concatenate([np.ravel(a[k]) for k in names]).astype(np.float64)
    y = np.concatenate([np.ravel(b[k]) for k in names]).astype(np.float64)
    return float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-30))


def phase_train_bf16(f32: dict):
    """9a. TRAIN_STEPS trainer steps of the dtu_pretrain recipe at 512x640,
    B = 4, in bf16 on float32 master weights, beside phase 6a's float32
    numbers from this run.  Returns the trainer, its config and the numbers."""
    import torch

    from gdb_nerf_tpu_torch.datasets import make_data_loader
    from gdb_nerf_tpu_torch.train.recorder import Recorder

    B = DTU_PRETRAIN["train"]["batch_size"]
    cfg = train_cfg((512, 640), B, TRAIN_STEPS, "bfloat16")
    trainer = make_trainer(cfg)
    if trainer.mixed is None or any(p.dtype != torch.float32 for p in trainer.network.parameters()):
        raise AssertionError("9a: the bf16 trainer does not keep float32 master weights")
    recorder = Recorder(cfg)
    torch.cuda.reset_peak_memory_stats()
    trainer.train_epoch(0, make_data_loader(cfg, is_train=True, max_iter=TRAIN_STEPS), recorder)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = list(recorder.loss_stats["loss"].deque)
    timed = list(trainer.step_ms[1:])
    smi = card()
    mean, mean32 = sum(timed) / len(timed), sum(f32["step_ms"]) / len(f32["step_ms"])
    print(f"[train-bf16] dtu_pretrain 512x640 B={B} bf16 on float32 master weights, "
          f"{len(trainer.step_ms)} steps: mean step {mean:.2f} ms (first excluded; min "
          f"{min(timed):.2f}, max {max(timed):.2f}), peak memory {peak:.2f} GiB; float32 (6a, "
          f"this run): {mean32:.2f} ms, {f32['peak_gib']:.2f} GiB; bf16 / float32 "
          f"{mean / mean32:.3f} in time, {peak / f32['peak_gib']:.3f} in memory; losses "
          + " ".join(f"{x:.5f}" for x in losses) + f" on {smi}")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"9a: bf16 train steps: {losses}")
    return trainer, cfg, {"steps": len(trainer.step_ms), "step_ms": timed, "peak_gib": peak,
                          "losses": losses, "float32_step_ms_mean": mean32,
                          "float32_peak_gib": f32["peak_gib"], "card": smi}


def phase_overfit_bf16() -> list:
    """9b. OVERFIT_STEPS bf16 steps on one 128x160 batch: the last loss must
    fall below OVERFIT_BF16_FALL times the first."""
    from gdb_nerf_tpu_torch.datasets import make_data_loader

    cfg = train_cfg((128, 160), 4, OVERFIT_STEPS, "bfloat16")
    trainer = make_trainer(cfg)
    batch = next(iter(make_data_loader(cfg, is_train=True, max_iter=1)))
    losses = [trainer.train_step(batch)["loss"] for _ in range(OVERFIT_STEPS)]
    print(f"[overfit-bf16] 128x160 B=4 bf16, {OVERFIT_STEPS} steps on one batch: loss "
          + " ".join(f"{x:.5f}" for x in losses) + f"; last / first {losses[-1] / losses[0]:.4f} "
          f"(must be below {OVERFIT_BF16_FALL})")
    if not losses[-1] < OVERFIT_BF16_FALL * losses[0]:
        raise AssertionError(f"9b: the bf16 loss did not fall below {OVERFIT_BF16_FALL} of its "
                             f"first value: {losses}")
    return losses


def phase_train_bf16_vs_cpu() -> dict:
    """9c. One bf16 step at 64x64 on the card and on the CPU from the same
    float32 weights and batch, BatchNorm on running statistics, and one
    float32 step on each: the card's bf16 loss and gradients against the
    CPU's bf16 ones (see BF16_CARD_RATIO), the card's float32 step as the
    control that must fail."""
    import torch

    from gdb_nerf_tpu_torch.datasets import make_data_loader

    cfg, cfg32 = train_cfg((64, 64), 1, 1, "bfloat16"), train_cfg((64, 64), 1, 1)
    gpu = make_trainer(cfg)
    state = {k: v.cpu() for k, v in gpu.network.state_dict().items()}
    trainers = {"gpu": gpu, "cpu": make_trainer(cfg, "cpu", state),
                "cpu32": make_trainer(cfg32, "cpu", state), "gpu32": make_trainer(cfg32)}
    batch = next(iter(make_data_loader(cfg, is_train=True, max_iter=1)))
    losses, grads = {}, {}
    for name, t in trainers.items():
        t.network.eval()
        if t.mixed is not None:
            t.mixed.compute.eval()
        losses[name] = t.train_step(batch)["loss"]
        grads[name] = {k: p.grad.double().cpu().numpy() for k, p in t.network.named_parameters()}
    if any(p.grad.dtype != torch.float32 for p in gpu.network.parameters()):
        raise AssertionError("9c: the master gradients are not float32")
    loss_err = abs(losses["gpu"] - losses["cpu"])
    ok = loss_err <= BF16_LOSS_RTOL * abs(losses["cpu"])
    control_fails = False
    groups = {}
    for name, names in grad_groups(grads["cpu"]).items():
        own = group_rel_l2(grads["cpu32"], grads["cpu"], names)
        got = group_rel_l2(grads["gpu"], grads["cpu"], names) / own
        control = group_rel_l2(grads["gpu32"], grads["cpu"], names) / own
        groups[name] = {"card_ratio": got, "card_f32_ratio": control, "cpu_f32_vs_bf16": own}
        ok = ok and got <= BF16_CARD_RATIO
        control_fails = control_fails or control > BF16_CARD_RATIO
        sq = {k: float(np.sum((grads["gpu"][k] - grads["cpu"][k]) ** 2)) for k in names}
        top = sorted(sq, key=sq.get, reverse=True)[:3]
        shares = ", ".join(f"{k} {sq[k] / max(sum(sq.values()), 1e-300):.2f}" for k in top)
        print(f"[train-bf16-vs-cpu] {name} ({len(names)} tensors): the card's bf16 gradients "
              f"{got:.4f} of the CPU float32 step's distance ({own:.3e} relative L2) from the "
              f"CPU's bf16 ones (bound {BF16_CARD_RATIO}); the card's float32 step {control:.4f}; "
              f"largest shares of the card's squared distance: {shares}")
    print(f"[train-bf16-vs-cpu] 64x64 B=1, BatchNorm on running statistics: bf16 loss card "
          f"{losses['gpu']:.8f} cpu {losses['cpu']:.8f} (|d| {loss_err:.2e}, bound "
          f"{BF16_LOSS_RTOL} relative); float32 card {losses['gpu32']:.8f} cpu "
          f"{losses['cpu32']:.8f}; within the bounds: {ok}; the float32 control fails: "
          f"{control_fails}")
    if not ok or not control_fails:
        raise AssertionError("9c: the card's bf16 train step disagrees with the CPU's, or the "
                             "float32 control passes")
    return {"losses": losses, "groups": groups}


def phase_val_bf16(trainer, cfg) -> dict:
    """9d. Trainer.val of the bf16 training through the bf16 head kernel
    (its launches counted while val renders through the step's bf16
    compute copy), then save_model
    and load_network into float32 and bf16 Renderers (run.build_renderer):
    the checkpoint's tensors float32, one request rendered in each."""
    import torch

    from gdb_nerf_tpu_torch import run
    from gdb_nerf_tpu_torch.datasets import make_data_loader
    from gdb_nerf_tpu_torch.kernels.bundle_head import LAUNCHES
    from gdb_nerf_tpu_torch.runtime import tracing
    from gdb_nerf_tpu_torch.runtime.registry import make_evaluator
    from gdb_nerf_tpu_torch.runtime.renderer import to_device
    from gdb_nerf_tpu_torch.utils.checkpoint import load_network, save_model

    loader = make_data_loader(cfg, is_train=False)
    net = trainer.mixed.compute  # val renders through the step's bf16 copy
    with tracing.recording() as rec:
        result = trainer.val(0, loader, make_evaluator(cfg))
    launches = rec.counter(LAUNCHES)
    print(f"[val-bf16] {len(loader)} requests at 512x640 after 9a: psnr {result['psnr']:.3f}, "
          f"ssim {result['ssim']:.4f}; rendered through a {net.compute_dtype} eval network "
          f"(head weights {net.nerf.lr0[0].weight.dtype}); bundle-head kernel launches {launches}")
    if (trainer.val_network is not net or launches < len(loader)
            or net.compute_dtype != torch.bfloat16
            or not np.isfinite(result["psnr"]) or not trainer.network.training):
        raise AssertionError(f"9d: val: {launches} launches, {net.compute_dtype}, {result}")
    save_model(trainer.state_dict(), cfg.trained_model_dir, 0, last=True)
    saved, path = load_network(cfg.trained_model_dir)
    dtypes = sorted({str(v.dtype) for v in saved.values() if v.is_floating_point()})
    print(f"[val-bf16] {path}: {len(saved)} tensors, floating dtypes {dtypes}")
    if dtypes != ["torch.float32"]:
        raise AssertionError(f"9d: the bf16 training's checkpoint holds {dtypes}")
    batch = to_device(next(iter(loader)), "cuda")
    rgb, out = {}, {"launches_val_bf16": launches, "val": result}
    for dt in ("float32", "bfloat16"):
        renderer = run.build_renderer(SimpleNamespace(**{**vars(cfg), "compute_dtype": dt}))
        held = renderer.network.state_dict()
        if not all(torch.equal(held[k], v.to(held[k].dtype).cuda()) for k, v in saved.items()):
            raise AssertionError(f"9d: the {dt} renderer does not hold the checkpoint")
        with tracing.recording() as rec:
            ret, _ = renderer.render(batch)
        rgb[dt] = ret["rgb"].float().cpu().numpy()
        out[f"launches_{dt}"] = rec.counter(LAUNCHES)
        if out[f"launches_{dt}"] < 1 or not np.isfinite(rgb[dt]).all():
            raise AssertionError(f"9d: the {dt} renderer of the checkpoint: {out[f'launches_{dt}']} "
                                 f"launches, finite: {np.isfinite(rgb[dt]).all()}")
    out["bf16_vs_f32_db"] = psnr(rgb["bfloat16"], rgb["float32"])
    print(f"[val-bf16] the checkpoint in float32 and bf16 Renderers: one request each, bf16 vs "
          f"float32 {out['bf16_vs_f32_db']:.2f} dB; launches {out['launches_float32']} / "
          f"{out['launches_bfloat16']}")
    return out


def phase_measure_train_step() -> dict:
    """9e. tools/measure_train_step.py at dtu_pretrain 512x640, B = 4, --n 4,
    in float32 and bf16."""
    from gdb_nerf_tpu_torch.tools import measure_train_step

    out = {}
    for dt in ("float32", "bfloat16"):
        free_cuda()
        cfg = train_cfg((512, 640), DTU_PRETRAIN["train"]["batch_size"], 4, dt)
        out[dt] = measure_train_step.measure(cfg, "cuda", n=4)
        if not np.isfinite(out[dt]["warm_loss"]) or out[dt]["step_ms"] <= 0:
            raise AssertionError(f"9e: measure_train_step {dt}: {out[dt]}")
    return out


# Phase 10: the native image decoder (datasets/native.py over
# csrc/gdbn_io.cpp), built with g++ from this checkout.  Its images are held
# to their bytes / 255 (NATIVE_ATOL), the white-background composite to
# NATIVE_ALPHA_ATOL, a resize to the plain bilinear formula with half-pixel
# centers to NATIVE_RESIZE_ATOL (tests/test_native_io.py's tolerances).
NATIVE_ATOL, NATIVE_ALPHA_ATOL, NATIVE_RESIZE_ATOL = 1e-6, 1e-5, 2e-3
NATIVE_POOL_IMAGES = 12


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit RGB or RGBA PNG written with the standard library's zlib."""
    import struct
    import zlib

    h, w, c = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_pfm(path: str, depth: np.ndarray) -> None:
    """A single-channel little-endian PFM (rows bottom-up) written with struct."""
    import struct

    h, w = depth.shape
    with open(path, "wb") as f:
        f.write(f"Pf\n{w} {h}\n-1.0\n".encode())
        f.write(struct.pack(f"<{h * w}f", *np.flipud(depth).ravel().tolist()))


def bilinear_resize(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """The plain bilinear resize with half-pixel centers, edges clamped."""
    h, w = img.shape[:2]

    def taps(n_out, n_in):
        x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        x0 = np.floor(x).astype(int)
        return np.clip(x0, 0, n_in - 1), np.clip(x0 + 1, 0, n_in - 1), (x - x0)[:, None]

    y0, y1, wy = taps(oh, h)
    x0, x1, wx = taps(ow, w)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy[:, :, None]) + bot * wy[:, :, None]


def phase_native() -> dict:
    """10. Build the port's decoder, decode RGB and RGBA PNGs at 512x640, a
    resize, a pool of NATIVE_POOL_IMAGES images and a PFM; the decode rate.
    A missing prerequisite is printed on its own line and skips the phase."""
    from gdb_nerf_tpu_torch.datasets import native
    from gdb_nerf_tpu_torch.utils.io import read_pfm

    reason = native.unavailable_reason()
    if reason is not None:
        print(f"[native] prerequisite missing: {reason}")
        return {"skipped": reason}
    t0 = time.time()
    lib = native.load()
    build_s = time.time() - t0
    print(f"[native] built {native.SOURCE.relative_to(REPO)} with g++ into "
          f"{native.BUILD_DIR.relative_to(REPO)} and loaded in {build_s:.1f} s ({lib._name})")
    rng = np.random.default_rng(0)
    d = os.path.join(REPO, "build", "smoke_native")
    os.makedirs(d, exist_ok=True)
    rgb = rng.integers(0, 256, (512, 640, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, (512, 640, 4), dtype=np.uint8)
    p_rgb, p_rgba = os.path.join(d, "rgb.png"), os.path.join(d, "rgba.png")
    write_png(p_rgb, rgb)
    write_png(p_rgba, rgba)
    errs = {}
    out = native.decode_image(p_rgb)
    errs["rgb"] = float(np.abs(out - rgb.astype(np.float32) / 255.0).max())
    a = rgba[..., 3:].astype(np.float32) / 255.0
    want = rgba[..., :3].astype(np.float32) / 255.0 * a + (1 - a)
    errs["rgba_white"] = float(np.abs(native.decode_image(p_rgba, white_bg=True) - want).max())
    small = native.decode_image(p_rgb, (256, 320))
    errs["resize"] = float(np.abs(small - bilinear_resize(rgb.astype(np.float64) / 255.0, 256,
                                                           320)).max())
    paths = []
    for i in range(NATIVE_POOL_IMAGES):
        paths.append(os.path.join(d, f"pool{i}.png"))
        write_png(paths[-1], rng.integers(0, 256, (512, 640, 3), dtype=np.uint8))
    pool = native.DecodePool(8)
    t0 = time.time()
    outs = [pool.submit(p, (512, 640)) for p in paths]
    pool.wait()
    pool_s = time.time() - t0
    t0 = time.time()
    singles = [native.decode_image(p) for p in paths]
    single_s = time.time() - t0
    pool_equal = all(np.array_equal(o, s) for o, s in zip(outs, singles))
    depth = rng.uniform(400, 900, (128, 160)).astype(np.float32)
    p_pfm = os.path.join(d, "depth.pfm")
    write_pfm(p_pfm, depth)
    ours = native.read_pfm(p_pfm)
    pfm_equal = np.array_equal(ours, read_pfm(p_pfm)[0]) and np.array_equal(ours, depth)
    rate_pool, rate_single = len(paths) / pool_s, len(paths) / single_s
    rate_cv2 = None
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:  # the port's other decode path (datasets/imageio.py), same files
        t0 = time.time()
        for p in paths:
            cv2.cvtColor(cv2.imread(p, cv2.IMREAD_UNCHANGED), cv2.COLOR_BGR2RGB).astype(
                np.float32) / 255.0
        rate_cv2 = len(paths) / (time.time() - t0)
    print(f"[native] 512x640 PNG: RGB max |d| {errs['rgb']:.2e} (bound {NATIVE_ATOL}), RGBA on "
          f"white {errs['rgba_white']:.2e} (bound {NATIVE_ALPHA_ATOL}), resize to 256x320 against "
          f"the bilinear formula {errs['resize']:.2e} (bound {NATIVE_RESIZE_ATOL}); the pool's "
          f"{len(paths)} images equal to decode_image: {pool_equal}; PFM equal to "
          f"utils/io.read_pfm and to the written depth: {pfm_equal}")
    cv2_rate = "cv2 not importable" if rate_cv2 is None else f"cv2 {rate_cv2:.1f} images/s"
    print(f"[native] decode rate at 512x640: {rate_pool:.1f} images/s through a pool of 8 "
          f"threads, {rate_single:.1f} images/s one at a time ({cv2_rate} one at a time, "
          f"the same files), on this host")
    if (errs["rgb"] > NATIVE_ATOL or errs["rgba_white"] > NATIVE_ALPHA_ATOL
            or errs["resize"] > NATIVE_RESIZE_ATOL or not pool_equal or not pfm_equal):
        raise AssertionError(f"10: the native decoder disagrees: {errs}, pool {pool_equal}, "
                             f"pfm {pfm_equal}")
    return {"build_s": build_s, "max_abs_err": errs, "images_per_s_pool8": rate_pool,
            "images_per_s_single": rate_single, "cv2_images_per_s_single": rate_cv2}


# Phase 11: the tools that profile and verify the model, driven in-process
# at dtu_eval 512x640 V = 3 from seeded weights.  The stage chain that
# profile_forward times is held to the Renderer's forward on the same batch
# (TOOLS_CHAIN_ATOL: the CPU tests hold it bit for bit), profile_encode's
# pieces to encode_samples' fields the same way.
TOOLS_HW = EVAL_CONFIGS["dtu_eval"][1]
TOOLS_ITERS = 5
TOOLS_CHAIN_ATOL = 0.0
TOOLS_LOADER_N = 4


def tools_renderer(dtype: str, device):
    """dtu_eval's network from seed 0 in ``dtype`` on ``device``, and the
    synthetic loader's first request at its protocol size there."""
    from gdb_nerf_tpu_torch.runtime.renderer import to_device
    from gdb_nerf_tpu_torch.tools import measure_common

    cfg = eval_cfg("dtu_eval")
    cfg.compute_dtype = dtype
    renderer = measure_common.renderer_for(cfg, device, None)
    return renderer, to_device(measure_common.first_batches(cfg, 1)[0], device)


def max_abs_diff(got, want) -> float:
    import torch

    diffs = [float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)]
    if not all(bool(torch.isfinite(g.float()).all()) for g in got):
        return float("inf")
    return max(diffs)


def phase_tools(device: str = "cuda") -> dict:
    """11. (a) tools/profile_forward.py in float32 (TF32 off) and bf16, the
    bundle-head kernel's launches in its stages' first calls (> 0 in each
    dtype), and its stage chain against the Renderer's forward; (b)
    tools/profile_encode.py in bf16, its pieces against encode_samples' fields;
    (c) tools/microbench.py in full; (d) tools/roofline.py on (c)'s envelope,
    its floors per stage beside (a)'s times; (e) tools/verify_scene.py on
    the card with its five checks; (f) tools/microbench_loader.py with
    --n TOOLS_LOADER_N.  Prints the stage table as one JSON line."""
    import torch

    from gdb_nerf_tpu_torch.tools import (microbench, microbench_loader, profile_encode,
                                          profile_forward, roofline, verify_scene)

    t0 = time.time()
    smi = card()
    out = {"card": smi, "profile_forward": {}}
    for dt in ("float32", "bfloat16"):
        free_cuda()
        renderer, batch = tools_renderer(dt, device)
        print(f"[tools] profile_forward dtu_eval {TOOLS_HW[0]}x{TOOLS_HW[1]} V=3 {dt} on {smi}")
        prof = profile_forward.profile(renderer, batch, TOOLS_ITERS)
        with torch.inference_mode():
            chained = profile_forward.run_stages(renderer.network, batch, lambda name, fn: fn())
        ret, _ = renderer.render(batch)
        keys = sorted(ret)
        diff = max_abs_diff([chained[k] for k in keys], [ret[k] for k in keys])
        print(f"[tools] {dt}: bundle-head kernel launches in the stages' first calls "
              f"{prof['head_launches']}; the stage chain against the forward: max |d| {diff:.3e}")
        if prof["head_launches"] <= 0:
            raise AssertionError(f"11a {dt}: the head stage did not launch the bundle-head kernel")
        if sorted(chained) != keys or not diff <= TOOLS_CHAIN_ATOL:
            raise AssertionError(f"11a {dt}: the stage chain differs from the forward: {diff}")
        out["profile_forward"][dt] = {**prof, "chain_max_abs_diff": diff}
        del renderer
    free_cuda()
    renderer, batch = tools_renderer("bfloat16", device)
    inp = profile_encode.encode_inputs(renderer.network, batch)
    calls, _ = profile_encode.pieces(inp)
    with torch.inference_mode():
        enc = calls["encode full"]()
        got = [calls["member rgb (xV)"](), calls["mip fetch (xV)"](), calls["vox fetch"](),
               calls["ray diff"]()]
    diff = max_abs_diff(got, [enc.rgbs, enc.mip_feat, enc.vox_feat, enc.ray_diff])
    print(f"[tools] profile_encode {TOOLS_HW[0]}x{TOOLS_HW[1]} bf16 on {smi}; its pieces against "
          f"encode_samples: max |d| {diff:.3e}")
    if not diff <= TOOLS_CHAIN_ATOL:
        raise AssertionError(f"11b: encode's pieces differ from encode_samples: {diff}")
    out["profile_encode"] = profile_encode.profile(inp, torch.device(device), TOOLS_ITERS)
    del renderer, inp, calls, enc, got
    free_cuda()
    print(f"[tools] microbench on {smi}")
    env = microbench.measure(torch.device(device))
    out["microbench"] = env
    free_cuda()
    print(f"[tools] roofline at {TOOLS_HW[0]}x{TOOLS_HW[1]} V=3 S=3 on this run's envelope: "
          f"RR {env['rr'] / 1e6:.1f} M rows/s, GBW {env['gbw'] / 1e9:.1f} GB/s")
    roof = roofline.table(*TOOLS_HW, 3, 3, roofline.H100_BYTES_PER_S, env["rr"], env["gbw"])
    out["roofline"] = roof
    floors = roof["floor_ms_by_profile_stage"]
    f32 = {r["stage"]: r for r in out["profile_forward"]["float32"]["stages"]}
    b16 = {r["stage"]: r for r in out["profile_forward"]["bfloat16"]["stages"]}
    table = []
    print(f"[tools] {'stage':<24} {'f32 ms':>8} {'f32 busy':>9} {'bf16 ms':>8} {'bf16 enq':>9} "
          f"{'bf16 busy':>9} {'floor':>7}")
    for name in f32:
        row = {"stage": name, "floor_ms": floors.get(name)}
        for dt, by_name in (("float32", f32), ("bfloat16", b16)):
            row.update({f"{dt}_{k}": by_name[name][k] for k in ("ms", "enqueue_ms", "busy_ms")})
        table.append(row)
        floor = "-" if row["floor_ms"] is None else f"{row['floor_ms']:.3f}"
        print(f"[tools] {name:<24} {row['float32_ms']:8.3f} {row['float32_busy_ms']:9.3f} "
              f"{row['bfloat16_ms']:8.3f} {row['bfloat16_enqueue_ms']:9.3f} "
              f"{row['bfloat16_busy_ms']:9.3f} {floor:>7}")
    for dt in ("float32", "bfloat16"):
        p = out["profile_forward"][dt]
        print(f"[tools] {dt}: stages' sum {p['sum_ms']:.3f} ms (busy {p['sum_busy_ms']:.3f}, "
              f"enqueue {p['sum_enqueue_ms']:.3f}) against the whole forward {p['forward_ms']:.3f} "
              f"ms (enqueue {p['forward_enqueue_ms']:.3f})")
    r = verify_scene.run(device)
    verify_scene.check(r)
    print(f"[tools] verify_scene on the card: {json.dumps(r)}: SCENE RECONSTRUCTION OK")
    out["verify_scene"] = r
    out["microbench_loader"] = microbench_loader.measure(TOOLS_LOADER_N)
    out["seconds"] = time.time() - t0
    print(f"[tools] phase 11 took {out['seconds']:.1f} s")
    print(json.dumps({"tools": {"stage_table": table, **out}}))
    return out


# Phase 12: the per-scene fine-tune configurations through the port's CLIs
# (train_net, then run --type evaluate), each YAML read by the port's
# load_cfg at its full width, one per dataset family.  Route "ii" resumes
# the fine-tune's own directory from phase 8a's checkpoint copied in as
# <epoch>.pth (the reference's route); route "i" warm-starts through
# train.pretrain from it copied in as the 'pretrained' experiment's
# latest.pth (a fresh optimizer at epoch 0).  Each fine-tune runs
# FINETUNE_EPOCHS epochs of FINETUNE_EP_ITER steps (the YAMLs' train.epoch
# 233 is the pretrained epoch + 10).  The head-stage check holds K1 to the
# plain head at phase 2's tolerances on one V = 4 frame of each.
FINETUNE = (("scan114", "configs/dtu/scan114.yaml", "ii", (512, 640)),
            ("fern", "configs/llff/fern.yaml", "i", (640, 960)),
            ("lego", "configs/nerf/lego.yaml", "i", (800, 800)))
FINETUNE_EPOCHS, FINETUNE_EP_ITER = 2, 3
FINETUNE_VIEWS = 4  # the YAMLs' test.sampler_meta.input_views_num


def finetune_workspace() -> str:
    return os.path.join(REPO, "build", "smoke_finetune", "workspace")


class HeadLaunches:
    """While active (a ``tracing.recording()``), counts the bundle-head
    kernel's launches by the call's view count: the counter read before and
    after each call, by forward hooks on ``head`` or, without one, on every
    BundleNeRF the process calls.  Each time it is entered adds to the same
    counts."""

    def __init__(self, head=None):
        self.head, self.by_views = head, {}

    def __enter__(self):
        from torch.nn.modules import module

        from gdb_nerf_tpu_torch.kernels.bundle_head import LAUNCHES
        from gdb_nerf_tpu_torch.models.nerf_head import BundleNeRF
        from gdb_nerf_tpu_torch.runtime import tracing

        self._recording = tracing.recording()
        rec = self._recording.__enter__()
        before = {}

        def pre(m, args):
            if isinstance(m, BundleNeRF):
                before[id(m)] = (rec.counter(LAUNCHES), int(args[1].shape[0]))

        def post(m, args, out):
            if isinstance(m, BundleNeRF) and id(m) in before:
                n0, views = before.pop(id(m))
                n = rec.counter(LAUNCHES) - n0
                if n > 0:
                    self.by_views[views] = self.by_views.get(views, 0) + n

        if self.head is None:
            self._hooks = [module.register_module_forward_pre_hook(pre),
                           module.register_module_forward_hook(post)]
        else:
            self._hooks = [self.head.register_forward_pre_hook(pre),
                           self.head.register_forward_hook(post)]
        return self

    def __exit__(self, *exc):
        for h in self._hooks:
            h.remove()
        self._recording.__exit__(*exc)


class observed_trainers:
    """While active, records of every Trainer the process trains with: the
    epoch, the LR of each parameter group, the schedule's step count and a
    copy of the network's state at its first ``train_epoch`` call, then each
    epoch, each step's loss and view count, and the bundle-head kernel's
    launches by view count of the network its ``val`` renders through
    (``HeadLaunches`` on that head, active in ``val`` alone, so that the
    steps and their times run untraced).  The trainer runs unchanged."""

    def __enter__(self):
        from gdb_nerf_tpu_torch.train.trainer import Trainer

        self.records = []
        self._saved = (Trainer.train_epoch, Trainer.train_step, Trainer.val)
        epoch_fn, step_fn, val_fn = self._saved
        records = self.records

        def record_of(trainer):
            return next((r for r in records if r["trainer"] is trainer), None)

        def train_epoch(trainer, epoch, loader, recorder):
            rec = record_of(trainer)
            if rec is None:
                rec = {"trainer": trainer, "first_epoch": epoch,
                       "first_lr": [g["lr"] for g in trainer.optimizer.param_groups],
                       "first_count": trainer.scheduler.last_epoch,
                       "state_before": {k: v.detach().cpu().clone()
                                        for k, v in trainer.network.state_dict().items()},
                       "epochs": [], "losses": [], "views": [],
                       "val_launches": HeadLaunches((trainer.network if trainer.mixed is None
                                                     else trainer.mixed.compute).nerf)}
                records.append(rec)
            rec["epochs"].append(epoch)
            return epoch_fn(trainer, epoch, loader, recorder)

        def train_step(trainer, batch):
            stats = step_fn(trainer, batch)
            rec = record_of(trainer)
            if rec is not None:
                rec["losses"].append(stats["loss"])
                rec["views"].append(int(batch["src_views"]["rgb"].shape[1]))
            return stats

        def val(trainer, *args, **kwargs):
            rec = record_of(trainer)
            if rec is None:
                return val_fn(trainer, *args, **kwargs)
            with rec["val_launches"]:
                return val_fn(trainer, *args, **kwargs)

        Trainer.train_epoch, Trainer.train_step, Trainer.val = train_epoch, train_step, val
        return self

    def __exit__(self, *exc):
        from gdb_nerf_tpu_torch.train.trainer import Trainer

        Trainer.train_epoch, Trainer.train_step, Trainer.val = self._saved


class Tee:
    """stdout that is also kept, for the lines a CLI prints."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, text):
        self.out.write(text)
        self.lines.append(text)
        return len(text)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.lines)


def scene_metrics(text: str) -> dict:
    """The evaluator's per-scene lines (``<scene> psnr: P ssim: S``)."""
    out = {}
    for line in text.splitlines():
        parts = line.split()
        if len(parts) >= 5 and parts[1] == "psnr:" and parts[3] == "ssim:":
            out[parts[0]] = {"psnr": float(parts[2]), "ssim": float(parts[4])}
    return out


def finetune_head_check(cfg, state: dict, batch: dict, device: str = "cuda") -> dict:
    """12, the head stage on real inputs: one V = FINETUNE_VIEWS frame through
    the Network's stage methods (tools/profile_forward.run_stages) in each
    dtype with ``state``, the inputs that head_composite hands the head taken
    by a hook, then K1 against the plain head on them (held_to_plain)."""
    import torch

    from gdb_nerf_tpu_torch.runtime.renderer import to_device
    from gdb_nerf_tpu_torch.tools import measure_common, profile_forward

    out = {}
    for dt in ("float32", "bfloat16"):
        renderer = measure_common.renderer_for(SimpleNamespace(**{**vars(cfg), "compute_dtype": dt}),
                                               device, state)
        head, inputs = renderer.network.nerf, []
        hook = head.register_forward_pre_hook(lambda m, args: inputs.append(args[:3]) or None)
        with torch.inference_mode():
            ret = profile_forward.run_stages(renderer.network, to_device(batch, device),
                                             lambda name, fn: fn())
        hook.remove()
        vox, payload, frd = inputs[0]
        ok, *errs = held_to_plain(head.kernel, head, head.packed_weights(), vox, payload, frd)
        err = max(errs)
        out[dt] = {"n": int(vox.shape[0]), "views": int(payload.shape[0]), "max_abs_err": err,
                   "rgb_finite": bool(torch.isfinite(ret["rgb"]).all())}
        print(f"[finetune] head stage {dt}: N={vox.shape[0]} V={payload.shape[0]}, K1 against "
              f"the plain head max |d| {err:.3e} ("
              + (f"atol {F32_ATOL}, rtol {F32_RTOL}" if dt == "float32" else f"atol {BF16_ATOL}")
              + ")")
        if not ok or payload.shape[0] != FINETUNE_VIEWS or not out[dt]["rgb_finite"]:
            raise AssertionError(f"12: the head stage of {dt}: {out[dt]}")
        del renderer, head, inputs, vox, payload, frd, ret
        free_cuda()
    return out


def rig_check(cfg, batch: dict, train_views) -> float:
    """12, the synthetic rig at the config's size: FINETUNE_VIEWS source views
    at test, the training's view counts among the YAML's with probability >
    0, and no target camera on a source camera (ROADMAP queue 3's trap).
    Returns the least distance between the target's and a source's centre."""
    views = batch["src_views"]["rgb"].shape[1]
    centre = lambda ext: np.linalg.inv(np.asarray(ext, np.float64))[:3, 3]  # noqa: E731
    tar = centre(batch["tar_views"]["extrinsics"][0])
    least = min(float(np.linalg.norm(centre(e) - tar)) for e in batch["src_views"]["extrinsics"][0])
    meta = cfg.train.sampler_meta
    allowed = {v for v, p in zip(meta.input_views_num, meta.input_views_prob) if p > 0}
    if views != FINETUNE_VIEWS or least < 1.0 or not set(train_views) <= allowed:
        raise AssertionError(f"12: test views {views}, the target {least:.3f} from a source, "
                             f"training views {sorted(set(train_views))} against {sorted(allowed)}")
    return least


def phase_finetune(device: str = "cuda") -> dict:
    """12. Each of FINETUNE warm-started from phase 8a's checkpoint (see the
    comment above FINETUNE): the YAML's flags, the rig, the evaluator's
    per-scene PSNR/SSIM with the warm-start weights, ``train_net``'s main
    (before the first step the network equals the warm-start file, its
    epoch and LR are the route's and the schedule's; every loss finite; the
    last epoch's checkpoint written; Trainer.val through K1 at V = 4), then
    ``run --type evaluate``'s main through K1 at V = 4, then the head-stage
    check on the fine-tuned weights.  Prints the step time (CUDA events,
    the first step excluded), the peak memory and the card."""
    import contextlib
    import shutil

    import torch

    from gdb_nerf_tpu_torch import run, train_net
    from gdb_nerf_tpu_torch.config import load_cfg
    from gdb_nerf_tpu_torch.datasets import make_data_loader
    from gdb_nerf_tpu_torch.tools import measure_common
    from gdb_nerf_tpu_torch.train.optim import make_lr_schedule
    from gdb_nerf_tpu_torch.utils.checkpoint import load_network

    if torch.are_deterministic_algorithms_enabled():
        raise AssertionError("12: torch's deterministic algorithms are still on after phase 8a")
    t0 = time.time()
    smi = card()
    on = [] if device == "cuda" else ["device", device]  # the CLIs' default device is cuda
    ws = finetune_workspace()
    shutil.rmtree(ws, ignore_errors=True)
    warm_path = os.path.join(gate_dir(), "latest.pth")
    warm = torch.load(warm_path, map_location="cpu", weights_only=True)
    out = {"card": smi, "warm_start": {"file": os.path.relpath(warm_path, REPO),
                                       "epoch": warm["epoch"], "step": warm["step"]}}
    for name, yaml_path, route, (H, W) in FINETUNE:
        t1 = time.time()
        free_cuda()
        probe = load_cfg(os.path.join(REPO, yaml_path), ["workspace", ws])
        if route == "ii":  # resume the fine-tune's own directory
            first_epoch, count = warm["epoch"] + 1, warm["scheduler"]["last_epoch"]
            dest = os.path.join(probe.trained_model_dir, f"{warm['epoch']}.pth")
        else:  # train.pretrain: a fresh optimizer at epoch 0
            first_epoch, count = 0, 0
            dest = os.path.join(ws, "trained_model", probe.task, probe.train.pretrain, "latest.pth")
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        shutil.copyfile(warm_path, dest)
        overrides = ["synthetic", "True", "synthetic_hw", f"[{H},{W}]", "workspace", ws,
                     "ep_iter", str(FINETUNE_EP_ITER), "train.epoch",
                     str(first_epoch + FINETUNE_EPOCHS), *on]
        cfg = load_cfg(os.path.join(REPO, yaml_path), overrides)
        print(f"[finetune] {yaml_path} ({cfg.exp_name}) route ({route}) at {H}x{W}: fpn "
              f"{vars(cfg.fpn)}, mvs.num_depth {cfg.mvs.num_depth}, S={cfg.nerf.max_num_samples} "
              f"adaptive {cfg.nerf.is_adaptive} reweighting {cfg.nerf.reweighting}, B="
              f"{cfg.train.batch_size}, lr {cfg.train.lr}, train views "
              f"{cfg.train.sampler_meta.input_views_num} p {cfg.train.sampler_meta.input_views_prob}, "
              f"test views {cfg.test.sampler_meta.input_views_num}, eval_center "
              f"{cfg.test.eval_center}; warm start {os.path.relpath(dest, REPO)}")
        batch = measure_common.first_batches(cfg, 1)[0]
        loader = make_data_loader(cfg, is_train=False)
        before = Tee(sys.stdout)
        renderer = measure_common.renderer_for(cfg, device, warm["net"])
        with HeadLaunches() as launches_before, contextlib.redirect_stdout(before):
            summary_before = run.evaluate(cfg, renderer, loader)
        del renderer
        free_cuda()
        argv = ["--cfg_file", os.path.join(REPO, yaml_path), *overrides]
        torch.cuda.reset_peak_memory_stats()
        with observed_trainers() as seen:
            train_net.main(argv)
        peak = torch.cuda.max_memory_allocated() / 2**30
        (rec,) = seen.records
        trainer, launches_val = rec.pop("trainer"), rec.pop("val_launches")
        lr_want = make_lr_schedule(cfg)(count)
        same = all(torch.equal(rec["state_before"][k], v) for k, v in warm["net"].items())
        ms = trainer.step_ms[1:]
        last = os.path.join(cfg.trained_model_dir, f"{first_epoch + FINETUNE_EPOCHS - 1}.pth")
        latest = torch.load(os.path.join(cfg.trained_model_dir, "latest.pth"), map_location="cpu",
                            weights_only=True)
        least = rig_check(cfg, batch, rec["views"])
        print(f"[finetune] {name}: first step at epoch {rec['first_epoch']} (want {first_epoch}), "
              f"LR {rec['first_lr'][0]:.6e} (want {lr_want:.6e}: the schedule at step "
              f"{rec['first_count']}, epoch {rec['first_count'] // FINETUNE_EP_ITER} of "
              f"{FINETUNE_EP_ITER} steps), the network before it equal to the warm-start file: "
              f"{same}; epochs {rec['epochs']}, views {rec['views']}, losses "
              + " ".join(f"{x:.5f}" for x in rec["losses"])
              + f"; step {np.mean(ms):.2f} ms mean (CUDA events, first of {len(trainer.step_ms)} "
              f"excluded; min {min(ms):.2f}, max {max(ms):.2f}), peak memory {peak:.2f} GiB over "
              f"the steps and val; target {least:.2f} from the nearest source; on {smi}")
        if (rec["first_epoch"] != first_epoch or rec["first_count"] != count
                or any(lr != lr_want for lr in rec["first_lr"]) or not same
                or not np.isfinite(rec["losses"]).all()
                or len(rec["losses"]) != FINETUNE_EPOCHS * FINETUNE_EP_ITER
                or not os.path.exists(last) or latest["epoch"] != first_epoch + FINETUNE_EPOCHS - 1):
            raise AssertionError(f"12 {name}: the fine-tune did not start or end as its route and "
                                 f"schedule give: {rec['first_epoch']}, {rec['first_count']}, "
                                 f"{rec['first_lr']}, same {same}, {rec['losses']}, {last}")
        del trainer
        free_cuda()
        after = Tee(sys.stdout)
        with HeadLaunches() as launches_eval, contextlib.redirect_stdout(after):
            summary_after = run.main(["--type", "evaluate", *argv])
        loaded = f"[run] loaded {os.path.join(cfg.trained_model_dir, 'latest.pth')}" in after.text()
        print(f"[finetune] {name}: K1 launches by view count: Trainer.val {launches_val.by_views}, "
              f"run --type evaluate {launches_eval.by_views} (the warm start's evaluation "
              f"{launches_before.by_views}); evaluate loaded the fine-tuned latest.pth: {loaded}")
        for counted in (launches_val, launches_eval):
            if set(counted.by_views) != {FINETUNE_VIEWS} or counted.by_views[FINETUNE_VIEWS] < len(loader):
                raise AssertionError(f"12 {name}: K1 launches {counted.by_views}, want V = "
                                     f"{FINETUNE_VIEWS} for each of {len(loader)} requests")
        if not loaded or not np.isfinite(summary_after["psnr"]):
            raise AssertionError(f"12 {name}: evaluate {summary_after}, loaded {loaded}")
        scenes_before, scenes_after = scene_metrics(before.text()), scene_metrics(after.text())
        for scene in scenes_after:
            b, a = scenes_before[scene], scenes_after[scene]
            print(f"[finetune] {name} {scene}: psnr {b['psnr']:.2f} -> {a['psnr']:.2f}, ssim "
                  f"{b['ssim']:.3f} -> {a['ssim']:.3f} (warm start -> fine-tuned; synthetic "
                  "scene, no bar)")
        state, _ = load_network(cfg.trained_model_dir)
        head = finetune_head_check(cfg, state, batch, device)
        out[name] = {
            "cfg": yaml_path, "route": route, "hw": [H, W], "first_epoch": rec["first_epoch"],
            "first_lr": rec["first_lr"][0], "schedule_count": rec["first_count"],
            "epochs": rec["epochs"], "views": rec["views"], "losses": rec["losses"],
            "step_ms": ms, "peak_gib": peak, "launches_val": launches_val.by_views[FINETUNE_VIEWS],
            "launches_evaluate": launches_eval.by_views[FINETUNE_VIEWS],
            "before": {"summary": summary_before, "scenes": scenes_before},
            "after": {"summary": summary_after, "scenes": scenes_after},
            "head_check": head, "target_to_source": least, "seconds": time.time() - t1}
    out["seconds"] = time.time() - t0
    print(f"[finetune] phase 12 took {out['seconds']:.1f} s")
    return out


# Phase 13: tools/measure_frame.py in-process at each eval config's protocol
# size in float32 (TF32 off) and bf16, and dtu_eval at BASELINE.json's
# "1080p" stretch size rounded up to a multiple of 32 (the Network's sizes).
FRAME_ROWS = tuple((name, hw, dt) for name, (_, hw) in EVAL_CONFIGS.items()
                   for dt in ("float32", "bfloat16")) + (("dtu_eval", (1088, 1920), "bfloat16"),)


def phase_frames(device: str = "cuda") -> list:
    """13. measure_frame on each of FRAME_ROWS: its result rows; fails if K1
    did not launch in a row."""
    from gdb_nerf_tpu_torch.tools import measure_frame

    t0 = time.time()
    rows = []
    for name, (H, W), dt in FRAME_ROWS:
        free_cuda()
        cfg = measure_frame.frame_cfg(os.path.join(REPO, "configs", f"{name}.yaml"), dt,
                                      ["synthetic_hw", f"[{H},{W}]"])
        row = measure_frame.measure(cfg, device, name=name)
        rows.append(row)
        if row["head_launches_per_frame"] <= 0 or row["hw"] != [H, W]:
            raise AssertionError(f"13: measure_frame {name} {H}x{W} {dt}: {row}")
    print(f"[frames] phase 13 took {time.time() - t0:.1f} s")
    print(json.dumps({"frames": rows}))
    return rows


def timed_phase(name: str, fn, *args):
    """``fn(*args)``, then the phase's seconds on a line of their own."""
    t0 = time.time()
    out = fn(*args)
    print(f"[phase] {name} took {time.time() - t0:.1f} s")
    return out


def main() -> None:
    import torch

    from gdb_nerf_tpu_torch.tools import bf16_gate
    from gdb_nerf_tpu_torch.utils.checkpoint import load_network

    if len(sys.argv) == 3 and sys.argv[1] == "--rank-of":
        return rank_main(sys.argv[2])

    kernel, plane_kernels, gather_kernels, probe_kernels = timed_phase(
        "1", phase_device_and_build)
    g, sd = golden_state_dict()

    # Each dtype's head as its network holds it (bf16 weights, sigma float32).
    heads = {getattr(torch, dt): build_renderer(dt, sd).network.nerf
             for dt in ("float32", "bfloat16")}
    k1 = timed_phase("2", phase_kernel_vs_plain, kernel, heads)
    convs = timed_phase("2b", phase_plane_conv, plane_kernels)
    gathers = timed_phase("2c", phase_gather, gather_kernels)
    probes = timed_phase("2d", phase_plane_ops, probe_kernels)
    rgb = timed_phase("3", phase_golden, g, sd)
    launches = timed_phase("4", phase_serve, g, sd, rgb)
    t0 = time.time()
    trainer, cfg, packed_before, train = phase_train_recipe()
    phase_overfit()
    val_launches = phase_val(trainer, cfg, packed_before)
    evaluate_launches = phase_evaluate(trainer, cfg)
    phase_train_vs_cpu()
    print(f"[phase] 6 took {time.time() - t0:.1f} s")
    del trainer
    free_cuda()
    parallel = phase_parallel(phase_parallel_single())
    t0 = time.time()
    gate_train = phase_gate_train()
    state = load_network(gate_dir())[0]
    gate = phase_gate(state)
    diagnostics = phase_diagnostics(state)
    lpips = phase_lpips(gate)
    print(f"[gate] phase 8 took {time.time() - t0:.1f} s")
    free_cuda()
    t0 = time.time()
    trainer16, cfg16, train16 = phase_train_bf16(train)
    train16["overfit_losses"] = phase_overfit_bf16()
    val16 = phase_val_bf16(trainer16, cfg16)
    del trainer16
    train16["vs_cpu"] = phase_train_bf16_vs_cpu()
    train16["val"] = val16
    train16["measure_train_step"] = phase_measure_train_step()
    print(f"[train-bf16] phase 9 took {time.time() - t0:.1f} s")
    t0 = time.time()
    native = phase_native()
    print(f"[native] phase 10 took {time.time() - t0:.1f} s")
    free_cuda()
    phase_tools()
    free_cuda()
    finetune = phase_finetune()
    free_cuda()
    frames = phase_frames()
    kernels = [{
        "name": "bundle_head", "route": "cuda",
        "source": "gdb_nerf_tpu_torch/csrc/bundle_head.cu",
        "replaces": "gdb_nerf_tpu/ops/pallas/fused_nerf.py:89",
        "launches": launches, **k1,
        "launches_val": val_launches, "launches_evaluate": evaluate_launches,
        "launches_val_bf16": val16["launches_val_bf16"],
        "launches_sharded": parallel["launches_sharded"],
        "launches_gate": gate["launches"],
        "launches_diagnostics": {k: v["launches"] for k, v in diagnostics.items()},
        "launches_finetune": {name: {"val": finetune[name]["launches_val"],
                                     "evaluate": finetune[name]["launches_evaluate"]}
                              for name, *_ in FINETUNE},
        "launches_frame": {f"{r['config']} {r['hw'][0]}x{r['hw'][1]} {r['dtype']}":
                           r["head_launches_per_frame"] for r in frames},
    }, *convs, *gathers, *probes]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']}: no launch on its path")
    print(json.dumps({"train": train}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"gate": {"train": gate_train,
                               **{k: gate[k] for k in ("rows", *bf16_gate.SUMMARY)},
                               "diagnostics": diagnostics, "lpips": lpips}}))
    print(json.dumps({"train_bf16": train16, "native": native}))
    print(json.dumps({"finetune": finetune}))
    print(json.dumps({"kernels": kernels}))
    if not gate["pass"]:
        raise AssertionError(
            f"8b: the bf16 gate failed: worst |gt_bf16 - gt_f32| "
            f"{gate['worst_gate_delta_bf16_trained']:.4f} dB > {gate['gate_bar']} dB")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
