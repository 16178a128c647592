"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device and build: the card's name and power limit, then the CUDA
     kernels built from this checkout's sources (build seconds, ptxas info);
  2. the bundle-head kernel against its plain PyTorch version on the card
     at the dtu_eval head shapes (N = 245,760 samples, V = 3; V = 2; a
     ragged N), in float32 and bf16, with both times;
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
nothing of jax or of the JAX package (gdb_nerf_tpu).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
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

# bf16 kernel vs the plain version in bf16 (PERF.md, "H100 port"): both use
# the head's bf16 weights (sigma's layer float32), but the plain version rounds
# every layer's output to bf16 while the kernel accumulates in float32 and
# rounds only feat.  Replayed on the CPU at these shapes the two differ by at
# most 0.0078 (2 bf16 ulps at 1.0) in feat and 0.0012 in sigma; the bound
# leaves ~4x room.
BF16_ATOL = 0.03
F32_ATOL = F32_RTOL = 1e-4
REQUESTS = 5


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


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def golden_state_dict():
    import torch

    g = np.load(GOLDEN)
    return g, {k[3:]: torch.from_numpy(np.array(g[k])) for k in g.files if k.startswith("sd/")}


def phase_device_and_build():
    import torch

    from gdb_nerf_tpu_torch.kernels.bundle_head import BundleHeadKernel

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this smoke needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    kernel = BundleHeadKernel()
    t0 = time.time()
    kernel.load()
    print(f"[build] bundle_head built and loaded in {time.time() - t0:.1f} s")
    for line in kernel.build_log.splitlines():
        if any(k in line for k in ("entry function", "registers", "spill", "smem")):
            print(f"[build] {line.strip()}")
    return kernel


def phase_kernel_vs_plain(kernel, heads):
    """K1 against bundle_head_reference on the card, each dtype with its own
    head (``heads[dtype]``).  Returns the JSON fields."""
    import torch

    from gdb_nerf_tpu_torch.kernels.bundle_head import bundle_head_reference

    gen = torch.Generator(device="cuda").manual_seed(0)
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
                    ms = cuda_ms(lambda: kernel.launch(packed, vox, payload, frd), 20)
                    plain_ms = cuda_ms(lambda: bundle_head_reference(head, vox, payload, frd), 20)
                line += f" kernel {ms:.4f} ms plain {plain_ms:.4f} ms"
                if dt == torch.float32:
                    result = {"max_abs_err": max(err_s, err_f), "ms": ms, "plain_ms": plain_ms}
            print(line)
            if not ok:
                raise AssertionError(f"bundle_head kernel disagrees with its plain version: {line}")
    return result


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

    kernel = phase_device_and_build()
    g, sd = golden_state_dict()

    # Each dtype's head as its network holds it (bf16 weights, sigma float32).
    heads = {getattr(torch, dt): build_renderer(dt, sd).network.nerf
             for dt in ("float32", "bfloat16")}
    k1 = phase_kernel_vs_plain(kernel, heads)
    rgb = phase_golden(g, sd)
    launches = phase_serve(g, sd, rgb)
    print(json.dumps({"kernels": [{
        "name": "bundle_head", "route": "cuda",
        "source": "gdb_nerf_tpu_torch/csrc/bundle_head.cu",
        "replaces": "gdb_nerf_tpu/ops/pallas/fused_nerf.py:89",
        "launches": launches, **k1,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
