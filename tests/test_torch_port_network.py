"""The port's full eval forward against the golden render and the JAX Network.

(a) At the real dtu_eval widths (num_depth [64, 8], adaptive, S = 3,
    dec_layers 3) on the golden fixture's batch (128x160) and weights:
    rgb agreement > 40 dB with the frozen render and the MVS depth check of
    tests/test_golden_protocol.py.
(b) Against the JAX Network at a small config (B=1, V=2, 64x64,
    num_depth (16, 8), S=3, adaptive) with JAX random weights (BatchNorm
    statistics randomized) carried over by state_dict_from_jax: rgb
    PSNR >= 60 dB, mvs_depth and nerf_depth relative L1 <= 1e-4.
Both run the plain PyTorch path on the CPU in float32.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gdb_nerf_tpu_torch.models.network import Network
from gdb_nerf_tpu_torch.utils.convert import state_dict_from_jax

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "dtu_eval_golden.npz")


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-20))


def torch_batch(batch: dict) -> dict:
    return {k: torch_batch(v) if isinstance(v, dict) else torch.from_numpy(np.asarray(v))
            for k, v in batch.items()}


@torch.no_grad()
def test_port_matches_golden_render_at_dtu_eval_widths():
    g = np.load(GOLDEN)
    sd = {k[3:]: torch.from_numpy(np.array(g[k])) for k in g.files if k.startswith("sd/")}
    net = Network(mvs_num_depth=(64, 8), max_num_samples=3, is_adaptive=True,
                  global_num_depth=64, dec_layers=3).eval()
    net.load_state_dict(sd, strict=True)
    batch = torch_batch({
        "src_views": {"rgb": g["batch/src_rgb"], "extrinsics": g["batch/src_ext"],
                      "intrinsics": g["batch/src_int"]},
        "tar_views": {"extrinsics": g["batch/tar_ext"], "intrinsics": g["batch/tar_int"]},
        "near_far": g["batch/near_far"],
    })
    ret, _ = net(batch)
    assert net.nerf.kernel.launches == 0  # CPU tensors take the plain path
    rgb = np.clip(ret["rgb"].numpy(), 0.0, 1.0)
    agree = psnr(rgb, np.clip(g["golden/rgb"], 0.0, 1.0))
    assert agree > 40.0, f"agreement {agree:.1f} dB vs the frozen render"
    np.testing.assert_allclose(ret["mvs_depth"].numpy(), g["golden/mvs_depth"], rtol=1e-2, atol=1e-2)


def small_batch(rng, V=2, H=64, W=64):
    """The JAX package's tests/test_models.py::make_synthetic_batch rig, numpy."""
    K = np.array([[2.0 * W, 0, W / 2], [0, 2.0 * W, H / 2], [0, 0, 1]], np.float32)

    def cam(dx):
        ext = np.eye(4, dtype=np.float32)
        ext[0, 3], ext[2, 3] = dx, 4.0
        return ext

    return {
        "src_views": {
            "rgb": rng.uniform(0, 1, (1, V, H, W, 3)).astype(np.float32),
            "extrinsics": np.stack([cam(-0.3 + 0.6 * v / max(V - 1, 1)) for v in range(V)])[None],
            "intrinsics": np.stack([K] * V)[None],
        },
        "tar_views": {"extrinsics": cam(0.05)[None], "intrinsics": K[None]},
        "near_far": np.array([[2.5, 6.0]], np.float32),
    }


def randomize_batch_stats(tree, rng):
    """Non-trivial BatchNorm statistics, so their mapping is exercised."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize_batch_stats(v, rng)
        elif k == "mean":
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        else:
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return out


def rel_l1(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / np.abs(b).sum())


@torch.no_grad()
def test_port_matches_jax_network_small_config(rng):
    flags = sorted(k for k in os.environ if k.startswith("GDBN_"))
    assert not flags, f"GDBN_* variables change the JAX reference: {flags}"
    from gdb_nerf_tpu.models.network import Network as JaxNetwork

    kw = dict(mvs_num_depth=(16, 8), max_num_samples=3, is_adaptive=True, global_num_depth=64)
    batch = small_batch(rng)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jnet = JaxNetwork(**kw)
    # Initialized with train=True so the tree holds the stage NeRF too.
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k, b: jnet.init(k, b, train=True))(jax.random.PRNGKey(0), jbatch))
    variables = {"params": variables["params"],
                 "batch_stats": randomize_batch_stats(variables["batch_stats"], rng)}
    ret_j, _, _ = jax.jit(lambda v, b: jnet.apply(v, b, train=False))(variables, jbatch)

    net = Network(**kw).eval()
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    ret, _ = net(torch_batch(batch))

    agree = psnr(ret["rgb"].numpy(), ret_j["rgb"])
    assert agree >= 60.0, f"rgb agreement {agree:.1f} dB vs the JAX Network"
    for key in ("mvs_depth", "nerf_depth"):
        err = rel_l1(ret[key].numpy(), ret_j[key])
        assert err <= 1e-4, f"{key} relative L1 {err:.2e}"


@torch.no_grad()
def test_bf16_network_casts_its_feature_path_once(rng):
    """compute_dtype bf16: the feature path's conv and linear weights are
    bf16 from the start (no cast per call); BatchNorm, the density layer and
    the decoder's output conv stay float32.  A float32 state dict loads into
    it strictly, and its render stays within 45 dB of the float32 one (59 dB
    measured at this size)."""
    kw = dict(mvs_num_depth=(16, 8), max_num_samples=3, is_adaptive=True, global_num_depth=64)
    torch.manual_seed(0)
    net32 = Network(**kw).eval()
    net16 = Network(**kw, compute_dtype=torch.bfloat16).eval()
    net16.load_state_dict(net32.state_dict(), strict=True)
    bn = (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d)
    expect_fp32 = {f"{name}.{p}" for name, m in net16.named_modules() if isinstance(m, bn)
                   for p in ("weight", "bias", "running_mean", "running_var")}
    expect_fp32 |= {f"{m}.{p}" for m in ("nerf.sigma.0", "upsampler.out_conv")
                    for p in ("weight", "bias")}
    floats = {k: v.dtype for k, v in net16.state_dict().items() if v.is_floating_point()}
    assert {k for k, dt in floats.items() if dt == torch.float32} == expect_fp32
    assert all(dt == torch.bfloat16 for k, dt in floats.items() if k not in expect_fp32)
    batch = torch_batch(small_batch(rng))
    ret32, _ = net32(batch)
    ret16, _ = net16(batch)
    for key, v in ret16.items():
        assert v.dtype == torch.float32 and torch.isfinite(v).all(), key
    agree = psnr(ret16["rgb"].numpy(), ret32["rgb"].numpy())
    assert agree >= 45.0, f"bf16 vs float32 rgb {agree:.1f} dB"
    assert net16.nerf.kernel.launches == 0


def test_cli_renders_requests_on_cpu():
    """The port's CLI end to end on the CPU, at a small synthetic frame."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, "-m", "gdb_nerf_tpu_torch.run", "--type", "network",
           "--cfg_file", "configs/dtu_eval.yaml", "synthetic", "True",
           "synthetic_hw", "[64,128]", "device", "cpu"]
    out = subprocess.run(cmd, cwd=repo, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "workspace": os.path.join(repo, "build", "workspace")})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Mean forward latency:" in out.stdout and "over 7 batches (cpu" in out.stdout
    if not torch.cuda.is_available():  # the default device is cuda: no silent CPU run
        out = subprocess.run(cmd[:-2], cwd=repo, capture_output=True, text=True, timeout=600)
        assert out.returncode != 0 and "CUDA is not available" in out.stderr
