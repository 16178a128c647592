"""The port's full eval forward against the golden render and the JAX Network.

(a) At the real dtu_eval widths (num_depth [64, 8], adaptive, S = 3,
    dec_layers 3) on the golden fixture's batch (128x160) and weights:
    rgb agreement > 40 dB with the frozen render and the MVS depth check of
    tests/test_golden_protocol.py.
(b) Against the JAX Network at a small config (B=1, V=2, 64x64,
    num_depth (16, 8), S=3, adaptive) with JAX random weights (BatchNorm
    statistics randomized) carried over by state_dict_from_jax: rgb
    PSNR >= 60 dB, mvs_depth and nerf_depth relative L1 <= 1e-4, and with
    ``debug_outputs`` on both sides each bundle's sample count ``spb``
    equal, as integers.  Again
    with the other eval configs' flags in one case: reweighting
    (llff_eval, nerf_eval) with S = 6 (nerf_eval), V = 4, B = 2 and render
    slabs of 256 bundles (nerf_chunk_size) at 64x96.
Both run the plain PyTorch path on the CPU in float32.

(b)'s two JAX references trace and compile in threads of their own, and the
CLI test's interpreter runs beside them (``started_early``, set up by the
bf16 test, which runs beside them at 2 torch threads: at 8 it and the
compiles slow each other).
"""

import dataclasses
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdb_nerf_tpu_torch.kernels.bundle_head import LAUNCHES
from gdb_nerf_tpu_torch.models.network import Network
from gdb_nerf_tpu_torch.runtime import tracing
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
    with tracing.recording() as rec:
        ret, _, _ = net(batch)
    assert rec.counter(LAUNCHES) == 0  # CPU tensors take the plain path
    rgb = np.clip(ret["rgb"].numpy(), 0.0, 1.0)
    agree = psnr(rgb, np.clip(g["golden/rgb"], 0.0, 1.0))
    assert agree > 40.0, f"agreement {agree:.1f} dB vs the frozen render"
    np.testing.assert_allclose(ret["mvs_depth"].numpy(), g["golden/mvs_depth"], rtol=1e-2, atol=1e-2)


def small_batch(rng, V=2, H=64, W=64, B=1):
    """The JAX package's tests/test_models.py::make_synthetic_batch rig,
    numpy; with B > 1 each item's target camera moves 0.03 further, never
    onto a source camera (there the ray-difference direction normalizes a
    zero vector, and the two packages' roundings of it differ)."""
    K = np.array([[2.0 * W, 0, W / 2], [0, 2.0 * W, H / 2], [0, 0, 1]], np.float32)

    def cam(dx):
        ext = np.eye(4, dtype=np.float32)
        ext[0, 3], ext[2, 3] = dx, 4.0
        return ext

    src = np.stack([cam(-0.3 + 0.6 * v / max(V - 1, 1)) for v in range(V)])
    return {
        "src_views": {
            "rgb": rng.uniform(0, 1, (B, V, H, W, 3)).astype(np.float32),
            "extrinsics": np.stack([src] * B),
            "intrinsics": np.stack([np.stack([K] * V)] * B),
        },
        "tar_views": {"extrinsics": np.stack([cam(0.05 + 0.03 * b) for b in range(B)]),
                      "intrinsics": np.stack([K] * B)},
        "near_far": np.array([[2.5, 6.0]] * B, np.float32),
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


# XLA's backend optimizations off for the JAX reference: it compiles in
# about two thirds of the time (CPU) and computes the same functions.
XLA_O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def run_jitted(fn, *args, options=None):
    """``jax.jit(fn)(*args)``, compiled with ``XLA_O0`` and ``options``."""
    return jax.jit(fn).lower(*args).compile({**XLA_O0, **(options or {})})(*args)


_TREES: dict = {}


def jax_variables(jnet, jbatch, rng) -> dict:
    """Random weights in the JAX Network's variable tree, without compiling
    its init: the tree (of ``init(..., train=True)``, so it holds the stage
    NeRF; traced on the first item in one slab, which changes no shape in
    it) comes from ``jax.eval_shape``, traced once a process for each set
    of variable paths and shapes (read, without a trace, from the port's
    network of the same flags through ``tools/convert_checkpoint.py``:
    flags that change no shape share a tree); each kernel is drawn as
    flax's lecun_normal draws it (a normal truncated at two deviations,
    scaled to variance 1 / fan_in), biases are 0 and BatchNorm scales 1, as
    flax initializes them; the BatchNorm statistics are randomized."""
    import inspect

    from tools.convert_checkpoint import convert

    flags = {k: getattr(jnet, k) for k in inspect.signature(Network).parameters
             if k != "compute_dtype" and hasattr(jnet, k)}
    converted = convert({k: v.numpy() for k, v in Network(**flags).state_dict().items()},
                        num_stages=len(jnet.mvs_vol_levels), dec_layers=jnet.dec_layers)
    key = tuple((jax.tree_util.keystr(p), np.shape(v))
                for p, v in jax.tree_util.tree_flatten_with_path(converted)[0])
    if key not in _TREES:
        one = dataclasses.replace(jnet, nerf_chunk_size=0)
        _TREES[key] = jax.eval_shape(lambda b: one.init(jax.random.PRNGKey(0), b, train=True),
                                     jax.tree_util.tree_map(lambda a: a[:1], jbatch))
    tree = _TREES[key]

    def draw(path, leaf):
        if path[-1].key != "kernel":
            return (np.ones if path[-1].key == "scale" else np.zeros)(leaf.shape, np.float32)
        x = rng.standard_normal(leaf.shape)
        while (out := np.abs(x) > 2.0).any():
            x[out] = rng.standard_normal(int(out.sum()))
        return (x / 0.8796256610342398 / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)

    return {"params": jax.tree_util.tree_map_with_path(draw, tree["params"]),
            "batch_stats": randomize_batch_stats(tree["batch_stats"], rng)}


_INITS: dict = {}


def jax_init(jnet, inputs, rng):
    """The JAX Network's own initial parameters (seed 0) and randomized
    BatchNorm statistics.  The parameters do not depend on the batch's
    shapes, so each network's are computed once a process (the train-step
    and 2-rank cases share them, through this module's ``tests.`` name).
    Not ``jax_variables``: with its numpy draw of the same distribution the
    gradients of a train step differ from the JAX package's by up to 5.9e-3
    relative L2 (ROADMAP queue 3)."""
    key = repr(jnet)
    if key not in _INITS:
        _INITS[key] = jax.tree_util.tree_map(np.asarray, run_jitted(
            lambda k, b: jnet.init(k, b, train=True), jax.random.PRNGKey(0), inputs))
    variables = _INITS[key]
    return variables["params"], randomize_batch_stats(variables["batch_stats"], rng)


def rel_l1(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).sum() / np.abs(b).sum())


def jax_network_ref(rng, batch, **kw):
    """The JAX Network of flags ``kw`` on ``batch``, with random weights drawn
    from ``rng`` (BatchNorm statistics randomized) -> (variables, ret)."""
    flags = sorted(k for k in os.environ if k.startswith("GDBN_"))
    assert not flags, f"GDBN_* variables change the JAX reference: {flags}"
    from gdb_nerf_tpu.models.network import Network as JaxNetwork

    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    jnet = JaxNetwork(**kw)
    variables = jax_variables(jnet, jbatch, rng)
    ret_j, _, _ = run_jitted(lambda v, b: jnet.apply(v, b, train=False), variables, jbatch)
    return variables, ret_j


def assert_port_matches_jax_network(batch, variables, ret_j, **kw):
    """The port with the JAX Network's ``variables`` on ``batch`` against the
    JAX Network's render ``ret_j`` (``jax_network_ref``): rgb >= 60 dB,
    mvs_depth and nerf_depth within 1e-4 relative L1; with ``debug_outputs``
    in ``kw``, ``spb`` (the port's int32, the JAX Network's float counts)
    equal."""
    net = Network(**kw).eval()
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    ret, _, _ = net(torch_batch(batch))

    agree = psnr(ret["rgb"].numpy(), ret_j["rgb"])
    assert agree >= 60.0, f"rgb agreement {agree:.1f} dB vs the JAX Network"
    for key in ("mvs_depth", "nerf_depth"):
        err = rel_l1(ret[key].numpy(), ret_j[key])
        assert err <= 1e-4, f"{key} relative L1 {err:.2e}"
    assert ("spb" in ret) == ("spb" in ret_j) == bool(kw.get("debug_outputs"))
    if "spb" in ret:
        spb_j = np.asarray(ret_j["spb"])
        assert ret["spb"].dtype == torch.int32 and np.array_equal(spb_j, np.round(spb_j))
        differ = int((ret["spb"].numpy() != spb_j).sum())
        assert differ == 0, f"spb differs at {differ} of {spb_j.size} bundles"


def small_config_case():
    """(b) at the small config, from seed 0: (rng, batch, flags)."""
    rng = np.random.default_rng(0)
    return rng, small_batch(rng), dict(
        mvs_num_depth=(16, 8), max_num_samples=3, is_adaptive=True, global_num_depth=64,
        debug_outputs=True)


def other_eval_flags_case():
    """(b) at the other eval configs' flags, from seed 0: reweighting, S = 6,
    V = 4, B = 2 and slabs of 256 bundles."""
    rng = np.random.default_rng(0)
    return rng, small_batch(rng, V=4, H=64, W=96, B=2), dict(
        mvs_num_depth=(16, 8), max_num_samples=6, is_adaptive=True, global_num_depth=64,
        reweighting=True, nerf_chunk_size=256, debug_outputs=True)


PARITY_CASES = {"small": small_config_case, "other_flags": other_eval_flags_case}


@pytest.fixture
def beside_the_compiles():
    """Torch at 2 intra-op threads while the JAX references compile."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def started_early():
    """Each parity case's (batch, flags, future JAX reference), the references
    traced and compiled in threads of their own, and the CLI test's
    interpreter (``"cli"``), all started together."""
    with ThreadPoolExecutor(len(PARITY_CASES)) as pool:
        early = {}
        for name, case in PARITY_CASES.items():
            rng, batch, kw = case()
            early[name] = (batch, kw, pool.submit(jax_network_ref, rng, batch, **kw))
        early["cli"] = Clis(*cli_commands())
        try:
            yield early
        finally:
            early["cli"].kill()


@torch.no_grad()
def test_bf16_network_casts_its_feature_path_once(rng, started_early, beside_the_compiles):
    """compute_dtype bf16: the feature path's conv and linear weights are
    bf16 from the start (no cast per call); BatchNorm, the density layers
    (the bundle head's and each stage NeRF's) and the decoder's output conv
    stay float32.  A float32 state dict loads into
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
    expect_fp32 |= {f"{m}.{p}" for m in ("nerf.sigma.0", "depth_net.nerfs.0.sigma.0",
                                         "upsampler.out_conv")
                    for p in ("weight", "bias")}
    floats = {k: v.dtype for k, v in net16.state_dict().items() if v.is_floating_point()}
    assert {k for k, dt in floats.items() if dt == torch.float32} == expect_fp32
    assert all(dt == torch.bfloat16 for k, dt in floats.items() if k not in expect_fp32)
    batch = torch_batch(small_batch(rng))
    ret32, _, _ = net32(batch)
    with tracing.recording() as rec:
        ret16, _, _ = net16(batch)
    for key, v in ret16.items():
        assert v.dtype == torch.float32 and torch.isfinite(v).all(), key
    agree = psnr(ret16["rgb"].numpy(), ret32["rgb"].numpy())
    assert agree >= 45.0, f"bf16 vs float32 rgb {agree:.1f} dB"
    assert rec.counter(LAUNCHES) == 0



@torch.no_grad()
def test_port_matches_jax_network_small_config(started_early):
    batch, kw, ref = started_early["small"]
    assert_port_matches_jax_network(batch, *ref.result(), **kw)


@torch.no_grad()
def test_port_matches_jax_network_at_the_other_eval_flags(started_early):
    """Reweighting, S = 6, V = 4, B = 2 and slabs of 256 bundles, in one case
    (``spb`` concatenated over the slabs)."""
    batch, kw, ref = started_early["other_flags"]
    assert Network(nerf_chunk_size=256).num_chunks(32, 48) == 8
    assert_port_matches_jax_network(batch, *ref.result(), **kw)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Runs CLI commands (module, argv) one after another in one interpreter, as
# ``python -m module argv...`` would, and reports each one's exit code,
# standard output and standard error (with the message of a SystemExit, or
# the traceback of an error, as python prints them).
_CLI_RUNNER = """
import contextlib, io, json, runpy, sys, traceback
report = []
for module, argv in json.loads(sys.argv[1]):
    out, err, code = io.StringIO(), io.StringIO(), 0
    sys.argv = [module, *argv]
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            runpy.run_module(module, run_name="__main__", alter_sys=True)
        except SystemExit as e:
            if isinstance(e.code, str):
                print(e.code, file=sys.stderr)
            code = e.code if isinstance(e.code, int) else int(e.code is not None)
        except BaseException:
            traceback.print_exc()
            code = 1
    report.append({"returncode": code, "stdout": out.getvalue(), "stderr": err.getvalue()})
print(json.dumps(report))
"""


class Clis:
    """Each (module, argv) of ``commands`` started in one fresh interpreter in
    the repo's root, one after another; ``.result()`` waits for them."""

    def __init__(self, commands, env=None, timeout=600):
        import json

        self.timeout = timeout
        self.proc = subprocess.Popen([sys.executable, "-c", _CLI_RUNNER, json.dumps(commands)],
                                     cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True, env=env)

    def result(self) -> list:
        """Wait for the commands: one namespace (returncode, stdout, stderr)
        each."""
        import json
        from types import SimpleNamespace

        try:
            out, err = self.proc.communicate(timeout=self.timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            raise
        assert self.proc.returncode == 0, err[-3000:]
        return [SimpleNamespace(**r) for r in json.loads(out.splitlines()[-1])]

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def cli_commands():
    """The CLI test's commands and environment: a small synthetic frame on the
    CPU, and (without a GPU) the same without ``device cpu``, which must
    stop."""
    args = ["--type", "network", "--cfg_file", "configs/dtu_eval.yaml", "synthetic", "True",
            "synthetic_hw", "[64,128]", "device", "cpu"]
    commands = [("gdb_nerf_tpu_torch.run", args)]
    if not torch.cuda.is_available():  # the default device is cuda: no silent CPU run
        commands.append(("gdb_nerf_tpu_torch.run", args[:-2]))
    return commands, {**os.environ, "workspace": os.path.join(REPO, "build", "workspace")}


def test_cli_renders_requests_on_cpu(started_early):
    """The port's CLI end to end on the CPU, at a small synthetic frame."""
    outs = started_early["cli"].result()
    out = outs[0]
    assert out.returncode == 0, out.stderr[-2000:]
    assert "Mean forward latency:" in out.stdout and "over 7 batches (cpu" in out.stdout
    if len(outs) > 1:
        assert outs[1].returncode != 0 and "CUDA is not available" in outs[1].stderr
