"""The port's training path against the JAX package's, on the CPU.

* One train step of the whole network, in float32 and in bf16 (float32
  master weights): the JAX Network's loss, gradients and one adam step
  (``make_loss_fn``, ``make_optimizer``) against the port's (``train.step``)
  at 64x64, B = 1, V = 3, with dtu_pretrain's flags at ``mvs_num_depth (16,
  8)``, the same weights through ``state_dict_from_jax`` and randomized
  BatchNorm statistics; the two JAX steps trace and compile side by side,
  in threads.  The stage NeRF's density and view weights in bf16 against the
  JAX ``StageNeRF``.
* The losses, every LR schedule and every optimizer with its clip against
  the JAX package's.
* Checkpoints: resuming is bit-exact in both dtypes, a bf16 training's
  checkpoint holds float32 and loads into both eval dtypes, and under a config with another LR
  takes the new schedule from its first step, ``load_model`` picks the file the JAX
  loader picks, retention stops at 100 files, ``load_pretrain`` reads
  another experiment's ``latest.pth``; the per-scene fine-tune
  (``configs/dtu/scan114.yaml``) warm-starts through ``train_net`` by both
  routes at the JAX ``train_net.py``'s epoch and LR.
* ``train_net``, ``run --type evaluate`` and ``tools/measure_train_step``
  end to end on the CPU.
"""

import contextlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import grad_groups, group_rel_l2
from gdb_nerf_tpu.train import losses as jax_losses
from gdb_nerf_tpu.train import optim as jax_optim
from gdb_nerf_tpu.train.step import make_loss_fn as jax_make_loss_fn
from gdb_nerf_tpu.utils import checkpoint as jax_checkpoint
from gdb_nerf_tpu_torch.models.network import Network
from gdb_nerf_tpu_torch.train import losses, optim
from gdb_nerf_tpu_torch.train.step import make_train_step, to_device_train
from gdb_nerf_tpu_torch.utils import checkpoint
from gdb_nerf_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_port_network import Clis, jax_init, psnr, run_jitted, small_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# configs/dtu_pretrain.yaml's network flags, at 16 first-stage planes.
PRETRAIN_NET = dict(mvs_num_depth=(16, 8), max_num_samples=6, is_adaptive=False,
                    global_num_depth=64, mvs_num_samples=(8,))


def optim_cfg(optim_name="adam", weight_decay=0.0, scheduler=None, lr=5e-4, ep_iter=1000):
    scheduler = scheduler or SimpleNamespace(type="exponential", gamma=0.5, decay_epochs=50)
    return SimpleNamespace(ep_iter=ep_iter, train=SimpleNamespace(
        lr=lr, optim=optim_name, weight_decay=weight_decay, eps=1e-8, scheduler=scheduler))


def train_batch(rng, B=1, V=3, H=64, W=64):
    """``small_batch`` with the supervision of the synthetic loader: the
    target image, its subsampled copies and a constant depth at the two
    stage scales, masks of ones."""
    batch = small_batch(rng, V=V, H=H, W=W, B=B)
    tar = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    batch["tar_views"]["rgb"] = tar
    batch["tar_gt_ms"] = {"rgb": [], "depth": [], "mask": []}
    for k in (8, 2):
        batch["tar_gt_ms"]["rgb"].append(tar[:, ::k, ::k])
        batch["tar_gt_ms"]["depth"].append(np.full((B, H // k, W // k), 4.0, np.float32))
        batch["tar_gt_ms"]["mask"].append(np.ones((B, H // k, W // k), np.float32))
    return batch


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


DTYPES = ("float32", "bfloat16")

# The bf16 reference: the JAX package's bf16 step computed as the port
# computes bf16 (ROADMAP queue 3 has the measurements).  At this size the JAX
# bf16 step differs from the port's by about as much as from its own float32
# step, for four reasons, none of them a cast of the port's; the reference
# takes out each, for the trace of its step only (``port_bf16_numerics``):
# * BatchNorm on batch statistics at B = 1 amplifies any change of rounding
#   (1 CPU thread against 8 moves the port's bf16 step by 4.7e-2 in the FPN's
#   and U-Nets' gradients); on running statistics the step is stable to
#   1e-7.  The reference's BatchNorms, and the port's, use running statistics.
# * XLA's CPU backend keeps float32 where the program rounds to bf16
#   (``xla_allow_excess_precision``, on by default); compiled with it off,
#   the JAX bf16 FPN equals the port's bit for bit.
# * XLA's CPU backend sums a bf16 cotangent in bf16 where autodiff transposes
#   a broadcast, so the JAX bf16 step's bias gradients stand 3.8e-1 relative
#   L2 from its float32 ones; the reference sums in float32 and rounds once,
#   as torch does (4.6e-3).
# * The JAX package interpolates its bilinear tables (cost-volume warp,
#   volume lookups, mip pyramid, source images) in bf16; the port samples
#   them in float32 from their bf16 values (models/network.py).
_PORT_NUMERICS = threading.local()


class _FlaxWithRunningStats:
    """``flax.linen`` as ``gdb_nerf_tpu.models.layers`` sees it, except that
    a BatchNorm made under ``port_bf16_numerics`` uses running statistics."""

    def __getattr__(self, name):
        return getattr(flax.linen, name)

    @staticmethod
    def BatchNorm(**kwargs):
        if "running_stats" in getattr(_PORT_NUMERICS, "on", ()):
            kwargs.update(use_running_average=True, axis_name=None)
        return flax.linen.BatchNorm(**kwargs)


def _under_port_numerics(control, orig, wrapped):
    def call(*args, **kwargs):
        on = control in getattr(_PORT_NUMERICS, "on", ())
        return (wrapped if on else orig)(*args, **kwargs)

    return call


@contextlib.contextmanager
def port_bf16_numerics(running_stats=True, f32_sums=True, f32_tables=True):
    """Trace the JAX package's Network, in this thread, with BatchNorm on
    running statistics, bf16 cotangents summed in float32 and its bilinear
    tables sampled in float32 (each where asked; see above); other threads
    trace it unchanged.  Nothing of the JAX package's files changes: module
    attributes are replaced for the duration and restored after, so one
    thread at a time may hold this context."""
    from jax._src.lax import lax as jlax

    from gdb_nerf_tpu.models import depth_net as jdepth_net
    from gdb_nerf_tpu.models import layers as jlayers
    from gdb_nerf_tpu.ops import bundles as jbundles
    from gdb_nerf_tpu.ops import cost_volume as jcost_volume
    from gdb_nerf_tpu.ops import mip as jmip

    f32 = jnp.float32
    cv, rs, gs3, enc, pyr = (jcost_volume.build_cost_volume, jlax.reduce_sum,
                             jdepth_net.grid_sample_3d, jbundles.encode_samples,
                             jmip.build_pyramid)

    def reduce_sum(x, axes, *args, **kwargs):
        if getattr(x, "dtype", None) != jnp.bfloat16:
            return rs(x, axes, *args, **kwargs)
        return rs(x.astype(f32), axes, *args, **kwargs).astype(x.dtype)

    def encode(rb, samples, images, img_feat, packed, offsets, volume, *rest):
        return enc(rb, samples, images.astype(f32), img_feat.astype(f32), packed.astype(f32),
                   offsets, volume.astype(f32), *rest)

    patches = [
        (jlayers, "nn", _FlaxWithRunningStats()),
        (jlax, "reduce_sum", _under_port_numerics("f32_sums", rs, reduce_sum)),
        (jcost_volume, "build_cost_volume", _under_port_numerics(
            "f32_tables", cv, lambda f, *a, **k: cv(f.astype(f32), *a, **k).astype(f.dtype))),
        (jdepth_net, "grid_sample_3d", _under_port_numerics(
            "f32_tables", gs3, lambda v, *a, **k: gs3(v.astype(f32), *a, **k))),
        (jbundles, "encode_samples", _under_port_numerics("f32_tables", enc, encode)),
        (jmip, "build_pyramid", _under_port_numerics(
            "f32_tables", pyr, lambda t, n: pyr(t.astype(f32), n))),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, new in patches:
        setattr(mod, name, new)
    flags = {"running_stats": running_stats, "f32_sums": f32_sums, "f32_tables": f32_tables}
    _PORT_NUMERICS.on = {k for k, v in flags.items() if v}
    try:
        yield
    finally:
        _PORT_NUMERICS.on = ()
        for mod, name, old in saved:
            setattr(mod, name, old)


def jax_step(compute_dtype, params, batch_stats, jbatch, numerics=None):
    """One JAX train step of the Network in ``compute_dtype`` -> numpy (loss,
    stats, grads, new batch_stats, params after the step, rgb, the stage
    renders).  float32: ``make_loss_fn``, then ``make_optimizer``'s adam.
    bfloat16: ``make_loss_fn`` under ``port_bf16_numerics``, compiled with
    ``xla_allow_excess_precision`` off, and no optimizer (its parameters
    after the step come back None).  ``numerics`` ({"excess_precision":
    bool, and ``port_bf16_numerics``' keywords}) sets those controls for
    either dtype instead, as ``main`` does."""
    from gdb_nerf_tpu.models.network import Network as JaxNetwork

    jnet = JaxNetwork(**PRETRAIN_NET, compute_dtype=compute_dtype)
    tx = jax_optim.make_optimizer(optim_cfg())
    outputs_j = []

    class Capture:
        """The network as the JAX loss sees it, keeping the forward's outputs."""

        def apply(self, *args, **kwargs):
            out = jnet.apply(*args, **kwargs)
            outputs_j.append(out[0])
            return out

    loss_fn = jax_make_loss_fn(Capture(), [0.05], use_perceptual=False)

    def loss_and_outputs(params, batch_stats, batch):
        loss, aux = loss_fn(params, batch_stats, batch)
        ret, _, blend = outputs_j.pop()
        return loss, (aux, ret["rgb"], blend)

    def step(params, batch_stats, batch):
        (loss, ((new_bs, stats), rgb, blend)), grads = jax.value_and_grad(
            loss_and_outputs, has_aux=True)(params, batch_stats, batch)
        after = None
        if compute_dtype == "float32" and numerics is None:
            updates, _ = tx.update(grads, tx.init(params), params)
            after = optax.apply_updates(params, updates)
        return loss, stats, grads, new_bs, after, rgb, blend

    if numerics is None and compute_dtype == "float32":
        out = run_jitted(step, params, batch_stats, jbatch)
    else:
        controls = dict(numerics or {})
        excess = controls.pop("excess_precision", False)
        with port_bf16_numerics(**controls):
            out = run_jitted(step, params, batch_stats, jbatch,
                             options={"xla_allow_excess_precision": excess})
    return jax.tree_util.tree_map(np.asarray, out)


_JAX_STEPS: dict = {}


def train_case():
    """The train-step case from seed 0: the batch (numpy and the JAX
    package's device form) and the JAX Network's init, float32, with
    randomized BatchNorm statistics."""
    from gdb_nerf_tpu.models.network import Network as JaxNetwork
    from gdb_nerf_tpu.train.step import to_device_train as jax_to_device_train

    rng = np.random.default_rng(0)
    batch = train_batch(rng)
    jbatch = jax_to_device_train(batch)
    inputs = {k: jbatch[k] for k in ("src_views", "tar_views", "near_far")}
    params, stats0 = jax_init(JaxNetwork(**PRETRAIN_NET), inputs, rng)
    return batch, jbatch, params, stats0


_JAX_STEPS_LOCK = threading.Lock()


def jax_steps() -> dict:
    """``train_case`` and the JAX step in each of ``DTYPES`` on it (the same
    init in both), made once for this module: the two steps trace and
    compile in threads, side by side."""
    with _JAX_STEPS_LOCK:
        if not _JAX_STEPS:
            batch, jbatch, params, stats0 = train_case()
            with ThreadPoolExecutor(len(DTYPES)) as pool:
                steps = dict(zip(DTYPES, pool.map(
                    lambda dt: jax_step(dt, params, stats0, jbatch), DTYPES)))
            _JAX_STEPS.update(batch=batch, params=params, stats0=stats0, steps=steps)
    return _JAX_STEPS


@pytest.fixture(scope="module", autouse=True)
def started_early(tmp_path_factory):
    """The module's two slow waits, started with its first test: the JAX
    steps (``jax_steps``) in a background thread, and the CLIs of
    ``test_train_net_and_evaluate_cli_on_cpu`` in their interpreter; the
    tests that need them wait for them.  An error in the background is
    raised again by the test's own call."""
    with ThreadPoolExecutor(1) as pool:
        future = pool.submit(jax_steps)
        _EARLY["workspace"] = tmp_path_factory.mktemp("train_clis")
        _EARLY["clis"] = Clis(*train_clis(str(_EARLY["workspace"])))
        try:
            yield
        finally:
            _EARLY.pop("clis").kill()
            future.exception()


_EARLY: dict = {}


def test_losses_match_jax(rng):
    """ssim and its gradient, photometric_loss and smooth_l1_depth within 1e-5."""
    a = rng.uniform(0, 1, (2, 24, 40, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    tb = torch.from_numpy(b).requires_grad_()
    s = losses.ssim(torch.from_numpy(a), tb)
    s.backward()
    s = s.detach()
    (s_j, g_j), want = run_jitted(
        lambda a, b: (jax.value_and_grad(lambda y: jax_losses.ssim(a, y))(b),
                      jax_losses.photometric_loss(a, b, (1.0, 0.1, 0.0))),
        jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(float(s), float(s_j), rtol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-8)
    got = losses.photometric_loss(torch.from_numpy(a), torch.from_numpy(b), (1.0, 0.1, 0.0))
    np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want], rtol=1e-5)
    est = [rng.uniform(0, 3, (2, 6, 8)).astype(np.float32) for _ in range(2)]
    gt = [rng.uniform(0, 3, (2, 6, 8)).astype(np.float32) for _ in range(2)]
    masks = [(rng.uniform(size=(2, 6, 8)) > 0.3).astype(np.float32) for _ in range(2)]
    t = [[torch.from_numpy(x) for x in xs] for xs in (est, gt, masks)]
    j = [[jnp.asarray(x) for x in xs] for xs in (est, gt, masks)]
    loss, stats = losses.smooth_l1_depth(*t, [1.0, 0.5])
    loss_j, stats_j = run_jitted(lambda *j: jax_losses.smooth_l1_depth(*j, [1.0, 0.5]), *j)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    assert stats.keys() == stats_j.keys()
    for k in stats:
        np.testing.assert_allclose(float(stats[k]), float(stats_j[k]), rtol=1e-5)


def test_vgg_perceptual_matches_jax(rng, tmp_path, monkeypatch, capsys):
    """A tiny random VGG-shaped ``vgg16.npz`` in a workspace: the same
    perceptual value (and photometric total) on both sides; without the
    file both give 0 and say so."""
    from tests.test_perceptual import _make_tiny_vgg

    _, weights = _make_tiny_vgg(rng)
    (tmp_path / "weights").mkdir()
    np.savez(tmp_path / "weights" / "vgg16.npz", **weights)
    a = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    b = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    for ws, present in ((tmp_path, True), (tmp_path / "none", False)):
        monkeypatch.setenv("workspace", str(ws))
        losses._vgg_weights.cache_clear()
        jax_losses._vgg_weights.cache_clear()
        try:
            got = losses.photometric_loss(torch.from_numpy(a), torch.from_numpy(b))
            want = jax_losses.photometric_loss(jnp.asarray(a), jnp.asarray(b))
        finally:
            losses._vgg_weights.cache_clear()
            jax_losses._vgg_weights.cache_clear()
        assert (float(got[3]) > 0.0) == present
        np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want],
                                   rtol=1e-5, atol=1e-7)
        if not present:
            out = capsys.readouterr().out
            assert out.count("perceptual term off") == 2


SCHEDULES = [
    SimpleNamespace(type="exponential", gamma=0.5, decay_epochs=2),
    SimpleNamespace(type="multi_step", milestones=[1, 2], gamma=0.5),
    SimpleNamespace(type="warmup_multi_step", milestones=[2], gamma=0.1, warmup_iters=5,
                    warmup_factor=0.25),
]


@pytest.mark.parametrize("sched", SCHEDULES, ids=[s.type for s in SCHEDULES])
def test_lr_schedules_match_jax(sched):
    """Every schedule type at steps 0 .. 3 * ep_iter, and the LR that
    ``StepSchedule`` gives optimizer step k is the schedule at k."""
    cfg = optim_cfg(scheduler=sched, lr=1e-3, ep_iter=4)
    fn, fn_j = optim.make_lr_schedule(cfg), jax_optim.make_lr_schedule(cfg)
    want = [float(fn_j(jnp.asarray(k))) for k in range(13)]
    np.testing.assert_allclose([fn(k) for k in range(13)], want, rtol=1e-6)
    opt, sched_t = optim.make_optimizer(cfg, [torch.nn.Parameter(torch.zeros(2))])
    used = []
    for _ in range(13):
        used.append(opt.param_groups[0]["lr"])
        opt.step()
        sched_t.step()
    assert used == [fn(k) for k in range(13)]


OPTIMIZERS = [("adam", 0.0), ("adam", 0.01), ("adamw", 0.01), ("radam", 0.0), ("sgd", 0.0)]


@pytest.mark.parametrize("name, wd, steps, rtol", [
    *((n, w, 3, 1e-6) for n, w in OPTIMIZERS), ("radam", 0.0, 7, 2e-5)],
    ids=[*(f"{n}-wd{w}" for n, w in OPTIMIZERS), "radam-rectified"])
def test_optimizers_match_the_optax_chain(name, wd, steps, rtol, rng):
    """The clip at 40 and each optimizer against the JAX package's optax
    chain over 3 steps, with a schedule that decays every step: within 1e-6
    relative.  Some gradient elements lie beyond the clip.  radam again over
    7 steps, past its rectification at step 6, within 2e-5: optax evaluates
    the SMA length in float32, where 1999 - 1993 cancels (its rectifier is
    0.18 % off at step 6; 5.1e-6 measured on the parameters, CPU)."""
    sched = SimpleNamespace(type="exponential", gamma=0.5, decay_epochs=1)
    cfg = optim_cfg(name, wd, sched, lr=1e-2, ep_iter=1)
    params = {"w": rng.normal(size=(4, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 30).astype(np.float32) for k, v in params.items()}
             for _ in range(steps)]
    assert max(np.abs(g["w"]).max() for g in grads) > 40.0
    tx = jax_optim.make_optimizer(cfg)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(pj)
    pt = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt, sched_t = optim.make_optimizer(cfg, list(pt.values()))
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, pj)
        pj = optax.apply_updates(pj, updates)
        for k, p in pt.items():
            p.grad = torch.from_numpy(g[k].copy())
        torch.nn.utils.clip_grad_value_(list(pt.values()), optim.CLIP_VALUE)
        opt.step()
        sched_t.step()
    for k, p in pt.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj[k]), rtol=rtol, atol=1e-7)


# Intra-op threads for the small CPU trainer steps below: at 64x64 they gain
# little from more, and a full set in each of several test processes at once
# oversubscribes the cores (a step then takes ~15 s in place of ~0.3 s).
FEW_THREADS = 2


@pytest.fixture
def few_threads():
    """Torch at most ``FEW_THREADS`` intra-op threads in the test, restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(FEW_THREADS, before))
    yield
    torch.set_num_threads(before)


def pretrain_cfg(ws, *opts):
    from gdb_nerf_tpu_torch.config import load_cfg

    return load_cfg(os.path.join(REPO, "configs", "dtu_pretrain.yaml"),
                    ["workspace", str(ws), "ep_iter", "3", *opts])


@pytest.mark.parametrize("dtype", DTYPES)
def test_resume_is_bit_exact(dtype, rng, tmp_path, few_threads):
    """Three trainer steps in one run, its state saved after the second
    (save_model, load_model) and loaded into a fresh trainer that takes the
    third: the same parameters, optimizer state and LR, bit for bit; in
    bf16 also the same float32 master weights."""
    from gdb_nerf_tpu_torch.runtime.registry import make_network
    from gdb_nerf_tpu_torch.train.trainer import Trainer

    cfg = pretrain_cfg(tmp_path, "mvs.num_depth", "[16,8]", "train.weight_decay", "0.01",
                       "compute_dtype", dtype)
    batches = [train_batch(rng, V=2) for _ in range(3)]

    def trainer():
        torch.manual_seed(0)
        return Trainer(cfg, make_network(cfg, torch.float32), "cpu")

    whole = trainer()
    assert (whole.mixed is None) == (dtype == "float32")
    for b in batches[:2]:
        whole.train_step(b)
    checkpoint.save_model(dict(whole.state_dict(), recorder={"step": 2}), cfg.trained_model_dir, 0)
    whole.train_step(batches[2])
    state, begin = checkpoint.load_model(cfg.trained_model_dir)
    assert begin == 1 and state["step"] == 2 and state["recorder"] == {"step": 2}
    resumed = trainer()
    resumed.load_state_dict(state)
    assert resumed.step == 2
    resumed.train_step(batches[2])
    assert resumed.step == whole.step == 3
    for (k, a), b in zip(whole.network.state_dict().items(), resumed.network.state_dict().values()):
        assert torch.equal(a, b), k
        assert not a.is_floating_point() or a.dtype == torch.float32, k
    sa, sb = whole.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert whole.scheduler.get_last_lr() == resumed.scheduler.get_last_lr()
    assert whole.optimizer.param_groups[0]["lr"] == resumed.optimizer.param_groups[0]["lr"]


def test_bf16_checkpoint_holds_float32_and_loads_into_both_eval_dtypes(rng, tmp_path,
                                                                     few_threads):
    """A bf16 training's checkpoint: float32 tensors under the float32
    network's keys, which load with strict=True into a float32 and a bf16
    eval network (``load_network``), the bf16 one holding them rounded; a
    network whose weights are already cast is refused as master weights.
    ``val`` renders through the step's bf16 compute copy, which then holds
    what the bf16 eval network of the checkpoint holds, and the trainer
    stays in training mode."""
    from gdb_nerf_tpu_torch.datasets import samplers, synthetic
    from gdb_nerf_tpu_torch.datasets.loader import DataLoader
    from gdb_nerf_tpu_torch.runtime.registry import make_evaluator, make_network
    from gdb_nerf_tpu_torch.train.trainer import Trainer
    from gdb_nerf_tpu_torch.utils.checkpoint import load_network

    cfg = pretrain_cfg(tmp_path, "mvs.num_depth", "[16,8]", "compute_dtype", "bfloat16")
    with pytest.raises(ValueError, match="float32 master weights"):
        Trainer(cfg, make_network(cfg), "cpu")
    torch.manual_seed(0)
    trainer = Trainer(cfg, make_network(cfg, torch.float32), "cpu")
    trainer.train_step(train_batch(rng, V=2))
    checkpoint.save_model(trainer.state_dict(), cfg.trained_model_dir, 0, last=True)
    saved = torch.load(os.path.join(cfg.trained_model_dir, "latest.pth"), weights_only=False)
    keys32 = Network(**PRETRAIN_NET).state_dict()
    assert list(saved["net"]) == list(keys32)
    for k, v in saved["net"].items():
        assert v.dtype == keys32[k].dtype, k
    for dt in ("float32", "bfloat16"):
        net = make_network(pretrain_cfg(tmp_path, "mvs.num_depth", "[16,8]", "compute_dtype", dt))
        net.load_state_dict(load_network(cfg.trained_model_dir)[0], strict=True)
        for k, v in net.state_dict().items():
            assert torch.equal(v, saved["net"][k].to(v.dtype)), (dt, k)
        assert dt == "float32" or net.nerf.lr0[0].weight.dtype == torch.bfloat16
    eval16 = net.state_dict()

    cfg_val = pretrain_cfg(tmp_path, "mvs.num_depth", "[16,8]", "compute_dtype", "bfloat16",
                           "synthetic", "True", "synthetic_hw", "[64,64]")
    requests = DataLoader(synthetic.Dataset(cfg_val, split="test", num_items=1),
                          samplers.EnerfBatchSampler(samplers.SequentialSampler(1), 1, False,
                                                     cfg_val.test.sampler_meta), num_workers=0)
    result = trainer.val(0, requests, make_evaluator(cfg_val))
    assert np.isfinite(result["psnr"]) and trainer.network.training
    assert trainer.val_network is trainer.mixed.compute and trainer.val_network.training
    assert trainer.val_network.compute_dtype == torch.bfloat16
    held = trainer.val_network.state_dict()
    assert held.keys() == eval16.keys()
    for k, v in eval16.items():
        assert v.dtype == held[k].dtype and torch.equal(v, held[k]), k


def test_resume_under_another_lr_takes_the_new_schedule(rng, tmp_path, few_threads):
    """Two steps at dtu_pretrain's lr 5e-4, save_model, then resume under a
    config with lr 5e-5: the first resumed step runs at the new schedule
    read at the restored count (step 2), as the JAX package's optax chain
    does, not at the LR stored with the checkpoint's optimizer; and the
    parameters after it equal the optax chains (make_optimizer of the first
    config for two steps, then of the second from the same optimizer state)
    fed the same gradients, within 1e-6."""
    from gdb_nerf_tpu_torch.runtime.registry import make_network
    from gdb_nerf_tpu_torch.train.trainer import Trainer

    opts = ("mvs.num_depth", "[16,8]")
    cfg_a = pretrain_cfg(tmp_path, *opts)
    cfg_b = pretrain_cfg(tmp_path, *opts, "train.lr", "5e-5")
    batches = [train_batch(rng, V=2) for _ in range(3)]

    def trainer(cfg):
        torch.manual_seed(0)
        return Trainer(cfg, make_network(cfg), "cpu")

    first = trainer(cfg_a)
    params0 = {k: p.detach().numpy().copy() for k, p in first.network.named_parameters()}
    grads = []
    for b in batches[:2]:
        first.train_step(b)
        grads.append({k: p.grad.numpy().copy() for k, p in first.network.named_parameters()})
    checkpoint.save_model(first.state_dict(), cfg_a.trained_model_dir, 0)
    state, _ = checkpoint.load_model(cfg_b.trained_model_dir)
    resumed = trainer(cfg_b)
    resumed.load_state_dict(state)
    lr = resumed.optimizer.param_groups[0]["lr"]
    want = float(jax_optim.make_lr_schedule(cfg_b)(jnp.asarray(2)))
    assert lr == pytest.approx(want, rel=1e-6), (lr, want)
    assert resumed.scheduler.get_last_lr() == [lr]
    resumed.train_step(batches[2])
    grads.append({k: p.grad.numpy().copy() for k, p in resumed.network.named_parameters()})

    # Every transform of the chain acts per element: one flat array stands
    # for the whole tree.
    def flat(tree):
        return jnp.asarray(np.concatenate([tree[k].ravel() for k in params0]))

    pj = flat(params0)
    tx_a, tx_b = jax_optim.make_optimizer(cfg_a), jax_optim.make_optimizer(cfg_b)
    opt_state = tx_a.init(pj)
    for tx, g in ((tx_a, grads[0]), (tx_a, grads[1]), (tx_b, grads[2])):
        updates, opt_state = tx.update(flat(g), opt_state, pj)
        pj = optax.apply_updates(pj, updates)
    got = {k: p.detach().numpy() for k, p in resumed.network.named_parameters()}
    np.testing.assert_allclose(np.asarray(flat(got)), np.asarray(pj), rtol=1e-6, atol=1e-7)


# (case, epochs on disk, latest file present, epoch asked for)
RESUME_CASES = [
    ("epoch files only", [3, 12, 7], False, -1),
    ("latest beside them", [3, 12], True, -1),
    ("explicit epoch", [3, 12], True, 3),
    ("no checkpoint", [], False, -1),
]


@pytest.mark.parametrize("case, epochs, latest, epoch", RESUME_CASES,
                         ids=[c[0] for c in RESUME_CASES])
def test_load_model_picks_the_file_the_jax_loader_picks(tmp_path, case, epochs, latest, epoch):
    """Each file holds its epoch as its weight (latest: 99, epoch 20)."""
    d_torch, d_jax = tmp_path / "torch", tmp_path / "jax"
    d_torch.mkdir()
    d_jax.mkdir()
    for e, last in [(e, False) for e in epochs] + ([(20, True)] if latest else []):
        w = 99 if last else e
        checkpoint.save_model({"net": {"w": torch.tensor(w)}}, str(d_torch), e, last=last)
        jax_checkpoint.save_model({"net": {"w": np.array(w)}}, str(d_jax), e, last=last)
    got, begin = checkpoint.load_model(str(d_torch), epoch=epoch)
    want, begin_j = jax_checkpoint.load_model(str(d_jax), epoch=epoch)
    assert begin == begin_j
    assert (got is None) == (want is None) == (not epochs), case
    if got is not None:
        assert int(got["net"]["w"]) == int(want["net"]["w"]) and got["epoch"] == want["epoch"]
    for d, load in ((d_torch, checkpoint.load_model), (d_jax, jax_checkpoint.load_model)):
        assert load(str(d), resume=False) == (None, 0) and not d.exists()


def test_retention_and_pretrain(tmp_path, capsys):
    """save_model keeps the 100 newest numbered files beside latest.pth;
    load_pretrain reads <workspace>/trained_model/<task>/<pretrain>/latest.pth."""
    d = tmp_path / "trained_model" / "gdb_nerf" / "pretrained"
    for e in range(103):
        checkpoint.save_model({"net": {"w": torch.tensor(e)}}, str(d), e, last=e == 102)
    names = sorted(os.listdir(d))
    assert "latest.pth" in names and len(names) == 101
    assert {f"{e}.pth" for e in range(2, 102)} <= set(names)
    cfg = SimpleNamespace(workspace=str(tmp_path), task="gdb_nerf",
                          train=SimpleNamespace(pretrain="pretrained"))
    assert int(checkpoint.load_pretrain(cfg)["w"]) == 102
    cfg.train.pretrain = "other"
    assert checkpoint.load_pretrain(cfg) is None and "no checkpoint" in capsys.readouterr().out
    cfg.train.pretrain = ""
    assert checkpoint.load_pretrain(cfg) is None


# Route (ii), the reference's per-scene fine-tune: the fine-tune's own
# directory holds the pretrained training state as <epoch>.pth, which
# ``load_model`` resumes; route (i): ``train.pretrain`` names another
# experiment's latest.pth, which ``load_pretrain`` loads into the network
# alone.  The warm-start file stands for a training at epoch 2 after 360
# steps (the bf16 gate's recipe: 3 epochs of 120).
WARM_EPOCH, WARM_STEP = 2, 360


@pytest.mark.parametrize("route", ["pretrain", "resume"])
def test_finetune_warm_starts_as_the_jax_train_net(route, rng, tmp_path, few_threads):
    """``configs/dtu/scan114.yaml`` through the port's ``train_net.main`` at
    64x64, ``mvs.num_depth [16,8]``, ``ep_iter 1``, one epoch, from a
    warm-start file whose weights and BatchNorm statistics differ from the
    seeded init: before the first step the network equals the file, and the
    step runs at the epoch and LR that the JAX ``train_net.py`` gives
    (lines 71-99: ``load_model``, the epoch after the file's, the step
    count restored from it and the config's schedule read there, as
    optax reads it; lines 100-115: ``load_pretrain``, the network alone,
    epoch 0 and a fresh optimizer); the epoch's checkpoint is written."""
    from gdb_nerf_tpu_torch import train_net
    from gdb_nerf_tpu_torch.config import load_cfg
    from gdb_nerf_tpu_torch.runtime.registry import make_network
    from gdb_nerf_tpu_torch.train.trainer import Trainer

    path = os.path.join(REPO, "configs", "dtu", "scan114.yaml")
    cfg = load_cfg(path, ["workspace", str(tmp_path)])
    torch.manual_seed(1)
    warm = Trainer(cfg, make_network(cfg, torch.float32), "cpu").state_dict()
    for k, v in warm["net"].items():
        if k.endswith(("running_mean", "running_var")):
            v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)))
    warm.update(epoch=WARM_EPOCH, step=WARM_STEP)
    warm["scheduler"]["last_epoch"] = WARM_STEP
    if route == "resume":
        begin, count = WARM_EPOCH + 1, WARM_STEP
        dest = os.path.join(cfg.trained_model_dir, f"{WARM_EPOCH}.pth")
    else:
        begin, count = 0, 0
        dest = os.path.join(str(tmp_path), "trained_model", cfg.task, cfg.train.pretrain,
                            "latest.pth")
    os.makedirs(os.path.dirname(dest))
    torch.save(warm, dest)
    seen = []

    class Observed(Trainer):  # the first epoch's view of the trainer, then the epoch as it is
        def train_epoch(self, epoch, loader, recorder):
            seen.append((epoch, [g["lr"] for g in self.optimizer.param_groups],
                         self.scheduler.last_epoch,
                         {k: v.clone() for k, v in self.network.state_dict().items()}))
            return super().train_epoch(epoch, loader, recorder)

    opts = ["synthetic", "True", "synthetic_hw", "[64,64]", "mvs.num_depth", "[16,8]",
            "workspace", str(tmp_path), "ep_iter", "1", "train.epoch", str(begin + 1),
            "train.num_workers", "0", "skip_eval", "True", "device", "cpu"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_net, "Trainer", Observed)
        train_net.main(["--cfg_file", path, *opts])
    cfg = load_cfg(path, opts)
    ((epoch, lrs, got_count, state),) = seen
    assert (epoch, got_count) == (begin, count)
    want = float(jax_optim.make_lr_schedule(cfg)(jnp.asarray(count)))
    assert lrs == [optim.make_lr_schedule(cfg)(count)] and lrs[0] == pytest.approx(want, rel=1e-6)
    assert lrs[0] == (cfg.train.lr if route == "pretrain" else cfg.train.lr * 0.5 ** (count / 50))
    assert state.keys() == warm["net"].keys()
    for k, v in warm["net"].items():
        assert torch.equal(state[k], v), k
    saved = checkpoint.load_model(cfg.trained_model_dir)[0]
    assert (saved["epoch"], saved["step"]) == (begin, count + 1)
    assert os.path.exists(os.path.join(cfg.trained_model_dir, f"{begin}.pth"))


def train_clis(workspace: str):
    """train_net, run --type evaluate and measure_train_step (on the CPU, and
    measure_train_step without --device) at 64x64, and their environment."""
    env = {**os.environ, "workspace": workspace, "OMP_NUM_THREADS": str(FEW_THREADS)}
    common = ["--cfg_file", "configs/dtu_pretrain.yaml", "synthetic", "True",
              "synthetic_hw", "[64,64]", "train.batch_size", "1", "train.num_workers", "0"]
    tool = ["--size", "64", "64", "--batch", "1", "--n", "1"]
    return [
        ("gdb_nerf_tpu_torch.train_net", [*common, "ep_iter", "2", "train.epoch", "1", "device",
                                          "cpu"]),
        ("gdb_nerf_tpu_torch.run", ["--type", "evaluate", *common, "device", "cpu"]),
        ("gdb_nerf_tpu_torch.tools.measure_train_step", [*tool, "--device", "cpu"]),
        ("gdb_nerf_tpu_torch.tools.measure_train_step", tool),
    ], env


def test_train_net_and_evaluate_cli_on_cpu():
    """train_net at 64x64: 2 steps, latest.pth, val with its metrics; then
    run --type evaluate on that checkpoint: psnr and ssim per scene, lpips
    SKIPPED, FPS; then measure_train_step at 64x64, B = 1, one step a
    round: its warm loss, timing and JSON lines; all three CLIs in one
    interpreter (started with the module, ``started_early``).  Each stops
    without a GPU unless told to run on the CPU."""
    import json

    tmp_path = _EARLY["workspace"]
    out, out_eval, out_tool, out_refused = _EARLY["clis"].result()
    assert out_tool.returncode == 0, out_tool.stderr[-3000:]
    assert "warm loss: " in out_tool.stdout and "train step: " in out_tool.stdout
    result = json.loads(out_tool.stdout.splitlines()[-1])["measure_train_step"]
    assert result["batch"] == 1 and result["hw"] == [64, 64] and result["card"] == "cpu"
    assert np.isfinite(result["warm_loss"]) and result["step_ms"] > 0
    if not torch.cuda.is_available():  # the default device is cuda: no silent CPU run
        assert out_refused.returncode != 0 and "CUDA is not available" in out_refused.stderr
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("epoch: 0  iter") == 2 and "loss: " in out.stdout
    assert "synthetic7" in out.stdout and "'psnr'" in out.stdout
    model_dir = tmp_path / "trained_model" / "gdb_nerf" / "dtu_pretrain"
    assert sorted(os.listdir(model_dir)) == ["0.pth", "latest.pth"]
    out = out_eval
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"[run] loaded {model_dir / 'latest.pth'}" in out.stdout
    assert "synthetic0" in out.stdout and " psnr: " in out.stdout and " ssim: " in out.stdout
    assert "lpips: SKIPPED" in out.stdout and "FPS: " in out.stdout
    if not torch.cuda.is_available():  # the default device is cuda: no silent CPU run
        from gdb_nerf_tpu_torch import run, train_net

        cfg = pretrain_cfg(tmp_path, "synthetic", "True")
        for entry in (train_net.train, run.run_evaluate):
            with pytest.raises(SystemExit, match="CUDA is not available"):
                entry(cfg)


def test_stage_nerf_density_and_view_weights_are_float32_in_bf16(rng):
    """The stage NeRF in bf16 against the JAX ``StageNeRF(dtype=bfloat16)``
    on the same float32 parameters (its density layer kept float32, as
    ``Network.float32_layers`` keeps it): sigma and rgb come back float32,
    sigma within 1e-2 of its largest value and rgb within 2e-3 (one bf16
    ulp at 0.5 is 2e-3; 5.0e-3 / 2.7e-3 of the largest sigma and 9.6e-4
    measured on the CPU, the bf16 products' summation order).  A head that
    took the softmax over views and the blend in bf16 rounds rgb to bf16.
    Float32 agrees within 1e-6."""
    from gdb_nerf_tpu.models.nerf_head import StageNeRF as JaxStageNeRF
    from gdb_nerf_tpu_torch.models.layers import cast_weights
    from gdb_nerf_tpu_torch.models.nerf_head import StageNeRF
    from gdb_nerf_tpu_torch.utils.convert import stage_nerf_from_jax

    V, N, S, feat = 3, 64, 8, 32
    vox = rng.normal(size=(1, N, S, 8)).astype(np.float32)
    frd = rng.normal(size=(1, V, N, S, feat + 7)).astype(np.float32)
    frd[..., -7:-4] = rng.uniform(0, 1, size=(1, V, N, S, 3))
    tols = {"bfloat16": (1e-2, 2e-3), "float32": (1e-6, 1e-6)}

    def init_apply(key, vox, frd):  # float32 parameters, the same in both dtypes
        params = JaxStageNeRF(64, True).init(key, vox, frd)["params"]
        return params, {dt: JaxStageNeRF(64, True, dtype=jnp.dtype(dt)).apply(
            {"params": params}, vox, frd) for dt in tols}

    params, outs = jax.tree_util.tree_map(
        np.asarray, run_jitted(init_apply, jax.random.PRNGKey(0), vox, frd))
    for dt, (sigma_rtol, rgb_atol) in tols.items():
        sigma_j, rgb_j = outs[dt]
        head = StageNeRF(64, feat, 8, True)
        head.load_state_dict(stage_nerf_from_jax(params), strict=True)
        cast_weights(head, getattr(torch, dt), keep=(head.sigma[0],))
        with torch.no_grad():
            sigma, rgb = head(torch.from_numpy(vox), torch.from_numpy(np.moveaxis(frd, 1, 0)))
        assert sigma.dtype == rgb.dtype == torch.float32, dt
        assert np.abs(sigma.numpy() - sigma_j).max() <= sigma_rtol * np.abs(sigma_j).max(), dt
        assert np.abs(rgb.numpy() - rgb_j).max() <= rgb_atol, dt


# The bf16 step against the port-numerics reference (``jax_step``): the issue's
# bounds, which a float32 step meets too, and ratios a float32 step fails.
# Per gradient: BF16_GRAD_RTOL relative L2 (BF16_DEEP_GRAD_RTOL for the FPN
# and U-Nets) plus GRAD_FLOOR of the step's largest element per element;
# the bundle head's view-weight layers (``nerf.weight.*``) at
# BF16_VIEW_WEIGHT_FACTOR times that, because the reference's own bf16
# gradients of them stand 16-17 % from its float32 ones where the port's
# stand 1-7 % (``main`` prints both).  Ratios: the squared distance of rgb and of
# the stage render from the reference, and the distance of each gradient
# group, over the same distance of the port's float32 step (1 for a float32
# step; measured 0.45, 0.019, 0.26 and 0.39 on the CPU).
BF16_RTOL, BF16_MIN_PSNR = 1e-3, 45.0
BF16_GRAD_RTOL, BF16_DEEP_GRAD_RTOL, GRAD_FLOOR, BF16_VIEW_WEIGHT_FACTOR = 3e-2, 5e-2, 1e-6, 6.0
BF16_RATIO = {"rgb": 0.6, "stage": 0.1, "fpn_unets": 0.6, "rest": 0.6}


def forward_backward(master, compute, batch, mixed=None) -> dict:
    """One forward and backward of ``compute`` (its BatchNorms as set):
    loss, stats, rgb, the stage render and the gradients of ``master``'s
    parameters clipped at 40 (the cast weights' through ``mixed``)."""
    from gdb_nerf_tpu_torch.train.step import make_loss_fn

    for p in master.parameters():
        p.grad = torch.zeros_like(p)
    outputs = []
    hook = compute.register_forward_hook(lambda m, i, out: outputs.append(out))
    loss, stats = make_loss_fn(compute, [0.05], use_perceptual=False)(
        to_device_train(batch, "cpu"))
    hook.remove()
    loss.backward()
    if mixed is not None:
        mixed.gather_grads()
    (ret, _, blend), = outputs
    return step_outcome(stats, ret, blend, master)


def step_outcome(stats, ret, blend, master) -> dict:
    return {"stats": {k: float(v) for k, v in stats.items()},
            "rgb": ret["rgb"].detach().numpy(), "stage": blend[0].detach().numpy(),
            "grads": {k: p.grad.clamp(-40.0, 40.0).numpy()
                      for k, p in master.named_parameters()}}


def bf16_ratios(got: dict, f32: dict, ref: dict) -> dict:
    """``BF16_RATIO``'s quantities of the step ``got`` against ``ref``,
    relative to the float32 step ``f32``."""
    def mse(a, b):
        return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))

    out = {k: mse(got[k], ref[k]) / mse(f32[k], ref[k]) for k in ("rgb", "stage")}
    for group, names in grad_groups(got["grads"]).items():
        out[group] = (group_rel_l2(got["grads"], ref["grads"], names)
                      / group_rel_l2(f32["grads"], ref["grads"], names))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_train_step_matches_jax(dtype):
    """One step from the JAX package's init against the JAX step in the
    same compute dtype.

    float32: loss and every stat within 1e-4 relative; rgb and the stage
    render >= 60 dB; every parameter's gradient within 1e-3 relative L2;
    the parameters after one adam step within 1e-3 relative L2 (not 1e-5:
    the first adam step moves each element by about lr * sign(g), so a
    gradient element smaller than its rounding error can take the other
    sign; 3.4e-4 measured on the CPU in the 3D U-Nets' conv weights);
    BatchNorm's running_mean within 1e-5 and its running_var within 1e-5
    after the factor n/(n-1) that the JAX package's biased variance leaves
    out.

    bfloat16 (float32 master weights, ``train.mixed``), with BatchNorm on
    running statistics, against the JAX bf16 step computed as the port
    computes bf16 (``port_bf16_numerics``): each forward sees the master
    rounded to bf16 in every layer ``cast_weights`` casts, and each such
    layer's gradient reaches its master as the float32 value of its bf16
    gradient, before the clip (exact); every other parameter and buffer is
    the master's own tensor.  Loss and every stat within 1e-3 relative
    (2.0e-4 and 6.9e-4 measured), rgb and the stage render >= 45 dB (54.2
    and 86.1), every gradient as set out at ``BF16_GRAD_RTOL``; and closer
    to the reference than a float32 step by ``BF16_RATIO``.  Two controls
    must fail the ratios: the port's float32 step, and a step that computes
    in float32 on the master rounded to bf16 (measured 0.72, 1.0, 0.82,
    0.57)."""
    flags = sorted(k for k in os.environ if k.startswith("GDBN_"))
    assert not flags, f"GDBN_* variables change the JAX reference: {flags}"
    from gdb_nerf_tpu_torch.train.mixed import MixedPrecision

    ref = jax_steps()
    batch, params, stats0 = ref["batch"], ref["params"], ref["stats0"]
    sd0 = state_dict_from_jax({"params": params, "batch_stats": stats0})
    net = Network(**PRETRAIN_NET).train(dtype == "float32")
    net.load_state_dict(sd0, strict=True)
    mixed = None if dtype == "float32" else MixedPrecision(net, getattr(torch, dtype))
    compute = net if mixed is None else mixed.compute.eval()
    before = {id(p): p.detach().clone() for p in net.parameters()}
    opt, sched = optim.make_optimizer(optim_cfg(), net.parameters())
    outputs, counts = [], {}
    compute.register_forward_hook(lambda m, i, out: outputs.append(out))
    for name, m in compute.named_modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.register_forward_pre_hook(
                lambda m, i, name=name: counts.__setitem__(name, i[0].numel() // i[0].shape[1]))
    stats = make_train_step(net, opt, sched, [0.05], use_perceptual=False, mixed=mixed)(
        to_device_train(batch, "cpu"))
    loss_j, stats_j, grads_j, bs_j, params_j, rgb_j, blend_j = ref["steps"][dtype]
    (ret, _, blend), = outputs
    assert len(blend) == len(blend_j) == 1
    assert set(stats) == set(stats_j)
    grads = state_dict_from_jax({"params": jax.tree_util.tree_map(
        lambda g: np.clip(g, -40.0, 40.0), grads_j), "batch_stats": stats0})
    named = dict(net.named_parameters())
    assert set(named) <= set(grads)
    assert all(p.dtype == torch.float32 for p in named.values())

    if mixed is not None:
        shared = {id(p) for p in net.parameters()}
        assert len(mixed.pairs) > 0
        for p, c in mixed.pairs:
            assert c.dtype == torch.bfloat16 and id(c) not in shared
            assert torch.equal(c.detach(), before[id(p)].to(torch.bfloat16))
            g = torch.zeros_like(p) if c.grad is None else c.grad.float().clamp(-40.0, 40.0)
            assert torch.equal(p.grad, g)
        cast = {id(c) for _, c in mixed.pairs}
        assert all(id(q) in cast or id(q) in shared for q in compute.parameters())
        assert len(list(compute.parameters())) == len(named)
        buffers = {id(b) for b in net.buffers()}
        assert all(id(b) in buffers for b in compute.buffers())

        reference = {"stats": {k: float(v) for k, v in stats_j.items()}, "rgb": rgb_j,
                     "stage": blend_j[0], "grads": {k: grads[k].numpy() for k in named}}
        got = step_outcome(stats, ret, blend, net)
        for k, v in reference["stats"].items():
            assert abs(got["stats"][k] - v) <= BF16_RTOL * abs(v) + 1e-7, k
        assert abs(float(stats["loss"]) - float(loss_j)) <= BF16_RTOL * abs(float(loss_j))
        assert psnr(got["rgb"], rgb_j) >= BF16_MIN_PSNR
        assert psnr(got["stage"], blend_j[0]) >= BF16_MIN_PSNR
        gmax = max(float(np.abs(g).max()) for g in reference["grads"].values())
        for k, g in got["grads"].items():
            want = reference["grads"][k]
            deep = k.startswith(("feature_net.", "depth_net.cost_regs."))
            tol = ((BF16_DEEP_GRAD_RTOL if deep else BF16_GRAD_RTOL) * np.linalg.norm(want)
                   + GRAD_FLOOR * gmax * want.size ** 0.5)
            if k.startswith("nerf.weight."):
                tol *= BF16_VIEW_WEIGHT_FACTOR
            assert np.linalg.norm(g - want) <= tol, k

        def fresh():
            master = Network(**PRETRAIN_NET).eval()
            master.load_state_dict(sd0, strict=True)
            return master

        master32 = fresh()
        f32 = forward_backward(master32, master32, batch)
        ratios = bf16_ratios(got, f32, reference)
        print("bf16 step, ratios:", {k: round(v, 4) for k, v in ratios.items()})
        assert all(ratios[k] <= bound for k, bound in BF16_RATIO.items()), ratios
        rounded = fresh()
        control = MixedPrecision(rounded, torch.bfloat16)
        control.refresh()
        for _, c in control.pairs:
            c.data = c.data.float()
        control.compute.compute_dtype = torch.float32
        controls = {"float32 step": f32, "float32 compute on the rounded master": forward_backward(
            rounded, control.compute.eval(), batch, control)}
        for name, step in controls.items():
            ratios = bf16_ratios(step, f32, reference)
            print(f"{name}, ratios:", {k: round(v, 4) for k, v in ratios.items()})
            assert any(ratios[k] > bound for k, bound in BF16_RATIO.items()), (name, ratios)
        return

    for k, v in stats_j.items():
        assert abs(float(stats[k]) - float(v)) <= 1e-4 * abs(float(v)) + 1e-7, k
    assert abs(float(stats["loss"]) - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    assert psnr(ret["rgb"].detach().numpy(), rgb_j) >= 60.0
    assert psnr(blend[0].detach().numpy(), blend_j[0]) >= 60.0
    after = state_dict_from_jax({"params": params_j, "batch_stats": bs_j})
    for k, p in named.items():
        assert rel_l2(p.grad.numpy(), grads[k].numpy()) <= 1e-3, k
        assert rel_l2(p.detach().numpy(), after[k].numpy()) <= 1e-3, k
    sd0 = state_dict_from_jax({"params": params, "batch_stats": stats0})
    assert len(counts) == sum(k.endswith("running_var") for k in sd0)
    for name, n in counts.items():
        mod = net.get_submodule(name)
        np.testing.assert_allclose(mod.running_mean.numpy(), after[f"{name}.running_mean"].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
        # torch folds the unbiased batch variance into running_var; flax the biased one.
        r0 = sd0[f"{name}.running_var"].numpy()
        biased = 0.9 * r0 + (mod.running_var.numpy() - 0.9 * r0) * (n - 1) / n
        np.testing.assert_allclose(biased, after[f"{name}.running_var"].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


def main() -> None:
    """``python -m tests.test_torch_port_train`` (CPU, ~3 min): where the
    port's bf16 step and the JAX package's part, on the case of
    ``test_train_step_matches_jax`` (ROADMAP queue 3).  Prints
    [threads] the port's bf16 step with 1 torch thread against all, its
    BatchNorms on batch and on running statistics; [fpn] the share of the
    port's bf16 FPN output equal, bit for bit, to the JAX FeatureNet's on
    the same bf16 images, XLA's excess precision on and off; [reference]
    the JAX bf16 step as the JAX package runs it (batch statistics) and
    then on running statistics with excess precision off, float32 sums and
    float32 tables added one at a time: its distance from the JAX float32
    step (on the same statistics), also over its bias gradients alone, the
    port's bf16 step's distance from it, and ``bf16_ratios``."""
    from gdb_nerf_tpu.models.feature_net import FeatureNet as JaxFeatureNet
    from gdb_nerf_tpu_torch.train.mixed import MixedPrecision

    batch, jbatch, params, stats0 = train_case()
    sd0 = state_dict_from_jax({"params": params, "batch_stats": stats0})

    def port(dtype, running_stats):
        master = Network(**PRETRAIN_NET).train(not running_stats)
        master.load_state_dict(sd0, strict=True)
        if dtype == "float32":
            return forward_backward(master, master, batch)
        mixed = MixedPrecision(master, torch.bfloat16)
        mixed.refresh()
        return forward_backward(master, mixed.compute.train(not running_stats), batch, mixed)

    def groups(a, b):
        return " ".join(f"{g} {group_rel_l2(a['grads'], b['grads'], names):.3e}"
                        for g, names in grad_groups(a["grads"]).items())

    threads = torch.get_num_threads()
    for running in (False, True):
        many = port("bfloat16", running)
        torch.set_num_threads(1)
        one = port("bfloat16", running)
        torch.set_num_threads(threads)
        print(f"[threads] BatchNorm on {'running' if running else 'batch'} statistics: the "
              f"port's bf16 step, 1 thread against {threads}: rgb {psnr(one['rgb'], many['rgb']):.1f}"
              f" dB, stage {psnr(one['stage'], many['stage']):.1f} dB, {groups(one, many)}")

    images = np.asarray(jnp.asarray(batch["src_views"]["rgb"].reshape(-1, 64, 64, 3),
                                    jnp.bfloat16), np.float32)
    net16 = Network(**PRETRAIN_NET, compute_dtype=torch.bfloat16).eval()
    net16.load_state_dict(sd0, strict=True)
    with torch.no_grad():
        ours = net16.feature_net(torch.from_numpy(images).permute(0, 3, 1, 2).bfloat16())
    fpn = JaxFeatureNet(net16.feature_net.conv0[0][0].out_channels,
                        tuple(o.out_channels for o in (net16.feature_net.out0,
                                                       net16.feature_net.out1,
                                                       net16.feature_net.out2)),
                        None, jnp.bfloat16)
    for excess in (True, False):
        theirs = run_jitted(lambda v, x: fpn.apply(v, x, False),
                            {"params": params["feature_net"], "batch_stats": stats0["feature_net"]},
                            jnp.asarray(images, jnp.bfloat16),
                            options={"xla_allow_excess_precision": excess})
        equal = [float(np.mean(np.asarray(t, np.float32) == o.float().permute(0, 2, 3, 1).numpy()))
                 for t, o in zip(theirs, ours)]
        print(f"[fpn] excess precision {'on' if excess else 'off'}: the three levels equal bit for "
              f"bit in shares {', '.join(f'{e:.4f}' for e in equal)}")

    def jax_outcome(out):
        loss, stats, grads, _, _, rgb, blend = out
        g = state_dict_from_jax({"params": jax.tree_util.tree_map(
            lambda x: np.clip(x, -40.0, 40.0), grads), "batch_stats": stats0})
        return {"stats": {k: float(v) for k, v in stats.items()}, "rgb": rgb, "stage": blend[0],
                "grads": {k: v.numpy() for k, v in g.items() if k in sd0 and
                          not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}}

    cases = [("batch statistics, as the JAX package runs it", False,
              {"excess_precision": True, "running_stats": False, "f32_sums": False,
               "f32_tables": False}),
             ("running statistics", True, {"excess_precision": True, "f32_sums": False,
                                           "f32_tables": False}),
             ("+ excess precision off", True, {"f32_sums": False, "f32_tables": False}),
             ("+ float32 sums", True, {"f32_tables": False}),
             ("+ float32 tables (the test's reference)", True, {})]
    anchors = {}
    for name, running, numerics in cases:
        if running not in anchors:
            j32 = jax_outcome(jax_step("float32", params, stats0, jbatch, numerics={
                "excess_precision": True, "running_stats": running, "f32_sums": False,
                "f32_tables": False}))
            anchors[running] = (j32, port("float32", running), port("bfloat16", running))
        j32, p32, p16 = anchors[running]
        ref = jax_outcome(jax_step("bfloat16", params, stats0, jbatch,
                                   numerics={"running_stats": running, **numerics}))
        bias = group_rel_l2(ref["grads"], j32["grads"],
                            [k for k in ref["grads"] if k.endswith(".bias")])
        stat = max(abs(p16["stats"][k] - v) / max(abs(v), 1e-12) for k, v in ref["stats"].items())
        ratios = bf16_ratios(p16, p32, ref)
        print(f"[reference] {name}: JAX bf16 from JAX float32: rgb {psnr(ref['rgb'], j32['rgb']):.1f}"
              f" dB, {groups(ref, j32)}, the bias gradients {bias:.3e}; the port's bf16 from it: "
              f"stats {stat:.2e}, rgb {psnr(p16['rgb'], ref['rgb']):.1f} dB, stage "
              f"{psnr(p16['stage'], ref['stage']):.1f} dB, {groups(p16, ref)}; ratios "
              + " ".join(f"{k} {v:.3f}" for k, v in ratios.items()))
    views = [k for k in ref["grads"] if k.startswith("nerf.weight.")]
    print("[view-weights] the bundle head's view-weight layers, relative L2 from float32 (JAX "
          "bf16 on the test's reference from JAX float32; the port's bf16 from its float32): "
          + ", ".join(f"{k} {rel_l2(ref['grads'][k], j32['grads'][k]):.3f} / "
                      f"{rel_l2(p16['grads'][k], p32['grads'][k]):.3f}" for k in views))


if __name__ == "__main__":
    main()
