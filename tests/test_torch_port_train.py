"""The port's training path against the JAX package's, on the CPU.

* One train step of the whole network: the JAX Network's loss, gradients
  and one adam step (``make_loss_fn``, ``make_optimizer``) against the
  port's (``train.step``) at 64x64, B = 1, V = 3, with dtu_pretrain's flags
  at ``mvs_num_depth (16, 8)``, the same weights through
  ``state_dict_from_jax`` and randomized BatchNorm statistics.
* The losses, every LR schedule and every optimizer with its clip against
  the JAX package's.
* Checkpoints: resuming is bit-exact, and under a config with another LR
  takes the new schedule from its first step, ``load_model`` picks the file the JAX
  loader picks, retention stops at 100 files, ``load_pretrain`` reads
  another experiment's ``latest.pth``.
* ``train_net`` and ``run --type evaluate`` end to end on the CPU.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gdb_nerf_tpu.train import losses as jax_losses
from gdb_nerf_tpu.train import optim as jax_optim
from gdb_nerf_tpu.train.step import make_loss_fn as jax_make_loss_fn
from gdb_nerf_tpu.utils import checkpoint as jax_checkpoint
from gdb_nerf_tpu_torch.models.network import Network
from gdb_nerf_tpu_torch.train import losses, optim
from gdb_nerf_tpu_torch.train.step import make_train_step, to_device_train
from gdb_nerf_tpu_torch.utils import checkpoint
from gdb_nerf_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_port_network import (psnr, randomize_batch_stats, run_clis, run_jitted,
                                           small_batch)

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


def jax_init(jnet, inputs, rng):
    """The JAX Network's own initial parameters (seed 0) and randomized
    BatchNorm statistics.  The parameters do not depend on the batch's
    shapes.  Not ``jax_variables``: with its numpy draw of the same
    distribution the gradients of this step differ from the JAX package's
    by up to 5.9e-3 relative L2 (ROADMAP queue 3)."""
    variables = jax.tree_util.tree_map(np.asarray, run_jitted(
        lambda k, b: jnet.init(k, b, train=True), jax.random.PRNGKey(0), inputs))
    return variables["params"], randomize_batch_stats(variables["batch_stats"], rng)


def test_train_step_matches_jax(rng):
    """Loss and every stat within 1e-4 relative; rgb and the stage render
    >= 60 dB; every parameter's gradient within 1e-3 relative L2; the
    parameters after one adam step within 1e-3 relative L2 (not 1e-5: the
    first adam step moves each element by about lr * sign(g), so a gradient
    element smaller than its rounding error can take the other sign; 3.4e-4
    measured on the CPU in the 3D U-Nets' conv weights); BatchNorm's running_mean
    within 1e-5 and its running_var within 1e-5 after the factor n/(n-1)
    that the JAX package's biased variance leaves out."""
    flags = sorted(k for k in os.environ if k.startswith("GDBN_"))
    assert not flags, f"GDBN_* variables change the JAX reference: {flags}"
    from gdb_nerf_tpu.models.network import Network as JaxNetwork
    from gdb_nerf_tpu.train.step import to_device_train as jax_to_device_train

    batch = train_batch(rng)
    jbatch = jax_to_device_train(batch)
    inputs = {k: jbatch[k] for k in ("src_views", "tar_views", "near_far")}
    jnet = JaxNetwork(**PRETRAIN_NET)
    params, stats0 = jax_init(jnet, inputs, rng)
    cfg = optim_cfg()
    tx = jax_optim.make_optimizer(cfg)
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

    def jax_step(params, batch_stats, batch):
        (loss, ((new_bs, stats), rgb, blend)), grads = jax.value_and_grad(
            loss_and_outputs, has_aux=True)(params, batch_stats, batch)
        updates, _ = tx.update(grads, tx.init(params), params)
        return loss, stats, grads, new_bs, optax.apply_updates(params, updates), rgb, blend

    loss_j, stats_j, grads_j, bs_j, params_j, rgb_j, blend_j = jax.tree_util.tree_map(
        np.asarray, run_jitted(jax_step, params, stats0, jbatch))

    net = Network(**PRETRAIN_NET).train()
    net.load_state_dict(state_dict_from_jax({"params": params, "batch_stats": stats0}),
                        strict=True)
    opt, sched = optim.make_optimizer(cfg, net.parameters())
    outputs, counts = [], {}
    net.register_forward_hook(lambda m, i, out: outputs.append(out))
    for name, m in net.named_modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.register_forward_pre_hook(
                lambda m, i, name=name: counts.__setitem__(name, i[0].numel() // i[0].shape[1]))
    stats = make_train_step(net, opt, sched, [0.05], use_perceptual=False)(
        to_device_train(batch, "cpu"))

    assert set(stats) == set(stats_j)
    for k, v in stats_j.items():
        assert abs(float(stats[k]) - float(v)) <= 1e-4 * abs(float(v)) + 1e-7, k
    assert abs(float(stats["loss"]) - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    (ret, _, blend), = outputs
    assert psnr(ret["rgb"].detach().numpy(), rgb_j) >= 60.0
    assert len(blend) == len(blend_j) == 1
    assert psnr(blend[0].detach().numpy(), blend_j[0]) >= 60.0

    grads = state_dict_from_jax({"params": jax.tree_util.tree_map(
        lambda g: np.clip(g, -40.0, 40.0), grads_j), "batch_stats": stats0})
    after = state_dict_from_jax({"params": params_j, "batch_stats": bs_j})
    named = dict(net.named_parameters())
    assert set(named) <= set(grads)
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


def test_losses_match_jax(rng):
    """ssim and its gradient, photometric_loss and smooth_l1_depth within 1e-5."""
    a = rng.uniform(0, 1, (2, 24, 40, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    tb = torch.from_numpy(b).requires_grad_()
    s = losses.ssim(torch.from_numpy(a), tb)
    s.backward()
    s = s.detach()
    s_j, g_j = jax.value_and_grad(lambda y: jax_losses.ssim(jnp.asarray(a), y))(jnp.asarray(b))
    np.testing.assert_allclose(float(s), float(s_j), rtol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-8)
    got = losses.photometric_loss(torch.from_numpy(a), torch.from_numpy(b), (1.0, 0.1, 0.0))
    want = jax_losses.photometric_loss(jnp.asarray(a), jnp.asarray(b), (1.0, 0.1, 0.0))
    np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want], rtol=1e-5)
    est = [rng.uniform(0, 3, (2, 6, 8)).astype(np.float32) for _ in range(2)]
    gt = [rng.uniform(0, 3, (2, 6, 8)).astype(np.float32) for _ in range(2)]
    masks = [(rng.uniform(size=(2, 6, 8)) > 0.3).astype(np.float32) for _ in range(2)]
    t = [[torch.from_numpy(x) for x in xs] for xs in (est, gt, masks)]
    j = [[jnp.asarray(x) for x in xs] for xs in (est, gt, masks)]
    loss, stats = losses.smooth_l1_depth(*t, [1.0, 0.5])
    loss_j, stats_j = jax_losses.smooth_l1_depth(*j, [1.0, 0.5])
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


def pretrain_cfg(ws, *opts):
    from gdb_nerf_tpu_torch.config import load_cfg

    return load_cfg(os.path.join(REPO, "configs", "dtu_pretrain.yaml"),
                    ["workspace", str(ws), "ep_iter", "3", *opts])


def test_resume_is_bit_exact(rng, tmp_path):
    """Two trainer steps, save_model, load_model into a fresh trainer, one
    step: the same parameters, optimizer state and LR as three steps in one
    run, bit for bit."""
    from gdb_nerf_tpu_torch.runtime.registry import make_network
    from gdb_nerf_tpu_torch.train.trainer import Trainer

    cfg = pretrain_cfg(tmp_path, "mvs.num_depth", "[16,8]", "train.weight_decay", "0.01")
    batches = [train_batch(rng, V=2) for _ in range(3)]

    def trainer():
        torch.manual_seed(0)
        return Trainer(cfg, make_network(cfg), "cpu")

    whole = trainer()
    for b in batches:
        whole.train_step(b)
    first = trainer()
    for b in batches[:2]:
        first.train_step(b)
    checkpoint.save_model(dict(first.state_dict(), recorder={"step": 2}), cfg.trained_model_dir, 0)
    state, begin = checkpoint.load_model(cfg.trained_model_dir)
    assert begin == 1 and state["step"] == 2 and state["recorder"] == {"step": 2}
    resumed = trainer()
    resumed.load_state_dict(state)
    assert resumed.step == 2
    resumed.train_step(batches[2])
    assert resumed.step == whole.step == 3
    for (k, a), b in zip(whole.network.state_dict().items(), resumed.network.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = whole.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert whole.scheduler.get_last_lr() == resumed.scheduler.get_last_lr()
    assert whole.optimizer.param_groups[0]["lr"] == resumed.optimizer.param_groups[0]["lr"]


def test_resume_under_another_lr_takes_the_new_schedule(rng, tmp_path):
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


def test_train_net_and_evaluate_cli_on_cpu(tmp_path):
    """train_net at 64x64: 2 steps, latest.pth, val with its metrics; then
    run --type evaluate on that checkpoint: psnr and ssim per scene, lpips
    SKIPPED, FPS; both CLIs in one interpreter.  Both stop without a GPU
    unless told ``device cpu``."""
    env = {**os.environ, "workspace": str(tmp_path)}
    common = ["--cfg_file", "configs/dtu_pretrain.yaml", "synthetic", "True",
              "synthetic_hw", "[64,64]", "train.batch_size", "1", "train.num_workers", "0"]
    out, out_eval = run_clis([
        ("gdb_nerf_tpu_torch.train_net", [*common, "ep_iter", "2", "train.epoch", "1", "device",
                                          "cpu"]),
        ("gdb_nerf_tpu_torch.run", ["--type", "evaluate", *common, "device", "cpu"]),
    ], env=env)
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


def test_trainer_refuses_bf16(tmp_path):
    from gdb_nerf_tpu_torch.runtime.registry import make_network
    from gdb_nerf_tpu_torch.train.trainer import Trainer

    cfg = pretrain_cfg(tmp_path, "compute_dtype", "bfloat16")
    with pytest.raises(ValueError, match="float32"):
        Trainer(cfg, make_network(cfg), "cpu")
