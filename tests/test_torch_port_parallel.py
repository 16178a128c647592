"""The port's data-parallel training and row-sharded inference, on the CPU.

One launch of 2 gloo ranks (``python -m torch.distributed.run``, each rank
running this module as ``__main__``, ``rank_main``) does all of the port's
2-rank work while this process compiles the JAX references:

(a) ``parallel.hosts.config_from_env`` against the JAX function on the env
    dicts of ``tests/test_sharded_infer.py``, and the backend rule.
(b) One data-parallel train step (B = 2, one item a rank, V = 2, 64x64,
    dtu_pretrain's flags at ``mvs_num_depth (16, 8)``, no perceptual term)
    against the JAX package's ``make_train_step`` on a 2-device mesh, from
    the JAX package's own initial weights (those of
    ``tests/test_torch_port_train.py``, through ``state_dict_from_jax``),
    with that file's tolerances where float32 summation order allows them;
    and from a second draw, numpy's (``jax_variables``), where the
    parameters after the step are held by the share of elements apart.
(c) The 2-rank step against the port's one-process step on the whole batch,
    and that step on 2 threads against 1, on both draws: the gradient
    bounds hold what float32 summation order alone moves.
(d) The BatchNorm over ranks alone, on shards of unequal size, against one
    process on the whole batch, forward and backward, 2D and 3D.
(e) ``ShardedRenderer`` on 2 ranks against ``Renderer`` and the JAX render,
    with ``debug_outputs`` on: the gathered ``spb`` equal to both.
(f) A bundle grid whose height the ranks do not divide raises.
(g) ``train_net`` under ``torch.distributed.run``: each rank trains on its
    own shard of the training set, rank 0 alone saves, validates and
    records, and the group is left at the end.

The module imports no jax at its top: the ranks import it.
"""

import contextlib
import io
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
LOSS_WEIGHT = [0.05]
# Rows of the whole batch that each rank takes in (d): 3 and 1 of 4 (2D),
# 2 and 1 of 3 (3D), so the moments are merged by count.
BN_SPLITS = {"2d": (slice(0, 3), slice(3, 4)), "3d": (slice(0, 2), slice(2, 3))}
# Gradients of the FPN's and the cost-regularization U-Nets' parameters
# move with float32 summation order alone at this size: the port's own
# one-process step on this batch differs by up to 2.11e-2 relative L2
# between 2 CPU threads and 1, same code and inputs (printed by
# test_summation_order_alone_stays_inside_the_gradient_bounds; ROADMAP
# queue 3).  They are held at 5e-2, which a gradient summed and not averaged over
# ranks (a factor of 2) exceeds; every other gradient at 1e-3.  Their
# parameters after one adam step are held at 1e-2, the others at 1e-3:
# adam's first step moves an element by about lr * sign(g), and more
# elements take the other sign where the gradients are farther apart
# (1.1e-3 measured at depth_net.cost_regs.0.conv0.0.weight against the
# JAX mesh).
SENSITIVE = ("feature_net.", "depth_net.cost_regs.")
SENSITIVE_RTOL, GRAD_RTOL, GRAD_FLOOR = 5e-2, 1e-3, 1e-6
SENSITIVE_PARAM_RTOL, PARAM_RTOL = 1e-2, 1e-3
# (c) and (d): the 2-rank port against one process of the port.  Both sum
# in other orders (a batch moment merged from two shards; each rank's
# gradient summed over its own item, then over ranks).
PORT_RTOL = 1e-5
BN_TOL = 1e-5


def grad_rtol(name: str) -> float:
    return SENSITIVE_RTOL if name.startswith(SENSITIVE) else GRAD_RTOL


def grad_share(name: str, got, want, gmax: float) -> float:
    """The distance between two gradients as a share of its tolerance:
    ``grad_rtol`` relative L2 plus, per element, GRAD_FLOOR of the step's
    largest gradient element ``gmax`` (chip_smoke.py phase 6e's rule: a
    gradient that cancels to near 0, as a view-weight layer's does under
    the softmax over views, is held in absolute terms)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = grad_rtol(name) * np.linalg.norm(want) + GRAD_FLOOR * gmax * want.size ** 0.5
    return float(np.linalg.norm(got - want) / tol)


def largest(grads) -> float:
    return max(float(np.abs(np.asarray(g)).max()) for g in grads.values())


def param_rtol(name: str) -> float:
    return SENSITIVE_PARAM_RTOL if name.startswith(SENSITIVE) else PARAM_RTOL


# On the numpy draw the parameters after the step are held by the share of
# their elements more than 1e-6 from the mesh's: at most PARAMS_APART.  Per
# tensor, relative L2 cannot hold there: a bias starts at 0, so one channel
# whose gradient lies below the two packages' rounding difference takes the
# other sign and lands 2 lr away (1 of 32 elements: 0.35 relative L2), and a
# bias whose gradient is 0 in exact arithmetic (agg_w_fc's, before a softmax
# over views) takes an adam step of normalized rounding noise (ROADMAP
# queue 3).  0.05-0.12 % of the 962,311 elements measured on the CPU, while
# a step at another LR moves every element whose gradient is above adam's
# eps.
NUMPY_DRAW_SEED, PARAMS_APART = 1, 1e-2

# The env dicts of tests/test_sharded_infer.py::test_multihost_env_parsing.
ENVS = [
    {},
    {"WORLD_SIZE": "4"},
    {"MASTER_ADDR": "h", "WORLD_SIZE": "1"},
    {"MASTER_ADDR": "host0", "MASTER_PORT": "29500", "WORLD_SIZE": "4", "RANK": "2"},
    {"JAX_COORDINATOR_ADDRESS": "h:1", "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1"},
    {"TPU_WORKER_HOSTNAMES": "w0,w1,w2,w3"},
    {"TPU_WORKER_HOSTNAMES": "w0"},
]


def _items(tree, sl):
    """The items ``sl`` of every array of a loader batch."""
    if isinstance(tree, dict):
        return {k: _items(v, sl) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_items(v, sl) for v in tree]
    return tree[sl]


# --- the ranks ---------------------------------------------------------------


def _train_step(case, group, shard, sd="sd", dtype=torch.float32):
    """One step of the port's network from the weights ``case[sd]`` on
    ``case.batch[shard]``, data-parallel over ``group`` (None: one
    process), in ``dtype`` (bf16: on float32 master weights,
    ``train.mixed``): stats, gradients (averaged and clipped), the state
    after the step and each BatchNorm's element count."""
    from gdb_nerf_tpu_torch.models.layers import set_batchnorm_group
    from gdb_nerf_tpu_torch.models.network import Network
    from gdb_nerf_tpu_torch.train import optim
    from gdb_nerf_tpu_torch.train.mixed import MixedPrecision
    from gdb_nerf_tpu_torch.train.step import make_train_step, to_device_train

    net = Network(**case["net"]).train()
    net.load_state_dict(case[sd], strict=True)
    mixed = None if dtype == torch.float32 else MixedPrecision(net, dtype)
    run = net if mixed is None else mixed.compute
    set_batchnorm_group(run, group)
    opt, sched = optim.make_optimizer(case["optim_cfg"], net.parameters())
    counts = {}
    for name, m in run.named_modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.register_forward_pre_hook(
                lambda m, i, name=name: counts.__setitem__(name, i[0].numel() // i[0].shape[1]))
    step = make_train_step(net, opt, sched, LOSS_WEIGHT, use_perceptual=False, group=group,
                           mixed=mixed)
    stats = step(to_device_train(_items(case["batch"], shard), "cpu"))
    return {"stats": {k: float(v) for k, v in stats.items()},
            "grads": {k: p.grad.clone() for k, p in net.named_parameters()},
            "state": {k: v.clone() for k, v in net.state_dict().items()}, "counts": counts}


def _batchnorm(case, group, rank):
    """The BatchNorm over ranks on this rank's rows of each input of (d)."""
    from gdb_nerf_tpu_torch.models.layers import BatchNorm2d, BatchNorm3d, set_batchnorm_group

    out = {}
    for key, bn_type in (("2d", BatchNorm2d), ("3d", BatchNorm3d)):
        x, g, sd = case["bn"][key]
        bn = set_batchnorm_group(bn_type(x.shape[1]), group).train()
        bn.load_state_dict(sd)
        sl = BN_SPLITS[key][rank]
        xl = x[sl].clone().requires_grad_()
        y = bn(xl)
        (y * g[sl]).sum().backward()
        out[key] = {"y": y.detach(), "x_grad": xl.grad, "weight_grad": bn.weight.grad,
                    "bias_grad": bn.bias.grad, "state": bn.state_dict()}
    return out


def _render(case, group):
    """ShardedRenderer's render of the render batch, and the forward of a
    bundle grid of odd height (33 rows)."""
    from gdb_nerf_tpu_torch.kernels.bundle_head import LAUNCHES
    from gdb_nerf_tpu_torch.models.network import Network
    from gdb_nerf_tpu_torch.parallel import ShardedRenderer
    from gdb_nerf_tpu_torch.runtime import tracing
    from gdb_nerf_tpu_torch.runtime.renderer import to_device

    net = Network(**case["net"], debug_outputs=True)
    net.load_state_dict(case["sd"], strict=True)
    renderer = ShardedRenderer(net, "cpu", group)
    with tracing.recording() as rec:
        ret, _ = renderer.render(to_device(case["render_batch"], "cpu"))
    scoped = net.spatial_group is None
    odd = to_device(case["render_batch"], "cpu")
    odd["src_views"]["rgb"] = torch.zeros(1, 2, 66, 64, 3)
    try:
        renderer.render(odd)
        raised = None
    except ValueError as e:
        raised = str(e)
    return {"ret": {k: v.clone() for k, v in ret.items()}, "odd_height": raised,
            "launches": rec.counter(LAUNCHES),
            "scoped": scoped and net.spatial_group is None}


def _train_net(out):
    """train_net.train at 64x64 for 2 steps on the synthetic loader, with its
    loader, checkpoint writer and recorder watched; it leaves the group."""
    from gdb_nerf_tpu_torch import train_net
    from gdb_nerf_tpu_torch.config import load_cfg

    log = {"shards": [], "saved": [], "recorder_enabled": []}
    loader, save_model, recorder = (train_net.make_data_loader, train_net.checkpoint.save_model,
                                    train_net.Recorder)

    def watched_loader(cfg, is_train, **kw):
        made = loader(cfg, is_train, **kw)
        if is_train:
            log["shards"].append((kw["num_shards"], kw["shard_id"],
                                  list(made.batch_sampler.batch_sampler.sampler)))
        return made

    def watched_save(state, model_dir, epoch, last=False):
        log["saved"].append((epoch, last))
        return save_model(state, model_dir, epoch, last=last)

    class WatchedRecorder(recorder):
        def __init__(self, cfg, enabled=True):
            log["recorder_enabled"].append(enabled)
            super().__init__(cfg, enabled)

    train_net.make_data_loader = watched_loader
    train_net.checkpoint.save_model = watched_save
    train_net.Recorder = WatchedRecorder
    cfg = load_cfg(os.path.join(REPO, "configs", "dtu_pretrain.yaml"), [
        "workspace", str(out), "synthetic", "True", "synthetic_hw", "[64,64]",
        "train.batch_size", "1", "train.num_workers", "0", "ep_iter", "2", "train.epoch", "1",
        "device", "cpu", "mvs.num_depth", "[16,8]"])
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        train_net.train(cfg)
    log["stdout"] = stdout.getvalue()
    log["left_the_group"] = not dist.is_initialized()
    return log


def rank_main(out: str) -> None:
    """One rank of the launch: every phase in turn, its results saved to
    ``<out>/rank<r>.pt``."""
    from gdb_nerf_tpu_torch.parallel import hosts

    device = hosts.maybe_initialize_distributed("cpu")
    group, rank = hosts.default_group(), hosts.rank()
    case = torch.load(os.path.join(out, "case.pt"), weights_only=False)
    res = {"device": str(device), "world": hosts.world_size(), "backend": dist.get_backend()}
    for sd, tag in (("sd", ""), ("sd_np", "_np")):
        res["step" + tag] = _train_step(case, group, slice(rank, rank + 1), sd)
    res["step_bf16"] = _train_step(case, group, slice(rank, rank + 1), "sd", torch.bfloat16)
    # The one-process step on the whole batch: rank 0 on its threads, rank 1
    # on one thread (the same sums in another order).
    threads = torch.get_num_threads()
    torch.set_num_threads(threads if rank == 0 else 1)
    for sd, tag in (("sd", ""), ("sd_np", "_np")):
        res["single" + tag] = _train_step(case, None, slice(0, WORLD), sd)
    res["single_threads"] = torch.get_num_threads()
    torch.set_num_threads(threads)
    res["bn"] = _batchnorm(case, group, rank)
    res["render"] = _render(case, group)
    res["train_net"] = _train_net(out)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


if __name__ == "__main__":
    rank_main(sys.argv[1])


# --- this process ------------------------------------------------------------


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, written for the ranks, and the ranks launched."""
    flags = sorted(k for k in os.environ if k.startswith("GDBN_"))
    assert not flags, f"GDBN_* variables change the JAX reference: {flags}"
    import jax
    import jax.numpy as jnp

    from gdb_nerf_tpu.models.network import Network as JaxNetwork
    from gdb_nerf_tpu.train.step import to_device_train as jax_to_device_train
    from gdb_nerf_tpu_torch.utils.convert import state_dict_from_jax
    from tests.test_torch_port_network import jax_init, jax_variables, small_batch
    from tests.test_torch_port_train import PRETRAIN_NET, optim_cfg, train_batch

    rng = np.random.default_rng(0)
    out = tmp_path_factory.mktemp("ranks")
    batch = train_batch(rng, B=WORLD, V=2)
    jbatch = jax_to_device_train(batch)
    params, stats0 = jax_init(JaxNetwork(**PRETRAIN_NET), jax.tree_util.tree_map(
        lambda a: a[:1], {k: jbatch[k] for k in ("src_views", "tar_views", "near_far")}), rng)
    sd = state_dict_from_jax({"params": params, "batch_stats": stats0})
    drawn = jax_variables(JaxNetwork(**PRETRAIN_NET), {
        k: jbatch[k] for k in ("src_views", "tar_views", "near_far")},
        np.random.default_rng(NUMPY_DRAW_SEED))
    bn = {}
    for key, shape in (("2d", (4, 6, 5, 7)), ("3d", (3, 4, 3, 5, 6))):
        c = shape[1]
        x = torch.from_numpy((rng.normal(size=shape) * 3 + 2).astype(np.float32))
        g = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        bn[key] = (x, g, {
            "weight": torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
            "bias": torch.from_numpy(rng.normal(size=c).astype(np.float32)),
            "running_mean": torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)),
            "running_var": torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
            "num_batches_tracked": torch.tensor(3)})
    written = {"net": PRETRAIN_NET, "sd": sd, "sd_np": state_dict_from_jax(drawn),
               "optim_cfg": optim_cfg(), "batch": batch, "bn": bn,
               "render_batch": small_batch(rng, V=2)}
    torch.save(written, out / "case.pt")
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={WORLD}", "-m", "tests.test_torch_port_parallel", str(out)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield SimpleNamespace(dir=out, proc=proc, jbatch=jbatch, variables={
        "": (params, stats0), "_np": (drawn["params"], drawn["batch_stats"])}, **written)
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_ref(case):
    """The JAX package on a 2-device mesh (one jit each): ``make_train_step``
    with the gradients kept by an identity transform ahead of the optimizer,
    from each draw's weights (keys ``""`` and ``"_np"``), and the eval
    render of the render batch."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh

    from gdb_nerf_tpu.models.network import Network as JaxNetwork
    from gdb_nerf_tpu.train import optim as jax_optim
    from gdb_nerf_tpu.train.step import TrainState, make_train_step
    from tests.test_torch_port_network import XLA_O0, run_jitted

    keep_grads = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda updates, state, params=None: (updates, updates))
    tx = optax.chain(keep_grads, jax_optim.make_optimizer(case.optim_cfg))
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    jnet = JaxNetwork(**case.net, axis_name="data")
    step = make_train_step(jnet, tx, LOSS_WEIGHT, mesh, use_perceptual=False)
    compiled, steps = None, {}
    for tag, (params, stats0) in case.variables.items():
        state = TrainState(params, stats0, tx.init(params), jnp.asarray(0, jnp.int32))
        compiled = compiled or step.lower(state, case.jbatch).compile(XLA_O0)
        new_state, stats = compiled(state, case.jbatch)
        steps[tag] = jax.tree_util.tree_map(np.asarray, {
            "stats": stats, "grads": new_state.opt_state[0], "params": new_state.params,
            "batch_stats": new_state.batch_stats})
    params, stats0 = case.variables[""]
    render_j, _, _ = run_jitted(
        lambda v, b: JaxNetwork(**case.net, debug_outputs=True).apply(v, b, train=False),
        {"params": params, "batch_stats": stats0},
        jax.tree_util.tree_map(jnp.asarray, case.render_batch))
    return {**steps, "render": jax.tree_util.tree_map(np.asarray, render_j)}


@pytest.fixture(scope="module")
def ranks(case, jax_ref):
    """Each rank's results, once the launch has ended."""
    try:
        log, _ = case.proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        case.proc.kill()
        log, _ = case.proc.communicate()
        pytest.fail(f"the 2-rank launch timed out:\n{log[-4000:]}")
    assert case.proc.returncode == 0, log[-6000:]
    return [torch.load(case.dir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def test_config_from_env_matches_jax():
    """The same single- or multi-process choice, address, world size and
    rank; ``TPU_WORKER_HOSTNAMES`` (Cloud-TPU metadata, the JAX function's
    autodetect sentinel ``{}``) means one process on a GPU host."""
    from gdb_nerf_tpu.parallel.hosts import config_from_env as jax_config_from_env
    from gdb_nerf_tpu_torch.parallel.hosts import config_from_env

    for env in ENVS:
        want, got = jax_config_from_env(env), config_from_env(env)
        if "TPU_WORKER_HOSTNAMES" in env:
            assert got is None, env
            continue
        assert (got is None) == (want is None), env
        if want is not None:
            assert got == {"init_method": f"tcp://{want['coordinator_address']}",
                           "world_size": want["num_processes"], "rank": want["process_id"]}, env
    assert config_from_env({"MASTER_ADDR": "h", "WORLD_SIZE": "2"}) == {
        "init_method": "tcp://h:12355", "world_size": 2, "rank": 0}


def test_backend_rule(monkeypatch):
    """gloo for the CPU and for ranks that share a card, nccl where each
    rank of the host has its own."""
    from gdb_nerf_tpu_torch.parallel.hosts import backend_for

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert backend_for(torch.device("cpu"), 1) == "gloo"
    assert backend_for(torch.device("cuda"), 2) == "nccl"
    assert backend_for(torch.device("cuda"), 3) == "gloo"


def check_against_the_mesh(case, jax_ref, ranks, tag):
    """Draw ``tag``'s 2-rank step against the mesh step: every rank's stats
    within 1e-4 relative; every gradient (averaged over ranks, clipped)
    within ``grad_rtol`` relative L2 of the mesh's pmean-ed gradient clipped
    at 40, with a floor (``grad_share``); running_mean within 1e-5 and
    running_var within 1e-5 after the factor n/(n-1), n the element count
    over both ranks; the two replicas equal, bit for bit.  Returns the
    state after the step and the mesh's parameters after it."""
    import jax

    from gdb_nerf_tpu_torch.utils.convert import state_dict_from_jax

    ref, stats0 = jax_ref[tag], case.variables[tag][1]
    sd0 = case.sd if tag == "" else case.sd_np
    assert [r["world"] for r in ranks] == [WORLD] * WORLD
    assert {r["backend"] for r in ranks} == {"gloo"}
    for r in ranks:
        for k, v in ref["stats"].items():
            assert abs(r["step" + tag]["stats"][k] - float(v)) <= 1e-4 * abs(float(v)) + 1e-7, k
    grads = state_dict_from_jax({"params": jax.tree_util.tree_map(
        lambda g: np.clip(g, -40.0, 40.0), ref["grads"]), "batch_stats": stats0})
    after = state_dict_from_jax({"params": ref["params"], "batch_stats": ref["batch_stats"]})
    step = ranks[0]["step" + tag]
    assert set(step["grads"]) <= set(grads)
    gmax = largest({k: grads[k].numpy() for k in step["grads"]})
    for k, g in step["grads"].items():
        share = grad_share(k, g.numpy(), grads[k].numpy(), gmax)
        if k.startswith("depth_net.nerfs.0.color.0."):
            print(f"weights {tag or '_jax'}: {k} relative L2 {rel_l2(g.numpy(), grads[k].numpy()):.2e} "
                  f"from the mesh ({100 * share:.1f} % of its tolerance)")
        assert share <= 1.0, k
    counts = [r["step" + tag]["counts"] for r in ranks]
    assert len(counts[0]) == sum(k.endswith("running_var") for k in sd0)
    for name in counts[0]:
        n = counts[0][name] + counts[1][name]
        np.testing.assert_allclose(step["state"][f"{name}.running_mean"].numpy(),
                                   after[f"{name}.running_mean"].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
        r0 = sd0[f"{name}.running_var"].numpy()
        got = step["state"][f"{name}.running_var"].numpy()
        biased = 0.9 * r0 + (got - 0.9 * r0) * (n - 1) / n
        np.testing.assert_allclose(biased, after[f"{name}.running_var"].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
    for k, v in step["state"].items():
        assert torch.equal(v, ranks[1]["step" + tag]["state"][k]), k
    for k, g in step["grads"].items():
        assert torch.equal(g, ranks[1]["step" + tag]["grads"][k]), k
    return step, after


def test_two_rank_step_matches_the_jax_mesh(case, jax_ref, ranks):
    """(b) On the JAX package's initial weights: ``check_against_the_mesh``,
    and the parameters after one adam step within ``param_rtol`` relative
    L2 of the mesh's."""
    step, after = check_against_the_mesh(case, jax_ref, ranks, "")
    for k in step["grads"]:
        assert rel_l2(step["state"][k].numpy(), after[k].numpy()) <= param_rtol(k), k


def test_two_rank_step_matches_the_jax_mesh_on_numpy_drawn_weights(case, jax_ref, ranks):
    """(b) On numpy's draw of lecun-normal weights, zero biases and
    randomized statistics: ``check_against_the_mesh``, and at most
    PARAMS_APART of the parameters' elements more than 1e-6 from the mesh's
    after one adam step (printed, ``-s``)."""
    step, after = check_against_the_mesh(case, jax_ref, ranks, "_np")
    apart = total = 0
    for k in step["grads"]:
        d = np.abs(step["state"][k].numpy().astype(np.float64) - after[k].numpy())
        apart, total = apart + int((d > 1e-6).sum()), total + d.size
    print(f"numpy draw: {apart} of {total} parameter elements more than 1e-6 from the mesh's")
    assert apart <= PARAMS_APART * total


def test_two_rank_step_matches_one_process(case, ranks):
    """(c) The 2-rank step against the port's step on the whole batch in one
    process: the stats within PORT_RTOL relative, but psnr, which both the
    JAX step and this one average over ranks (not the psnr of the whole
    batch's mse); the gradients by ``grad_share``, as against the JAX step
    (not tighter: the view-weight layers' gradients cancel to near 0, the
    U-Nets' move with summation order); the parameters after the step within ``param_rtol``,
    the BatchNorm statistics within BN_TOL, and the step counts equal."""
    two, one = ranks[0]["step"], ranks[0]["single"]
    for k, v in one["stats"].items():
        if k != "psnr":
            assert abs(two["stats"][k] - v) <= PORT_RTOL * abs(v) + 1e-7, k
    gmax = largest(one["grads"])
    for k, g in one["grads"].items():
        assert grad_share(k, two["grads"][k].numpy(), g.numpy(), gmax) <= 1.0, k
    params = set(one["grads"])
    for k, v in one["state"].items():
        if k in params:
            assert rel_l2(two["state"][k].numpy(), v.numpy()) <= param_rtol(k), k
        elif v.is_floating_point():
            torch.testing.assert_close(two["state"][k], v, rtol=0, atol=BN_TOL, msg=k)
        else:
            assert torch.equal(two["state"][k], v), k


def test_two_rank_bf16_step_takes_one_float32_update(ranks):
    """bf16 on float32 master weights over the 2 ranks: the stats averaged
    over the ranks and the master's float32 gradients all-reduced, so both
    ranks hold the same gradients, parameters and BatchNorm statistics
    after the step, bit for bit, all float32; the loss within 5e-3 of the
    float32 2-rank step's (the bf16 bound of
    ``tests/test_torch_port_train.py``)."""
    a, b = (r["step_bf16"] for r in ranks)
    assert a["stats"] == b["stats"] and a["counts"] == b["counts"] and a["counts"]
    for k in a["grads"]:
        assert a["grads"][k].dtype == torch.float32 and torch.equal(a["grads"][k], b["grads"][k]), k
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k
        assert not a["state"][k].is_floating_point() or a["state"][k].dtype == torch.float32, k
    loss32 = ranks[0]["step"]["stats"]["loss"]
    assert abs(a["stats"]["loss"] - loss32) <= 5e-3 * abs(loss32) + 1e-3


def test_summation_order_alone_stays_inside_the_gradient_bounds(ranks):
    """The port's one-process step on the same inputs on 2 threads (rank 0)
    and on 1 (rank 1), on both draws: the loss within PORT_RTOL, and every
    gradient within ``grad_share``'s tolerance of the other; prints the
    worst of each group and the stage NeRF's first color layer (``-s``)."""
    assert (ranks[0]["single_threads"], ranks[1]["single_threads"]) == (2, 1)
    for tag, draw in (("", "JAX init"), ("_np", "numpy draw")):
        a, b = ranks[0]["single" + tag], ranks[1]["single" + tag]
        assert abs(a["stats"]["loss"] - b["stats"]["loss"]) <= PORT_RTOL * abs(b["stats"]["loss"])
        worst, gmax = {}, largest(b["grads"])
        for k, g in b["grads"].items():
            share = grad_share(k, a["grads"][k].numpy(), g.numpy(), gmax)
            rel = rel_l2(a["grads"][k].numpy(), g.numpy())
            group = k.startswith(SENSITIVE)
            worst[group] = max(worst.get(group, (0.0, 0.0, "")), (rel, share, k))
            if k.startswith("depth_net.nerfs.0.color.0."):
                print(f"summation order, 2 threads against 1, {draw}: {k} relative L2 "
                      f"{rel:.2e} ({100 * share:.1f} % of its tolerance)")
            assert share <= 1.0, k
        for group, (rel, share, k) in sorted(worst.items()):
            print(f"summation order, 2 threads against 1, {draw}, "
                  f"{'FPN and U-Nets' if group else 'the rest'}: worst relative L2 {rel:.2e} "
                  f"at {k} ({100 * share:.1f} % of its tolerance)")


@pytest.mark.parametrize("key", sorted(BN_SPLITS))
def test_batchnorm_over_ranks_matches_one_process(case, ranks, key):
    """(d) On shards of 3 + 1 (2D) and 2 + 1 (3D) items: the ranks' outputs
    and input gradients, stacked, and their weight and bias gradients,
    summed, equal torch's BatchNorm on the whole batch within BN_TOL; the
    running statistics (unbiased variance over the whole batch) too."""
    x, g, sd = case.bn[key]
    bn = (torch.nn.BatchNorm2d if key == "2d" else torch.nn.BatchNorm3d)(x.shape[1]).train()
    bn.load_state_dict(sd)
    xs = x.clone().requires_grad_()
    y = bn(xs)
    (y * g).sum().backward()
    parts = [r["bn"][key] for r in ranks]
    want = {"y": y.detach(), "x_grad": xs.grad}
    for name, ref in want.items():
        got = torch.cat([p[name] for p in parts])
        torch.testing.assert_close(got, ref, rtol=BN_TOL, atol=BN_TOL, msg=name)
    for name, ref in (("weight_grad", bn.weight.grad), ("bias_grad", bn.bias.grad)):
        torch.testing.assert_close(sum(p[name] for p in parts), ref, rtol=BN_TOL, atol=BN_TOL,
                                   msg=name)
    for p in parts:
        for name, ref in bn.state_dict().items():
            torch.testing.assert_close(p["state"][name], ref, rtol=BN_TOL, atol=BN_TOL, msg=name)


def test_sharded_renderer_matches_renderer_and_jax(case, jax_ref, ranks):
    """(e) Every rank returns the whole image, within 1e-5 of Renderer's on
    the same weights (the bound of tests/test_sharded_infer.py) and of the
    JAX Network's render, and the whole ``spb`` map, equal to both; on CPU
    tensors the bundle head takes its plain version; the network is left
    unsharded after each render."""
    from gdb_nerf_tpu_torch.models.network import Network
    from gdb_nerf_tpu_torch.runtime.renderer import Renderer, to_device

    net = Network(**case.net, debug_outputs=True)
    net.load_state_dict(case.sd, strict=True)
    want, _ = Renderer(net, "cpu").render(to_device(case.render_batch, "cpu"))
    for r in ranks:
        assert r["render"]["launches"] == 0 and r["render"]["scoped"]
        for k in ("rgb", "nerf_depth", "mvs_depth", "opacity"):
            got = r["render"]["ret"][k].numpy()
            np.testing.assert_allclose(got, want[k].numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
            np.testing.assert_allclose(got, jax_ref["render"][k], rtol=1e-5, atol=1e-5, err_msg=k)
        spb = r["render"]["ret"]["spb"]
        assert spb.dtype == torch.int32 and torch.equal(spb, want["spb"])
        np.testing.assert_array_equal(spb.numpy(), jax_ref["render"]["spb"])


def test_odd_bundle_grid_height_raises(ranks):
    """(f) 66 rows make 33 bundle rows, which 2 ranks do not divide."""
    for r in ranks:
        assert r["render"]["odd_height"] is not None
        assert "33" in r["render"]["odd_height"] and "not divisible" in r["render"]["odd_height"]


def test_train_net_under_torchrun(case, ranks):
    """(g) Each rank loads its own half of the 8 synthetic scenes, disjoint;
    rank 0 alone writes 0.pth and latest.pth, validates and records; both
    ranks leave the group."""
    logs = [r["train_net"] for r in ranks]
    shards = [log["shards"] for log in logs]
    assert [s[0][:2] for s in shards] == [(WORLD, 0), (WORLD, 1)]
    assert not set(shards[0][0][2]) & set(shards[1][0][2])
    assert sorted(shards[0][0][2] + shards[1][0][2]) == list(range(8))
    assert logs[0]["saved"] == [(0, False), (0, True)] and logs[1]["saved"] == []
    assert logs[0]["recorder_enabled"] == [True] and logs[1]["recorder_enabled"] == [False]
    assert "'psnr'" in logs[0]["stdout"] and "'psnr'" not in logs[1]["stdout"]
    for log in logs:
        assert log["stdout"].count("epoch: 0  iter") == 2 and log["left_the_group"]
    model_dir = case.dir / "trained_model" / "gdb_nerf" / "dtu_pretrain"
    assert sorted(os.listdir(model_dir)) == ["0.pth", "latest.pth"]
