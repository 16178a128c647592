"""The plain reference against the measured program on the CPU, float32,
at 64x96: the eval forward (the program's bundle head runs its plain
version on the CPU), one training step, and the frozen scene maker against
the program's synthetic data set."""

import json
import types

import numpy as np
import torch

from benchmark import common, spec, train_data
from benchmark.reference import scenes, train_step
from benchmark.reference import weights as seeded

HW = (64, 96)


def config(name, **cfg):
    conf = json.loads((spec.HERE / "configs" / f"{name}.json").read_text())["cfg"]
    return {**conf, **cfg}


def test_eval_forward_equals_the_programs(few_threads):
    cfg = config("dtu_eval", compute_dtype="float32")
    state = common.seeded_state(cfg, 11, "cpu")
    prog = common.program_network(cfg, torch.float32, state, "cpu").eval()
    ref = common.reference_network(cfg, "cpu")
    ref.load_state_dict(state)
    ref.eval()
    exts, K = scenes.extrinsics(11, 1), scenes.intrinsics(HW)
    req = scenes.request_inputs(scenes.render(exts, K, HW, "cpu")[0], exts[0], K, 3)
    with torch.no_grad():
        p, p_mvs, _ = prog(req)
        r, r_mvs, _ = ref(req)
    torch.testing.assert_close(p["rgb"], r["rgb"], rtol=1e-5, atol=1e-5)
    for a, b in zip(p_mvs, r_mvs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-3)


def test_train_step_equals_the_programs(tmp_path, few_threads):
    """One step of the program's trainer and of the reference from the same
    weights on the same batch: the loss, the first gradient as adam holds it
    and the parameters after the step."""
    from gdb_nerf_tpu_torch.train import losses as program_losses
    from gdb_nerf_tpu_torch.train.trainer import Trainer

    cfg = config("dtu_pretrain")
    state = common.seeded_state(cfg, 12, "cpu")
    vgg = seeded.vgg(12, "cpu")
    spec.load_kind("train").write_vgg(vgg, tmp_path)
    mp = __import__("pytest").MonkeyPatch()
    mp.setenv("workspace", str(tmp_path))
    program_losses._vgg_weights.cache_clear()
    try:
        trainer = Trainer(common.namespace(cfg),
                          common.program_network(cfg, torch.float32, state, "cpu"), "cpu")
        exts, K = scenes.extrinsics(12, 2), scenes.intrinsics(HW)
        imgs = scenes.render(exts, K, HW, "cpu").numpy()
        batch = train_data.collate([scenes.train_item(imgs[i], exts[i], K, 3,
                                                      cfg["mvs"]["vol_scales"]) for i in range(2)])
        loss = trainer.train_step(batch)["loss"]
    finally:
        program_losses._vgg_weights.cache_clear()
        mp.undo()
    ref = common.reference_network(cfg, "cpu")
    ref.load_state_dict(state)
    ref.train()
    lr = train_step.exponential_lr(cfg["train"], cfg["ep_iter"])
    losses, g1 = train_step.run_steps(ref, [train_step.device_batch(batch, "cpu")],
                                      cfg["mvs"]["loss_weight"], vgg, lr)
    assert np.isclose(loss, losses[0], rtol=1e-6)
    params = dict(trainer.network.named_parameters())
    for name, p in ref.named_parameters():
        m = trainer.optimizer.state[params[name]]["exp_avg"] / 0.1
        torch.testing.assert_close(m, g1[name], rtol=1e-4, atol=1e-9)
        torch.testing.assert_close(params[name].detach(), p.detach(), rtol=1e-5, atol=1e-7)


def test_scenes_are_the_programs_synthetic_renders():
    from gdb_nerf_tpu_torch.datasets.synthetic import Dataset

    cfg = types.SimpleNamespace(synthetic_hw=HW, mvs=types.SimpleNamespace(vol_scales=[0.125, 0.5]))
    ds = Dataset(cfg, split="train", num_items=2)
    exts = np.stack(ds.metas[0])
    ours = scenes.render(exts, scenes.intrinsics(HW), HW, "cpu").numpy()
    np.testing.assert_allclose(ours, np.stack([ds._render(e) for e in exts]), atol=1e-6)
    np.testing.assert_array_equal(scenes.intrinsics(HW), ds.K)
    item, want = scenes.train_item(ours, exts, ds.K, 3, [0.125, 0.5]), ds[(0, 3, 1.0)]
    for k in ("rgb", "mask", "depth"):
        for a, b in zip(item["tar_gt_ms"][k], want["tar_gt_ms"][k]):
            np.testing.assert_allclose(a, b, atol=1e-6)
    assert item["near_far"].tolist() == want["near_far"].tolist()
