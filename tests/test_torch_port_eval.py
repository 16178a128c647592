"""The port's evaluator and recorder against the JAX package's copies.

``gdb_nerf_tpu_torch.eval`` and ``train/recorder.py`` are copies of the
JAX package's modules: on the same numpy outputs and batches the port's
``Evaluator.summarize()`` equals the JAX one (dtu_eval's protocol, and
llff_eval's ``eval_center`` with ``eval_depth`` on DTU depth scenes), with
LPIPS skipped on both sides when its weights are absent, and within 1e-5
relative when tiny VGG-shaped weights are present; the port's LPIPS equals
the JAX module on those weights within 1e-5 relative, and a broken weights
file raises from the port's evaluator instead of skipping; the same
updates give the two recorders the same ``state_dict`` and ``__str__``.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from gdb_nerf_tpu.config import load_cfg as jax_load_cfg
from gdb_nerf_tpu.eval.evaluator import Evaluator as JaxEvaluator
from gdb_nerf_tpu.eval.lpips import LPIPS as JaxLPIPS
from gdb_nerf_tpu.train.recorder import Recorder as JaxRecorder
from gdb_nerf_tpu_torch.config import load_cfg
from gdb_nerf_tpu_torch.eval.lpips import LPIPS
from gdb_nerf_tpu_torch.runtime.registry import make_evaluator
from gdb_nerf_tpu_torch.train.recorder import Recorder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# VGG16's block structure at tiny widths (tests/test_perceptual.py's plan):
# (channels, 3x3 convs) per block.
LPIPS_PLAN = [(4, 2), (4, 2), (6, 3), (6, 3), (8, 3)]
LPIPS_RTOL = 1e-5


def tiny_lpips_weights(rng) -> dict:
    """The JAX module's weights dict at LPIPS_PLAN's widths: conv{i}_w HWIO,
    conv{i}_b, nonnegative lin{i}_w."""
    weights, cin, li = {}, 3, 0
    for ch, n in LPIPS_PLAN:
        for _ in range(n):
            weights[f"conv{li}_w"] = rng.normal(0, 0.3, (3, 3, cin, ch)).astype(np.float32)
            weights[f"conv{li}_b"] = rng.normal(0, 0.1, (ch,)).astype(np.float32)
            cin, li = ch, li + 1
    for i, (ch, _) in enumerate(LPIPS_PLAN):
        weights[f"lin{i}_w"] = rng.uniform(0, 1, (ch,)).astype(np.float32)
    return weights


def test_lpips_matches_the_jax_module(rng):
    """Two image pairs of 32x48 in [-1, 1]; the JAX module's dict as it is."""
    weights = tiny_lpips_weights(rng)
    ours, theirs = LPIPS(weights), JaxLPIPS(weights)
    for _ in range(2):
        a, b = (rng.uniform(-1, 1, (32, 48, 3)).astype(np.float32) for _ in range(2))
        got, want = ours(a, b), theirs(a, b)
        assert got > 0.0
        assert abs(got - want) <= LPIPS_RTOL * abs(want), (got, want)


def requests(rng, scenes, H=40, W=48):
    """(output, batch) pairs: noisy renders of random targets, masks with a
    hole, depths for the depth metrics (nerf at full size, mvs at 1/2)."""
    out = []
    for i, scene in enumerate(scenes):
        gt = rng.uniform(size=(1, H, W, 3)).astype(np.float32)
        mask = np.ones((1, H, W), np.uint8)
        mask[:, : H // 4, : W // 4] = 0
        depth = rng.uniform(500, 900, (1, H, W)).astype(np.float32)
        depth[:, -3:] = 0.0
        mvs_gt = depth[:, ::2, ::2].copy()
        batch = {
            "tar_views": {"rgb": gt, "mask": mask, "depth": depth},
            "tar_gt_ms": {"depth": [mvs_gt[:, ::4, ::4], mvs_gt]},
            "meta": {"scene": [scene], "tar_view": [i], "frame_id": [0]},
        }
        output = {
            "rgb": gt + rng.normal(scale=0.02 * (i + 1), size=gt.shape).astype(np.float32),
            "nerf_depth": depth + rng.normal(scale=4.0, size=depth.shape).astype(np.float32),
            "mvs_depth": mvs_gt + rng.normal(scale=6.0, size=mvs_gt.shape).astype(np.float32),
        }
        out.append((output, batch))
    return out


@pytest.mark.parametrize("name, overrides, lpips_weights", [
    ("dtu_eval", [], False),
    ("llff_eval", ["test.eval_depth", "True"], False),
    ("dtu_eval", [], True),
])
def test_evaluator_summary_equals_the_jax_package(name, overrides, lpips_weights, rng, tmp_path,
                                                  monkeypatch, capsys):
    """Without LPIPS weights both evaluators print ``lpips: SKIPPED`` (the
    port's FileNotFoundError path); with tiny ones in the workspace both
    score it, the port on the CPU (``device cpu``)."""
    monkeypatch.setenv("workspace", str(tmp_path))
    if lpips_weights:
        (tmp_path / "weights").mkdir()
        np.savez(tmp_path / "weights" / "lpips_vgg.npz", **tiny_lpips_weights(rng))
    path = os.path.join(REPO, "configs", f"{name}.yaml")
    cfg, jcfg = load_cfg(path, overrides + ["device", "cpu"]), jax_load_cfg(path, overrides)
    assert cfg.eval_lpips and cfg.test.eval_center == (name == "llff_eval")
    ours, theirs = make_evaluator(cfg), JaxEvaluator(jcfg)
    reqs = requests(rng, ["scan1", "scan8", "scan1", "scan4"])
    for output, batch in reqs:
        ours.evaluate(output, batch)
        theirs.evaluate(output, batch)
    capsys.readouterr()
    got = ours.summarize()
    printed = capsys.readouterr().out
    want = theirs.summarize()
    assert ("'mvs_abs'" in printed) == cfg.test.eval_depth
    assert "scan8" in printed
    if not lpips_weights:
        assert got == want and got["lpips"] == "SKIPPED (weights absent)"
        assert "lpips: SKIPPED" in printed
        return
    assert isinstance(got["lpips"], float) and "SKIPPED" not in printed
    lp, want_lp = got.pop("lpips"), want.pop("lpips")
    assert abs(lp - want_lp) <= LPIPS_RTOL * abs(want_lp) and got == want


def test_evaluator_raises_on_broken_lpips_weights(rng, tmp_path, monkeypatch):
    """Only an absent weights file skips LPIPS: one without a head's weights
    raises (the JAX evaluator would skip it)."""
    monkeypatch.setenv("workspace", str(tmp_path))
    (tmp_path / "weights").mkdir()
    weights = tiny_lpips_weights(rng)
    del weights["lin4_w"]
    np.savez(tmp_path / "weights" / "lpips_vgg.npz", **weights)
    cfg = load_cfg(os.path.join(REPO, "configs", "dtu_eval.yaml"), ["device", "cpu"])
    with pytest.raises(KeyError, match="lin4_w"):
        make_evaluator(cfg)


def test_recorder_equals_the_jax_package(tmp_path):
    cfg = SimpleNamespace(record_dir=str(tmp_path / "record"), resume=False)
    ours, theirs = Recorder(cfg), JaxRecorder(cfg)
    rng = np.random.default_rng(3)
    for step in range(25):
        stats = {"loss": float(rng.uniform()), "psnr": float(rng.uniform(10, 30)),
                 "depth_loss0": float(rng.uniform())}
        for r in (ours, theirs):
            r.step += 1
            r.update_loss_stats(stats)
            r.batch_time.update(0.1 * step)
    assert ours.state_dict() == theirs.state_dict() == {"step": 25}
    assert str(ours) == str(theirs)
    assert ours.batch_time.global_avg == theirs.batch_time.global_avg
    fresh = Recorder(SimpleNamespace(record_dir=str(tmp_path / "record"), resume=True))
    fresh.load_state_dict(ours.state_dict())
    assert fresh.step == 25
