"""The port's evaluator and recorder against the JAX package's copies.

``gdb_nerf_tpu_torch.eval`` and ``train/recorder.py`` are copies of the
JAX package's modules: on the same numpy outputs and batches the port's
``Evaluator.summarize()`` equals the JAX one (dtu_eval's protocol, and
llff_eval's ``eval_center`` with ``eval_depth`` on DTU depth scenes), with
LPIPS skipped on both sides; the same updates give the two recorders the
same ``state_dict`` and ``__str__``.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from gdb_nerf_tpu.config import load_cfg as jax_load_cfg
from gdb_nerf_tpu.eval.evaluator import Evaluator as JaxEvaluator
from gdb_nerf_tpu.train.recorder import Recorder as JaxRecorder
from gdb_nerf_tpu_torch.config import load_cfg
from gdb_nerf_tpu_torch.runtime.registry import make_evaluator
from gdb_nerf_tpu_torch.train.recorder import Recorder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.mark.parametrize("name, overrides", [
    ("dtu_eval", []),
    ("llff_eval", ["test.eval_depth", "True"]),
])
def test_evaluator_summary_equals_the_jax_package(name, overrides, rng, tmp_path, monkeypatch,
                                                  capsys):
    monkeypatch.setenv("workspace", str(tmp_path))  # no LPIPS weights on either side
    path = os.path.join(REPO, "configs", f"{name}.yaml")
    cfg, jcfg = load_cfg(path, overrides), jax_load_cfg(path, overrides)
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
    assert got == want and got["lpips"] == "SKIPPED (weights absent)"
    assert "lpips: SKIPPED" in printed and "scan8" in printed
    assert ("'mvs_abs'" in printed) == cfg.test.eval_depth


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
