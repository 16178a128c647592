"""The port's tools that measure the model, on the CPU at 64x64, without jax.

(a) ``tools/bf16_gate.py`` end to end through its ``main`` with ``--device
    cpu`` (the plain head): 2 float32 training steps at 64x64 with 3 source
    views, ``latest.pth`` saved and loaded back through
    ``utils/checkpoint.py::load_network``, 2 scenes rendered in float32 and
    bf16; its JSON rows carry every field, its summary the worst delta,
    the bar and ``pass``, and its exit code follows ``pass``.
(b) ``tools/measure_fill.py`` on that checkpoint: its histogram equals
    ``torch.bincount`` of the forward's ``spb``, and its fill factor that
    histogram's mean over S.
(c) ``tools/measure_lod.py``: ``lod_stats`` equals the JAX tool's numpy
    statistics on a known array, every key; on that checkpoint the tool
    counts every lod of every mip fetch of the forward and puts the fetch
    back.
Each tool runs at 64x64 in place of its protocol size, with 16 + 8 depth
planes.

Run as a script, the module measures the bf16 gate of both packages on one
trained checkpoint on the CPU (``gate_against_jax``; it imports jax only
there).  That is a one-off witness for ROADMAP queue 3's question of what
the gate should hold, not a test: pytest does not run it.

    python -m tests.test_torch_port_tools CKPT H W SCENES
"""

import contextlib
import io
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gdb_nerf_tpu_torch.ops import bundles, mip
from gdb_nerf_tpu_torch.runtime.renderer import to_device
from gdb_nerf_tpu_torch.tools import bf16_gate, measure_common, measure_fill, measure_lod
from gdb_nerf_tpu_torch.utils.checkpoint import load_network

SMALL = ["synthetic_hw", "[64,64]", "mvs.num_depth", "[16,8]"]
ROW_KEYS = {"scene", "agree_db", "gt_f32", "gt_bf16", "gate_delta_bf16_trained"}


def json_lines(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def gated(tmp_path_factory):
    """bf16_gate's main at the small size: its exit code and printed lines."""
    out = tmp_path_factory.mktemp("gate")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("workspace", str(out / "workspace"))  # no VGG weights: no perceptual term
        mp.setattr(bf16_gate, "RECIPE", bf16_gate.RECIPE + SMALL + [
            "ep_iter", "2", "train.epoch", "1", "train.batch_size", "1"])
        mp.setattr(bf16_gate, "EVAL", bf16_gate.EVAL + SMALL)
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            code = bf16_gate.main(["--device", "cpu", "--out", str(out / "model"),
                                   "--scenes", "2"])
    return SimpleNamespace(model=str(out / "model"), code=code, lines=json_lines(stdout.getvalue()))


@pytest.fixture
def at_64x64(monkeypatch):
    """The measure tools' dtu_eval at 64x64 with 16 + 8 depth planes."""
    monkeypatch.setitem(measure_common.PROTOCOL_HW, "dtu_eval", (64, 64))
    eval_cfg = measure_common.eval_cfg
    monkeypatch.setattr(measure_common, "eval_cfg",
                        lambda name, overrides=(): eval_cfg(name, [*overrides, *SMALL[2:]]))


def test_bf16_gate_round_trip_on_cpu(gated):
    trained, *rows, summary = gated.lines
    assert trained["steps"] == 2 and trained["views"] == [3]
    assert np.isfinite([trained["first_loss"], trained["last_loss"]]).all()
    assert trained["seed"] == 0 and trained["batch_size"] == 1
    assert len(trained["loss_digest"]) == 16 and int(trained["loss_digest"], 16) >= 0
    assert trained["mean_step_ms"] is None  # CUDA-event step times exist on the card only
    state, path = load_network(gated.model)
    assert os.path.basename(path) == "latest.pth" and summary["ckpt"] == gated.model
    assert len(rows) == 2 and all(set(r) == ROW_KEYS for r in rows)
    for r in rows:
        assert r["gate_delta_bf16_trained"] == pytest.approx(abs(r["gt_bf16"] - r["gt_f32"]))
        assert np.isfinite([r["agree_db"], r["gt_f32"], r["gt_bf16"]]).all()
    worst = max(r["gate_delta_bf16_trained"] for r in rows)
    assert summary["worst_gate_delta_bf16_trained"] == worst and summary["gate_bar"] == 0.05
    assert summary["pass"] == (worst <= 0.05) and gated.code == (0 if summary["pass"] else 1)
    assert summary["launches"] == {"float32": 0, "bfloat16": 0}  # CPU tensors: the plain head


def test_measure_fill_histogram_is_the_bincount_of_spb(gated, at_64x64, capsys):
    measure_fill.main(["--cfgs", "dtu_eval", "--scenes", "2", "--ckpt", gated.model,
                       "--device", "cpu"])
    (row,) = json_lines(capsys.readouterr().out)
    cfg = measure_common.eval_cfg("dtu_eval")
    renderer = measure_common.renderer_for(cfg, "cpu", load_network(gated.model)[0],
                                           debug_outputs=True)
    S = cfg.nerf.max_num_samples
    want = torch.zeros(S + 1, dtype=torch.int64)
    for batch in measure_common.first_batches(cfg, 2):
        ret, _ = renderer.render(to_device(batch, "cpu"))
        assert ret["spb"].shape == (1, 32, 32) and ret["spb"].dtype == torch.int32
        want += torch.bincount(ret["spb"].reshape(-1), minlength=S + 1)
    assert row["config"] == "dtu_eval" and row["S"] == S == 3 and row["hw"] == [64, 64]
    assert row["spb_hist"] == {str(k): int(v) for k, v in enumerate(want) if v}
    assert sum(row["spb_hist"].values()) == 2 * 32 * 32
    mean = float((torch.arange(S + 1) * want).sum()) / float(want.sum())
    assert row["mean_spb"] == pytest.approx(mean) and row["fill_factor"] == pytest.approx(mean / S)
    assert set(row) >= {"config", "S", "mean_spb", "fill_factor", "spb_hist", "note"}


def numpy_lod_stats(lods: np.ndarray, max_level: int) -> dict:
    """tools/measure_lod.py's statistics, as the JAX tool computes them."""
    clipped = np.clip(lods, 0.0, float(max_level))
    hist, edges = np.histogram(clipped, bins=[-0.01] + [i * 0.5 for i in range(2 * max_level + 1)])
    frac = clipped - np.floor(clipped)
    return {
        "max_level": max_level,
        "n": int(lods.size),
        "raw_min": float(lods.min()),
        "raw_max": float(lods.max()),
        "mean": float(clipped.mean()),
        "frac_le_0": float((lods <= 0.0).mean()),
        "frac_lt_1": float((clipped < 1.0).mean()),
        "frac_ge_max": float((lods >= max_level).mean()),
        "frac_frac_lt_0.05": float((frac < 0.05).mean()),
        "hist_halves": {f"[{edges[i]:.1f},{edges[i+1]:.1f})": int(hist[i])
                        for i in range(len(hist))},
    }


@pytest.mark.parametrize("max_level", [3, 1])
def test_lod_stats_match_the_jax_tools_statistics(rng, max_level):
    """Values below 0, on every bin edge, just under one, fractions near 0,
    at and above the top level."""
    edges = np.arange(0.0, max_level + 0.5, 0.5)
    lods = np.concatenate([
        rng.uniform(-2.0, max_level + 1.0, 997), edges, np.nextafter(edges, -np.inf),
        [-0.01, -1e-7, 0.0, 0.04, 1.03, max_level, max_level + 5.0]]).astype(np.float32)
    got = measure_lod.lod_stats(torch.from_numpy(lods), max_level)
    want = numpy_lod_stats(lods, max_level)
    assert got.keys() == want.keys()
    assert got["hist_halves"] == want["hist_halves"]
    assert sum(got["hist_halves"].values()) == got["n"] == lods.size
    for k in ("max_level", "n", "raw_min", "raw_max", "frac_le_0", "frac_lt_1", "frac_ge_max",
              "frac_frac_lt_0.05"):
        assert got[k] == want[k], k
    assert got["mean"] == pytest.approx(want["mean"], rel=1e-6)  # float64 against float32 sums


def test_measure_lod_counts_every_fetch(gated, at_64x64, capsys):
    measure_lod.main(["--cfgs", "dtu_eval", "--scenes", "2", "--ckpt", gated.model,
                      "--device", "cpu"])
    (row,) = json_lines(capsys.readouterr().out)
    assert bundles.mip_texture_fetch is mip.mip_texture_fetch
    # 2 scenes x 3 views x 32 x 32 bundles x 3 samples, one lod each.
    assert row["n"] == 2 * 3 * 32 * 32 * 3 == sum(row["hist_halves"].values())
    assert row["config"] == "dtu_eval" and row["max_level"] == 3
    assert row["raw_min"] <= row["mean"] <= max(row["raw_max"], 0.0)
    assert 0.0 <= row["frac_le_0"] <= row["frac_lt_1"] <= 1.0


def gate_against_jax(ckpt: str, hw, scenes: int) -> list[dict]:
    """The bf16 gate's rows (PSNR against the target of the float32 and the
    bf16 render, clipped to [0, 1], and their difference) of the JAX
    package and of the port on the same weights: the port's checkpoint
    ``ckpt``, carried into the JAX Network by tools/convert_checkpoint.py,
    on the first ``scenes`` synthetic dtu_eval scenes at ``hw`` on the CPU.
    Beside them the port's float32 render from the same weights rounded to
    bf16 in the layers that the bf16 network casts, and the agreement of
    the two packages' renders in each dtype."""
    import dataclasses
    import sys
    from types import SimpleNamespace

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from gdb_nerf_tpu.config import load_cfg as jax_load_cfg
    from gdb_nerf_tpu.runtime import make_network as jax_make_network
    from gdb_nerf_tpu_torch.eval.metrics import psnr
    from gdb_nerf_tpu_torch.models.layers import cast_weights
    from tests.test_torch_port_network import run_jitted

    sys.path.insert(0, os.path.join(measure_common.REPO, "tools"))
    from convert_checkpoint import convert

    state = load_network(ckpt)[0]
    tree = convert({k: v.numpy() for k, v in state.items() if not k.endswith("num_batches_tracked")},
                   num_stages=2, dec_layers=3, stage_feat_dims=(32,), bundle_feat_dim=16,
                   voxel_dim=8, hid_dim=64)
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    size = ["synthetic_hw", f"[{hw[0]},{hw[1]}]"]
    cfg = measure_common.eval_cfg("dtu_eval", size)
    batches = measure_common.first_batches(cfg, scenes)
    jnet = jax_make_network(jax_load_cfg(os.path.join(measure_common.REPO, "configs",
                                                      "dtu_eval.yaml"), ["synthetic", "True", *size]))
    renders = {}
    for dt in ("float32", "bfloat16", "rounded"):
        if dt != "rounded":
            net = dataclasses.replace(jnet, compute_dtype=dt)
            renders["jax", dt] = [np.clip(np.asarray(run_jitted(
                lambda v, x: net.apply(v, x, train=False)[0]["rgb"], variables,
                {k: jax.tree_util.tree_map(jnp.asarray, b[k]) for k in
                 ("src_views", "tar_views", "near_far")}), np.float32)[0], 0, 1) for b in batches]
        renderer = measure_common.renderer_for(SimpleNamespace(**{
            **vars(cfg), "compute_dtype": "float32" if dt == "rounded" else dt}), "cpu", state)
        if dt == "rounded":  # bf16 values in float32 layers
            net = renderer.network
            cast_weights(net, torch.bfloat16, keep=(net.nerf.sigma[0], net.upsampler.out_conv))
            net.float()
        renders["port", dt] = [np.clip(renderer.render(to_device(b, "cpu"))[0]["rgb"].float()
                                       .numpy()[0], 0, 1) for b in batches]
    rows = []
    for i, b in enumerate(batches):
        gt = np.asarray(b["tar_views"]["rgb"][0], np.float32)
        row = {"scene": i}
        for pkg, dt in renders:
            row[f"{pkg}_{dt}"] = psnr(gt, renders[pkg, dt][i])
        for pkg in ("jax", "port"):
            row[f"{pkg}_delta"] = row[f"{pkg}_bfloat16"] - row[f"{pkg}_float32"]
        row["port_rounded_delta"] = row["port_rounded"] - row["port_float32"]
        for dt in ("float32", "bfloat16"):
            row[f"{dt}_jax_vs_port"] = psnr(renders["jax", dt][i], renders["port", dt][i])
        rows.append(row)
    return rows


if __name__ == "__main__":
    import sys

    ckpt, H, W, n = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
    for row in gate_against_jax(ckpt, (H, W), n):
        print(json.dumps(row), flush=True)
