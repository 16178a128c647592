"""Each cell's traffic run whole on the CPU at 64x96, against the cell's own
limits, and the same runs with the timed path broken underneath, which have
to come out not correct: an rgb altered where it is produced (its colour
channels in the wrong order, or a band of rows blacked out, render), a
step that leaves the state unchanged and a step on half of the batch
(training)."""

import json
import math

import pytest
import torch

from benchmark import spec
from benchmark.run import execute

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 12345  # more than 32 signed bits hold


def keys_ok(result, cell, traced):
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["attempted"] > 0 and result["failed"] == 0
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"} and math.isfinite(c["value"])
    want = {m["name"] for m in (cell.per_layer if traced else cell.end_to_end)}
    assert set(result["metrics"]) <= want
    return result


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_whole_and_correct(name, tiny_bench, few_threads):
    cell = tiny_bench(name)
    r = keys_ok(execute(cell, SEED, 0.5, False, "cpu")["result"], cell, False)
    assert {"setup_s"} < set(r["metrics"])
    assert r["correct"], r["checks"]
    t = keys_ok(execute(cell, SEED + 1, 0.5, True, "cpu")["result"], cell, True)
    assert t["correct"], t["checks"]
    assert set(t["breakdown"]) == {"device_ops", "idle_gaps"}


def flipped(rgb):  # the colour channels in the wrong order, the whole frame
    return rgb.flip(-1)


def bottom_rows(rgb):  # the last 4 rows of 64 black: a sixteenth of the frame
    out = rgb.clone()
    out[:, -4:] = 0
    return out


@pytest.mark.parametrize("name", [c for c in CELLS if c.startswith("dtu_eval.")])
@pytest.mark.parametrize("fault, caught_by", [(flipped, "rgb_q50_vs_bf16"),
                                              (bottom_rows, "rgb_q99_vs_bf16")])
def test_altered_rgb_is_not_correct(name, fault, caught_by, tiny_bench, few_threads,
                                    monkeypatch):
    from gdb_nerf_tpu_torch.models.network import Network

    decode = Network.decode

    def altered(self, *a, **k):
        ret = decode(self, *a, **k)
        ret["rgb"] = fault(ret["rgb"])
        return ret

    monkeypatch.setattr(Network, "decode", altered)
    r = execute(tiny_bench(name), SEED, 0.5, False, "cpu")["result"]
    assert not r["correct"]
    assert r["checks"][caught_by]["value"] > r["checks"][caught_by]["limit"]


def test_unchanged_state_is_not_correct(tiny_bench, few_threads, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    r = execute(tiny_bench("dtu_pretrain.train"), SEED, 0.5, False, "cpu")["result"]
    assert not r["correct"]
    assert r["checks"]["dparam3_leaf_gap"]["value"] == 1.0


def test_half_batch_is_not_correct(tiny_bench, few_threads, monkeypatch):
    from gdb_nerf_tpu_torch.train.trainer import Trainer

    step = Trainer.train_step

    def half(self, batch):
        n = batch["src_views"]["rgb"].shape[0] // 2

        def rows(x):
            if isinstance(x, dict):
                return {k: rows(v) for k, v in x.items()}
            if isinstance(x, list):
                return [rows(v) for v in x] if x and hasattr(x[0], "shape") else x[:n]
            return x[:n]

        return step(self, {k: rows(v) for k, v in batch.items()})

    monkeypatch.setattr(Trainer, "train_step", half)
    r = execute(tiny_bench("dtu_pretrain.train"), SEED, 0.5, False, "cpu")["result"]
    assert not r["correct"]


def test_every_slot_is_sampled_from_its_own_buffer():
    render = spec.load_kind("render")
    H, W, slots = 4, 6, 4

    class Stub:  # a frame filled with its scene's number, and its depth map
        def render(self, batch):
            scene = batch["src_views"]["rgb"][0, 0, 0, 0, 0]
            return {"rgb": torch.full((1, H, W, 3), float(scene))}, [torch.zeros(1, H, W)]

    pool = [{"src_views": {"rgb": torch.full((1, 2, H, W, 3), float(i))}} for i in range(5)]
    loop = render.RenderLoop(Stub(), pool, list(range(5)), slots, torch.device("cpu"))
    keep = [render.Reservoir(2, SEED, s) for s in range(slots)]
    loop.run(count=37, keep=keep)
    assert [len(r.items) for r in keep] == [2] * slots
    for r in keep:
        for item in r.items:
            assert bool((item["rgb"] == item["scene"]).all())
