"""A later change adds a traffic mix, a kind of traffic and a per-layer metric
with new files and entries alone: here they come from a temporary folder,
and the harness runs the new cell and reports the new metric without an
edit to any file it already has."""

import json

from benchmark import spec
from benchmark.run import execute


def test_a_new_mix_and_metric_from_files(tmp_path, tiny_bench, few_threads):
    tiny_bench("dtu_eval.hd_stream")  # the benchmark's files, cut to a small frame
    bench_file = tmp_path / "BENCHMARK.json"
    bench = json.loads(bench_file.read_text())
    mix = json.loads((tmp_path / "traffic" / "hd_stream.json").read_text())
    mix.update(in_flight=2, pool=3)
    (tmp_path / "traffic" / "pair.json").write_text(json.dumps(mix))
    (tmp_path / "readers").mkdir()
    (tmp_path / "readers" / "longest.py").write_text(
        "def read(obs, series):\n"
        "    v = obs['series'].get(series, [])\n"
        "    return max(v) if v else None\n")
    (tmp_path / "metrics" / "frame_ms_max.json").write_text(
        json.dumps({"reader": "longest", "args": {"series": "latency_ms"}}))
    (tmp_path / "checks" / "dtu_eval.pair.json").write_text(
        (tmp_path / "checks" / "dtu_eval.hd_stream.json").read_text())
    bench["workloads"].append({"name": "dtu_eval.pair", "config": "dtu_eval", "traffic": "pair",
                               "chips": 1, "why": "two in flight"})
    for m in bench["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("dtu_eval.pair")
    bench["per_layer"].append({"name": "frame_ms_max", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "runtime",
                               "moves": "frames_per_s", "workloads": ["dtu_eval.pair"]})
    bench_file.write_text(json.dumps(bench))

    cell = spec.load_cell("dtu_eval.pair", bench_file, tmp_path)
    assert cell.mix["in_flight"] == 2
    e2e = execute(cell, 2**31 + 99, 0.5, False, "cpu")["result"]
    assert set(e2e["metrics"]) == {"setup_s", "frames_per_s"}
    traced = execute(cell, 2**31 + 99, 0.5, True, "cpu")["result"]
    assert set(traced["metrics"]) == {"frame_ms_max"}
    assert traced["metrics"]["frame_ms_max"]["value"] > 0


IDLE_KIND = """
import time


def run(cell, seed, seconds, traced, device, t_start, controls=False):
    setup_s = time.time() - t_start
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        time.sleep(cell.mix["period_s"])
        n += 1
    obs = {"setup_s": setup_s, "window_s": time.perf_counter() - t0, "count": {"frames": n},
           "series": {"latency_ms": [cell.mix["period_s"] * 1e3] * n}, "trace": None}
    return {"obs": obs, "readings": {"rgb_rel_q50": 0.0}, "controls": {}, "attempted": n,
            "failed": 0, "memory_peak": 0, "traced_units": 0}
"""


def test_a_new_kind_from_files(tmp_path, tiny_bench):
    tiny_bench("dtu_eval.hd_stream")
    bench_file = tmp_path / "BENCHMARK.json"
    bench = json.loads(bench_file.read_text())
    (tmp_path / "kinds").mkdir()
    (tmp_path / "kinds" / "idle.py").write_text(IDLE_KIND)
    (tmp_path / "traffic" / "ticks.json").write_text(json.dumps({"kind": "idle",
                                                                 "period_s": 0.01}))
    (tmp_path / "checks" / "dtu_eval.ticks.json").write_text(
        json.dumps({"rgb_rel_q50": {"limit": 0.1, "lower": 0.0, "upper": 1.0}}))
    bench["workloads"].append({"name": "dtu_eval.ticks", "config": "dtu_eval",
                               "traffic": "ticks", "chips": 1, "why": "a clock"})
    for m in bench["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("dtu_eval.ticks")
    bench_file.write_text(json.dumps(bench))

    cell = spec.load_cell("dtu_eval.ticks", bench_file, tmp_path)
    r = execute(cell, 2**31 + 7, 0.3, False, "cpu")["result"]
    assert r["correct"] and r["attempted"] > 0
    assert set(r["metrics"]) == {"setup_s", "frames_per_s"}
    assert 0 < r["metrics"]["frames_per_s"]["value"] <= 100
