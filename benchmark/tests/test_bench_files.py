"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its file."""

import json
import re
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["command"]) <= 32
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
               and ".." not in p for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert len(json.dumps(BENCH)) <= 64 * 1024
    # The full check of 24 cells fits its 43,200 seconds.
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries_have_the_contracts_keys(kind):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[kind]
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    text = {"configs": ("why", "source"), "workloads": ("why",), "per_layer": ("layer",)}
    for e in BENCH[kind]:
        assert set(e) - {"workloads"} == keys, e
        assert NAME.match(e["name"]), e["name"]
        for field in text.get(kind, ()):
            assert 1 <= len(e[field]) <= 200 and "\n" not in e[field] and "\t" not in e[field]
        for key in e.get("reduced", []):
            assert NAME.match(key)


def test_metrics():
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in CELLS
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):  # each cell it lists reports what it moves
            assert spec.in_cell(e2e[m["moves"]], cell), (m["name"], cell)
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) == {"runtime", "datasets loader", "kernels", "model step", "device"}


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if spec.in_cell(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"] if spec.in_cell(m, cell)]
    assert layer
    # Beside a kernel's roofline, the whole step's share of the peak moves
    # the same end-to-end metric.
    for roof in (m for m in layer if "_roofline" in m["name"]):
        assert any("mfu" in m["name"] and m["moves"] == roof["moves"] for m in layer)


def test_cells():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    configs = {c["name"] for c in BENCH["configs"]}
    assert {w["config"] for w in BENCH["workloads"]} == configs
    assert all(w["chips"] in (1, 4) and len(w["why"]) <= 200 for w in BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_every_name_resolves_to_a_file(cell):
    c = spec.load_cell(cell)
    for name, reader in c.readers.items():
        assert (spec.HERE / "readers" / f"{reader['reader']}.py").exists(), name
    assert (spec.HERE / "kinds" / f"{c.mix['kind']}.py").exists()
    for name, lim in c.limits.items():
        assert set(lim) == {"limit", "lower", "upper"}, name
        assert lim["lower"] <= lim["limit"] < lim["upper"] or lim["limit"] == 0 == lim["lower"]


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_file_is_the_yaml_as_run(name):
    """The configuration's ``cfg`` is what the program's own loader makes of
    the YAML and the overrides, but for the machine's paths."""
    from gdb_nerf_tpu_torch.config.config import load_cfg

    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    path = spec.ROOT / entry["file"]
    assert path.is_relative_to(spec.HERE)
    conf = json.loads(path.read_text())
    assert conf["source"] == entry["source"] and conf["reduced"] == entry["reduced"]
    assert set(entry["reduced"]) >= set(conf["overrides"])
    opts = []
    for k, v in conf["overrides"].items():
        opts += [k, repr(v)]
    cfg = load_cfg(str(spec.ROOT / conf["yaml"]), opts)

    def plain(ns):
        if isinstance(ns, SimpleNamespace):
            return {k: plain(v) for k, v in vars(ns).items()}
        return [plain(v) for v in ns] if isinstance(ns, (list, tuple)) else ns

    want = plain(cfg)
    for k in ("workspace", "trained_model_dir", "record_dir", "result_dir"):
        want.pop(k)
    assert conf["cfg"] == want
    assert conf["dtype"] == conf["cfg"]["compute_dtype"]


def test_command_runs_the_harness_and_names_only_its_files():
    assert BENCH["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert all(Path(p).parts[0] == "benchmark" for p in BENCH["paths"])
