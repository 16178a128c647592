"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix, one metric
or one cell sits in a file of its own, found by its name:

- ``configs/<config>.json``: the configuration as it is run (``cfg``) with
  its dtype, source, ``reduced`` and ``assumed``;
- ``traffic/<mix>.json``: the traffic mix's parameters, read by the one
  generator of its ``kind``, ``kinds/<kind>.py`` (``render``, ``train``);
- ``metrics/<metric>.json``: the reader (``readers/<reader>.py``) that takes
  the metric from the run's observations, and its arguments;
- ``checks/<cell>.json``: the limits that decide ``correct`` in that cell.

A later change adds a cell, a configuration, a mix or a metric by adding
files and entries, without editing a file that is already here.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict  # configs/<config>.json
    mix: dict  # traffic/<mix>.json
    end_to_end: list  # BENCHMARK.json entries reported with --trace 0
    per_layer: list  # ... with --trace 1
    readers: dict = field(default_factory=dict)  # metric name -> metrics/<name>.json
    limits: dict = field(default_factory=dict)  # checks/<cell>.json
    data: Path = HERE  # the folder the cell's files were read from


def _read(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def in_cell(metric: dict, cell: str) -> bool:
    """Whether a metric entry is reported in ``cell``."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json",
              data: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench_file``, with its files under ``data``."""
    bench = _read(bench_file)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_file} (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read(bench_file.parent / configs[w["config"]]["file"])
    e2e = [m for m in bench["end_to_end"] if in_cell(m, name)]
    per_layer = [m for m in bench["per_layer"] if in_cell(m, name)]
    readers = {m["name"]: _read(data / "metrics" / f"{m['name']}.json") for m in e2e + per_layer}
    limits = _read(data / "checks" / f"{name}.json")
    return Cell(name, w["config"], w["traffic"], w["chips"], config,
                _read(data / "traffic" / f"{w['traffic']}.json"), e2e, per_layer, readers, limits,
                data)


def load_module(path: Path):
    """Import a reader or a kind by its path."""
    spec = importlib.util.spec_from_file_location(f"benchmark_{path.parent.name}_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find(data: Path, folder: str, name: str) -> Path:
    """``<folder>/<name>.py`` under ``data`` where it is there, else here."""
    path = data / folder / f"{name}.py"
    return path if path.exists() else HERE / folder / f"{name}.py"


def load_kind(kind: str, data: Path = HERE):
    """The module that runs a traffic mix of ``kind`` (``kinds/<kind>.py``,
    looked for under ``data`` first, then here)."""
    return load_module(find(data, "kinds", kind))


def read_metric(reader: dict, obs: dict, data: Path = HERE):
    """The metric's value from the run's observations, or None where its
    reader finds nothing to read.  The reader's file is looked for under
    ``data`` first, then here."""
    return load_module(find(data, "readers", reader["reader"])).read(obs, **reader.get("args", {}))
