"""Tests of the benchmark: run from the repository's root with

    python -m pytest benchmark/tests -q

The tests that need a CUDA card carry the ``cuda`` marker and skip without
one (decided inside the test).  The rest run the harness on the CPU at a
small size: ``tiny_bench`` copies the benchmark's data files into a
temporary folder with every frame cut to 64x96 and the traced segments to a
second, so that a cell runs in seconds.
"""

import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import spec

TINY_HW = [64, 96]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def make_tiny(root: Path, hw=TINY_HW) -> Path:
    """The benchmark's files under ``root`` at a small frame size; returns
    the path of its BENCHMARK.json."""
    for d in ("configs", "traffic", "metrics", "checks"):
        shutil.copytree(spec.HERE / d, root / d)
    for f in (root / "traffic").glob("*.json"):
        mix = json.loads(f.read_text())
        mix.update(hw=list(hw), trace_seconds=0.5)
        mix.update({k: 4 for k in ("pool", "warmup") if k in mix})
        mix.update({k: 12 for k in ("scenes",) if k in mix})
        f.write_text(json.dumps(mix))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        c["file"] = str(root / "configs" / Path(c["file"]).name)
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.fixture
def tiny_bench(tmp_path):
    path = make_tiny(tmp_path)
    return lambda cell: spec.load_cell(cell, path, tmp_path)
