"""The run's guards: no JAX module by the end of a run, no result without a
card, none in a folder that holds only the benchmark, and a reference that
imports nothing of the measured program."""

import ast
import json
import os
import shutil
import subprocess
import sys
import types

from benchmark import run, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "gdb_nerf_tpu", "gdb_nerf_tpu_torch"}


def test_loaded_jax_compares_whole_top_level_names(monkeypatch):
    import gdb_nerf_tpu_torch  # noqa: F401  (begins with the JAX package's name)

    for name in ("jax", "jaxlib", "flax", "gdb_nerf_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "gdb_nerf_tpu_toolkit", types.ModuleType("x"))
    assert run.loaded_jax() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "gdb_nerf_tpu.models", types.ModuleType("m"))
    assert run.loaded_jax() == ["gdb_nerf_tpu", "jax"]


def test_no_result_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "dtu_eval.hd_stream", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_no_result_in_a_folder_of_the_benchmark_alone(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    cmd = json.loads((spec.ROOT / "BENCHMARK.json").read_text())["command"]
    proc = subprocess.run([sys.executable, *cmd[1:], "--workload", "dtu_eval.hd_stream", "--seed",
                           str(2**31 + 5), "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path.name, n)
    code = ("import sys, pkgutil, importlib, benchmark.reference as r\n"
            "for m in pkgutil.iter_modules(r.__path__):\n"
            "    importlib.import_module('benchmark.reference.' + m.name)\n"
            f"print(sorted({{m.split('.')[0] for m in sys.modules}} & {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"
