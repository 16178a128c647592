"""Boundaries of the PyTorch port: no jax, the smoke's config, the CPU path.

* Every module of ``gdb_nerf_tpu_torch`` imports (in a fresh interpreter),
  the training CLI ``train_net``, ``train/*`` (``train/mixed`` too),
  ``eval/*`` (``eval/lpips`` too), ``parallel/*``, ``utils/img``,
  ``utils/checkpoint``, ``datasets/native`` and the tools that measure the
  model (``tools/bf16_gate``, ``tools/measure_fill``, ``tools/measure_lod``,
  ``tools/measure_train_step``, ``tools/profile_forward``,
  ``tools/profile_encode``, ``tools/microbench``, ``tools/roofline``,
  ``tools/verify_scene``, ``tools/microbench_loader``, ``tools/measure_frame``) among them,
  and the port's CLI loader and
  one train step run on the CPU, without pulling jax, flax or the JAX
  package (``gdb_nerf_tpu``) into ``sys.modules``; no source of the port
  names either in an import, or a path into the JAX package's ``native``
  folder.
* ``chip_smoke.py`` imports neither jax nor the JAX package: its dtu_eval
  config literal equals ``load_cfg("configs/dtu_eval.yaml")`` in every
  section the network reads, its dtu_pretrain literal equals
  ``load_cfg("configs/dtu_pretrain.yaml")`` in every section the trainer
  reads, and its synthetic requests equal the synthetic loader, bit for
  bit: the JAX package's and the port's own.
* The kernel wrapper takes the plain path for CPU tensors, leaving its
  launch counter at 0, and never falls back for tensors off the CPU.
* The A/B tools (``tools/ab_bundle_head.py`` for K1,
  ``tools/ab_probe_kernels.py`` for K2-K4 and K5b) stop without a GPU and
  import an earlier tree's wrappers beside this one's.
"""

import os
import re
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from gdb_nerf_tpu.config import load_cfg
from gdb_nerf_tpu.datasets import make_data_loader
from gdb_nerf_tpu_torch.kernels.bundle_head import LAUNCHES, bundle_head_reference
from gdb_nerf_tpu_torch.models.nerf_head import BundleNeRF
from gdb_nerf_tpu_torch.runtime import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


FORBIDDEN = ("jax", "jaxlib", "flax", "gdb_nerf_tpu")


# One fresh interpreter runs both checks that need one, each in its own
# try block: first what the smoke runs off the card (its config, its
# requests, the network), then every module of the port, the CLI's loader
# and one train step.  After each it lists the forbidden modules that came
# into ``sys.modules`` during it.
_FRESH = (
    "import json, sys, traceback\n"
    "def forbidden(before):\n"
    f"    return sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r} "
    "and k not in before)\n"
    "report = {}\n"
    "try:\n"
    "    import chip_smoke\n"
    "    from gdb_nerf_tpu_torch.runtime.registry import make_network\n"
    "    net = make_network(chip_smoke.namespace(chip_smoke.DTU_EVAL))\n"
    "    req = chip_smoke.synthetic_requests(2, (16, 20))\n"
    "    report['smoke'] = {'bad': forbidden(())}\n"
    "except Exception:\n"
    "    report['smoke'] = {'error': traceback.format_exc()}\n"
    "before = set(sys.modules)\n"
    "try:\n"
    "    import importlib, pkgutil\n"
    "    import gdb_nerf_tpu_torch as p\n"
    "    mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'gdb_nerf_tpu_torch.')]\n"
    "    for m in mods: importlib.import_module(m)\n"
    "    from gdb_nerf_tpu_torch.config import load_cfg\n"
    "    from gdb_nerf_tpu_torch.datasets import make_data_loader\n"
    "    cfg = load_cfg('configs/dtu_eval.yaml', ['synthetic', 'True', 'synthetic_hw', "
    "'[16, 24]', 'train.num_workers', '0'])\n"
    "    batches = list(make_data_loader(cfg, is_train=False))\n"
    "    assert len(batches) == 8, len(batches)\n"
    "    import torch\n"
    "    from gdb_nerf_tpu_torch.runtime.registry import make_network\n"
    "    from gdb_nerf_tpu_torch.train.trainer import Trainer\n"
    "    cfg = load_cfg('configs/dtu_pretrain.yaml', ['synthetic', 'True', 'synthetic_hw', "
    "'[64, 64]', 'train.num_workers', '0', 'train.batch_size', '1', 'mvs.num_depth', "
    "'[16, 8]'])\n"
    "    batch = next(iter(make_data_loader(cfg, is_train=True, max_iter=1)))\n"
    "    assert torch.isfinite(torch.tensor(Trainer(cfg, make_network(cfg, torch.float32), 'cpu')"
    ".train_step(batch)['loss']))\n"
    "    report['port'] = {'modules': mods, 'bad': forbidden(before)}\n"
    "except Exception:\n"
    "    report['port'] = {'error': traceback.format_exc()}\n"
    "print(json.dumps(report))\n"
)


@pytest.fixture(scope="module")
def fresh_interpreter() -> dict:
    out = subprocess.run([sys.executable, "-c", _FRESH], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    import json

    return json.loads(out.stdout.splitlines()[-1])


def test_port_imports_no_jax(fresh_interpreter):
    report = fresh_interpreter["port"]
    assert "error" not in report, report.get("error")
    want = {"gdb_nerf_tpu_torch." + m for m in (
        "train_net", "train.losses", "train.optim", "train.recorder", "train.step",
        "train.trainer", "eval.metrics", "eval.evaluator", "eval.lpips", "utils.img",
        "utils.checkpoint", "parallel", "parallel.hosts", "parallel.collectives", "parallel.infer",
        "tools.bf16_gate", "tools.measure_common", "tools.measure_fill", "tools.measure_lod",
        "train.mixed", "tools.measure_train_step", "datasets.native", "tools.profile_forward",
        "tools.profile_encode", "tools.microbench", "tools.roofline", "tools.verify_scene",
        "tools.microbench_loader", "tools.measure_frame")}
    assert want <= set(report["modules"]), want - set(report["modules"])
    assert not report["bad"], report["bad"]
    assert len(report["modules"]) >= 81  # every module of the port was imported


def _imported_names(path: str) -> list[str]:
    import ast

    tree = ast.parse(open(path).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    return names


# A path into the JAX package's native library folder (``native/``, or a
# "native" path component, or its library by name) in a source of the port.
_NATIVE_PATH = re.compile(r"""(?<![\w./-])native/|["']native["']|libgdbn_io\.so""")


def test_port_sources_import_nothing_of_the_jax_package():
    """Every import of every source of the port, at any depth (inside
    functions too), and every importlib target of its dataset registry; no
    source of the port (Python, CUDA or C++) names a path into the JAX
    package's native library folder: the port builds its own decoder."""
    from gdb_nerf_tpu_torch.datasets import loader

    root = os.path.join(REPO, "gdb_nerf_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs]
    paths = [p for p in files if p.endswith(".py")]
    assert len(paths) >= 30
    for path in paths:
        bad = [n for n in _imported_names(path) if n.split(".")[0] in FORBIDDEN]
        assert not bad, (path, bad)
    sources = [p for p in files if p.endswith((".py", ".cu", ".cpp"))]
    assert os.path.join(root, "csrc", "gdbn_io.cpp") in sources
    for path in sources:
        found = _NATIVE_PATH.findall(open(path, encoding="utf-8").read())
        assert not found, (path, found)
    assert _NATIVE_PATH.search('os.path.join(repo, "native", "libgdbn_io.so")')
    assert _NATIVE_PATH.search("see native/build.sh")
    assert not _NATIVE_PATH.search("build/gdbn_io/ datasets/native.py")
    for target in loader._DATASETS.values():
        assert target.startswith("gdb_nerf_tpu_torch."), target


def _as_dict(ns):
    return {k: _as_dict(v) if isinstance(v, SimpleNamespace) else v for k, v in vars(ns).items()}


def test_smoke_config_literal_equals_yaml():
    """The dtu_eval literal, and phase 8's llff_eval and nerf_eval literals
    with each config's protocol size (the measure tools' own)."""
    from gdb_nerf_tpu_torch.tools.measure_common import PROTOCOL_HW

    assert set(chip_smoke.EVAL_CONFIGS) == set(PROTOCOL_HW)
    assert chip_smoke.EVAL_CONFIGS["dtu_eval"][0] is chip_smoke.DTU_EVAL
    for name, (literal, hw) in chip_smoke.EVAL_CONFIGS.items():
        cfg = _as_dict(load_cfg(os.path.join(REPO, "configs", f"{name}.yaml")))
        # Every section Network.from_config reads, each whole.
        assert set(literal) == {"network_module", "compute_dtype", "fpn", "mvs", "nerf"}
        for key, value in literal.items():
            assert cfg[key] == value, (name, key)
        assert _as_dict(chip_smoke.namespace(literal)) == literal
        assert hw == PROTOCOL_HW[name], name


def test_smoke_pretrain_literal_equals_yaml():
    """Both packages' load_cfg of dtu_pretrain.yaml, each section whole."""
    from gdb_nerf_tpu_torch.config import load_cfg as port_load_cfg

    path = os.path.join(REPO, "configs", "dtu_pretrain.yaml")
    for cfg in (_as_dict(load_cfg(path)), _as_dict(port_load_cfg(path))):
        for key, value in chip_smoke.DTU_PRETRAIN.items():
            assert cfg[key] == value, key
    cfg = chip_smoke.train_cfg((64, 64), 2, 3)
    assert (cfg.train.batch_size, cfg.ep_iter, cfg.synthetic_hw) == (2, 3, [64, 64])
    assert cfg.nerf.max_num_samples == 6 and not cfg.nerf.is_adaptive


def test_smoke_gate_configs_equal_the_gate_tools():
    """Phase 8's training and eval configs against tools/bf16_gate.py's
    (the port's load_cfg of dtu_pretrain.yaml and dtu_eval.yaml with the
    tool's overrides), in every section that the trainer, the network and
    the loader read."""
    from gdb_nerf_tpu_torch.tools import bf16_gate

    net = ("compute_dtype", "fpn", "mvs", "nerf", "synthetic", "synthetic_hw")
    pairs = ((chip_smoke.gate_train_cfg(), bf16_gate.recipe_cfg(), net + ("train", "ep_iter")),
             (chip_smoke.eval_cfg("dtu_eval"), bf16_gate.gate_eval_cfg(), net + ("test",)))
    for smoke, tool, keys in pairs:
        smoke, tool = _as_dict(smoke), _as_dict(tool)
        for key in keys:
            assert smoke[key] == tool[key], key


def test_smoke_requests_equal_the_synthetic_loader():
    hw = (48, 80)
    cfg = load_cfg(os.path.join(REPO, "configs", "dtu_eval.yaml"),
                   ["synthetic", "True", "synthetic_hw", str(list(hw)), "train.num_workers", "0"])
    loader = make_data_loader(cfg, is_train=False)
    ours = chip_smoke.synthetic_requests(len(loader), hw)
    assert len(ours) == len(loader) == 8
    for mine, batch in zip(ours, loader):
        for path in (("src_views", "rgb"), ("src_views", "extrinsics"), ("src_views", "intrinsics"),
                     ("tar_views", "extrinsics"), ("tar_views", "intrinsics"), ("near_far",)):
            a, b = mine, batch
            for k in path:
                a, b = a[k], b[k]
            assert a.dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_smoke_imports_neither_jax_nor_the_jax_package(fresh_interpreter):
    bad = [n for n in _imported_names(os.path.join(REPO, "chip_smoke.py"))
           if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    # What the smoke runs off the card: its config, its requests, the network.
    report = fresh_interpreter["smoke"]
    assert "error" not in report, report.get("error")
    assert not report["bad"], report["bad"]


def test_smoke_literal_and_requests_equal_the_ports_host_layer():
    from gdb_nerf_tpu_torch.config import load_cfg as port_load_cfg
    from gdb_nerf_tpu_torch.datasets import make_data_loader as port_loader

    cfg_file = os.path.join(REPO, "configs", "dtu_eval.yaml")
    cfg = _as_dict(port_load_cfg(cfg_file))
    for key, value in chip_smoke.DTU_EVAL.items():
        assert cfg[key] == value, key
    hw = (40, 56)
    cfg = port_load_cfg(cfg_file, ["synthetic", "True", "synthetic_hw", str(list(hw)),
                                   "train.num_workers", "0"])
    batches = list(port_loader(cfg, is_train=False))
    ours = chip_smoke.synthetic_requests(len(batches), hw)
    for mine, batch in zip(ours, batches):
        for path in (("src_views", "rgb"), ("src_views", "extrinsics"), ("src_views", "intrinsics"),
                     ("tar_views", "extrinsics"), ("tar_views", "intrinsics"), ("near_far",)):
            a, b = mine, batch
            for k in path:
                a, b = a[k], b[k]
            assert a.dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_array_equal(a, b, err_msg=str(path))


@torch.no_grad()
def test_wrapper_takes_plain_path_on_cpu_only(rng):
    head = BundleNeRF(64, 16, 8).eval()
    vox = torch.from_numpy(rng.standard_normal((300, 8)).astype(np.float32))
    payload = torch.from_numpy(rng.uniform(0, 1, (3, 300, 31)).astype(np.float32))
    frd = torch.from_numpy(rng.standard_normal((3, 300, 23)).astype(np.float32))
    with tracing.recording() as rec:
        sigma, feat = head(vox, payload, frd)
    s_ref, f_ref = bundle_head_reference(head, vox, payload, frd)
    assert torch.equal(sigma, s_ref) and torch.equal(feat, f_ref)
    assert rec.counter(LAUNCHES) == 0
    # Off the CPU there is no plain fallback: the wrapper launches or raises.
    with tracing.recording() as rec, pytest.raises(ValueError, match="CUDA"):
        head(vox.to("meta"), payload.to("meta"), frd.to("meta"))
    assert rec.counter(LAUNCHES) == 0


def test_ab_bundle_head_needs_a_gpu_and_imports_the_earlier_tree(tmp_path, monkeypatch):
    """The K1 A/B tool stops without a GPU; its turns give each version two
    places, one early and one late; and the earlier tree's bundle_head,
    imported beside this one, keeps its own source and build directory and
    runs its plain version on CPU tensors."""
    import shutil

    from gdb_nerf_tpu_torch.kernels import bundle_head
    from gdb_nerf_tpu_torch.tools import ab_bundle_head
    from gdb_nerf_tpu_torch.tools.ab_common import import_from_tree

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        ab_bundle_head.main([REPO])
    assert exc.value.code not in (None, 0)
    order = ab_bundle_head.ORDER
    assert order == order[::-1] and sorted(order) == sorted(2 * ("plain", "earlier", "this"))
    assert ab_bundle_head.F32_TOL == chip_smoke.F32_ATOL == chip_smoke.F32_RTOL
    assert ab_bundle_head.BF16_ATOL == chip_smoke.BF16_ATOL
    package = bundle_head.SOURCE.parents[1]
    shutil.copytree(package, tmp_path / package.name,
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    before = dict(sys.modules)
    earlier = import_from_tree(tmp_path, "kernels.bundle_head")
    assert earlier is not bundle_head and sys.modules == before
    assert earlier.SOURCE == tmp_path / package.name / "csrc" / "bundle_head.cu"
    assert earlier.build_library.__globals__["BUILD_DIR"] == tmp_path / "build" / "kernels"
    heads = ab_bundle_head.heads(torch.device("cpu"))
    assert heads[torch.bfloat16].sigma[0].weight.dtype == torch.float32
    assert heads[torch.bfloat16].lr0[0].weight.dtype == torch.bfloat16
    rng = np.random.default_rng(0)
    args = (torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32)),
            torch.from_numpy(rng.uniform(0, 1, (3, 50, 31)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((3, 50, 23)).astype(np.float32)))
    head = heads[torch.float32]
    for got, want in zip(earlier.BundleHeadKernel()(head, *args), bundle_head_reference(head, *args)):
        assert torch.equal(got, want)


def test_ab_probe_kernels_needs_a_gpu_and_imports_the_earlier_tree(tmp_path, monkeypatch):
    """The K2-K4/K5b A/B tool stops without a GPU; its turns give each version
    two places, one early and one late; its chain tolerances are the
    smoke's; its cases are the probes' bench sizes with their bounds; and
    the earlier tree's plane_conv and gather, imported beside this one,
    keep their own sources and run their plain versions on CPU tensors."""
    import shutil

    from gdb_nerf_tpu_torch.kernels import gather, plane_conv
    from gdb_nerf_tpu_torch.tools import ab_probe_kernels
    from gdb_nerf_tpu_torch.tools.ab_common import import_from_tree

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        ab_probe_kernels.main([REPO])
    assert exc.value.code not in (None, 0)
    order = ab_probe_kernels.ORDER
    assert order == order[::-1]
    assert sorted(order) == sorted(2 * ("plain", "library", "earlier", "this"))
    assert (ab_probe_kernels.CONV_F32_ATOL, ab_probe_kernels.CONV_F32_RTOL) == \
        (chip_smoke.CONV_F32_ATOL, chip_smoke.CONV_F32_RTOL)
    cases = ab_probe_kernels.cases(torch.device("cpu"))
    convs = ("convchain",) * 4 + ("conv1",) * 2 + ("fpnprim",) * 2
    assert [(c.kernel, c.lib, c.exact) for c in cases] == [
        *((k, "plane_conv", False) for k in convs), ("take_along", "gather", True)]
    assert [c.args[0].dtype for c in cases] == [torch.float32, torch.bfloat16] * 4 + [torch.bfloat16]
    assert [c.bound[1] for c in cases] == ["operations"] + ["bytes"] * 8
    assert [c.args[1].shape[0] for c in cases[:4]] == [4, 4, 1, 1]  # the chain of 4, then n = 1
    assert round(cases[-1].bound[0], 4) == 0.0113
    package = plane_conv.SOURCE.parents[1]
    shutil.copytree(package, tmp_path / package.name,
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    before = dict(sys.modules)
    earlier_conv = import_from_tree(tmp_path, "kernels.plane_conv")
    earlier_gather = import_from_tree(tmp_path, "kernels.gather")
    assert sys.modules == before
    assert earlier_conv is not plane_conv and earlier_gather is not gather
    assert earlier_conv.SOURCE == tmp_path / package.name / "csrc" / "plane_conv.cu"
    assert earlier_gather.SOURCE == tmp_path / package.name / "csrc" / "gather.cu"
    small = ab_probe_kernels.microbench_conv.inputs("convchain", 3, 9, 11, torch.float32, "cpu", n=2)
    assert torch.equal(earlier_conv.PlaneConvKernels().convchain(*small),
                       plane_conv.convchain_reference(*small))
    table, idx = cases[-1].args
    assert torch.equal(earlier_gather.GatherKernels().take_along(table[:50], idx[:300] % 50),
                       gather.take_along_reference(table[:50], idx[:300] % 50))
