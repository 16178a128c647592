"""Boundaries of the PyTorch port: no jax, the smoke's config, the CPU path.

* Every module of ``gdb_nerf_tpu_torch`` imports (in a fresh interpreter),
  and the port's CLI loader runs on the CPU, without pulling jax, flax or
  the JAX package (``gdb_nerf_tpu``) into ``sys.modules``; no source of the
  port names either in an import.
* ``chip_smoke.py`` imports neither jax nor the JAX package: its dtu_eval
  config literal equals ``load_cfg("configs/dtu_eval.yaml")`` in every
  section the network reads, and its synthetic requests equal the
  synthetic loader, bit for bit: the JAX package's and the port's own.
* The kernel wrapper takes the plain path for CPU tensors, leaving its
  launch counter at 0, and never falls back for tensors off the CPU.
* The A/B tools (``tools/ab_bundle_head.py`` for K1,
  ``tools/ab_probe_kernels.py`` for K2-K4 and K5b) stop without a GPU and
  import an earlier tree's wrappers beside this one's.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from gdb_nerf_tpu.config import load_cfg
from gdb_nerf_tpu.datasets import make_data_loader
from gdb_nerf_tpu_torch.kernels.bundle_head import bundle_head_reference
from gdb_nerf_tpu_torch.models.nerf_head import BundleNeRF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


FORBIDDEN = ("jax", "jaxlib", "flax", "gdb_nerf_tpu")


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gdb_nerf_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'gdb_nerf_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "from gdb_nerf_tpu_torch.config import load_cfg\n"
        "from gdb_nerf_tpu_torch.datasets import make_data_loader\n"
        "cfg = load_cfg('configs/dtu_eval.yaml', ['synthetic', 'True', 'synthetic_hw', "
        "'[16, 24]', 'train.num_workers', '0'])\n"
        "batches = list(make_data_loader(cfg, is_train=False))\n"
        "assert len(batches) == 8, len(batches)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30  # every module of the port was imported


def _imported_names(path: str) -> list[str]:
    import ast

    tree = ast.parse(open(path).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    return names


def test_port_sources_import_nothing_of_the_jax_package():
    """Every import of every source of the port, at any depth (inside
    functions too), and every importlib target of its dataset registry."""
    from gdb_nerf_tpu_torch.datasets import loader

    root = os.path.join(REPO, "gdb_nerf_tpu_torch")
    paths = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".py")]
    assert len(paths) >= 30
    for path in paths:
        bad = [n for n in _imported_names(path) if n.split(".")[0] in FORBIDDEN]
        assert not bad, (path, bad)
    for target in loader._DATASETS.values():
        assert target.startswith("gdb_nerf_tpu_torch."), target


def _as_dict(ns):
    return {k: _as_dict(v) if isinstance(v, SimpleNamespace) else v for k, v in vars(ns).items()}


def test_smoke_config_literal_equals_yaml():
    cfg = _as_dict(load_cfg(os.path.join(REPO, "configs", "dtu_eval.yaml")))
    # Every section Network.from_config reads, each whole.
    assert set(chip_smoke.DTU_EVAL) == {"network_module", "compute_dtype", "fpn", "mvs", "nerf"}
    for key, value in chip_smoke.DTU_EVAL.items():
        assert cfg[key] == value, key
    assert _as_dict(chip_smoke.namespace(chip_smoke.DTU_EVAL)) == chip_smoke.DTU_EVAL


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


def test_smoke_imports_neither_jax_nor_the_jax_package():
    bad = [n for n in _imported_names(os.path.join(REPO, "chip_smoke.py"))
           if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    # What the smoke runs off the card: its config, its requests, the network.
    code = (
        "import sys, chip_smoke\n"
        "from gdb_nerf_tpu_torch.runtime.registry import make_network\n"
        "net = make_network(chip_smoke.namespace(chip_smoke.DTU_EVAL))\n"
        "req = chip_smoke.synthetic_requests(2, (16, 20))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'gdb_nerf_tpu'))\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


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
    sigma, feat = head(vox, payload, frd)
    s_ref, f_ref = bundle_head_reference(head, vox, payload, frd)
    assert torch.equal(sigma, s_ref) and torch.equal(feat, f_ref)
    assert head.kernel.launches == 0
    # Off the CPU there is no plain fallback: the wrapper launches or raises.
    with pytest.raises(ValueError, match="CUDA"):
        head(vox.to("meta"), payload.to("meta"), frd.to("meta"))
    assert head.kernel.launches == 0


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
