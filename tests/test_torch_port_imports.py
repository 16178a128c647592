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
