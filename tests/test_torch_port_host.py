"""The port's own host layer against the JAX package's.

``gdb_nerf_tpu_torch.config`` and ``gdb_nerf_tpu_torch.datasets`` are copies
of the JAX package's modules of the same names; these tests hold them equal:
``load_cfg`` on every config (the eval configs, ``dtu_pretrain`` and the
21 per-scene fine-tune configs), the synthetic loader's batches bit for
bit, and the DTU, LLFF and NeRF readers' items on miniature on-disk trees of
the kind ``tests/test_reader_fixtures.py`` builds.  Both packages' readers
run with their native decoders switched off, so both sides decode with cv2
(``tests/test_torch_port_native.py`` holds the port's decoder to cv2 and to
the JAX package's).
"""

import json
import os
from types import SimpleNamespace

import cv2
import numpy as np
import pytest

import gdb_nerf_tpu.datasets.imageio as jax_imageio
from gdb_nerf_tpu.config import load_cfg as jax_load_cfg
from gdb_nerf_tpu.datasets import make_data_loader as jax_make_data_loader
from gdb_nerf_tpu.datasets.dtu import Dataset as JaxDTU
from gdb_nerf_tpu.datasets.llff import Dataset as JaxLLFF
from gdb_nerf_tpu.datasets.nerf import Dataset as JaxNeRF
from gdb_nerf_tpu.utils.io import write_pfm
from gdb_nerf_tpu_torch.config import load_cfg
from gdb_nerf_tpu_torch.datasets import imageio, loader
from gdb_nerf_tpu_torch.datasets import make_data_loader
from gdb_nerf_tpu_torch.datasets.dtu import Dataset as DTU
from gdb_nerf_tpu_torch.datasets.llff import Dataset as LLFF
from gdb_nerf_tpu_torch.datasets.nerf import Dataset as NeRF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _as_dict(ns):
    return {k: _as_dict(v) if isinstance(v, SimpleNamespace) else v for k, v in vars(ns).items()}


def assert_same(a, b, path="item"):
    """Equal structure, types, dtypes, shapes and values, bit for bit."""
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


# The eval configs, their parent, and every per-scene fine-tune config.
CONFIG_NAMES = ["dtu_eval", "llff_eval", "nerf_eval", "dtu_pretrain"] + sorted(
    f"{family}/{f[:-5]}" for family in ("dtu", "llff", "nerf")
    for f in os.listdir(os.path.join(REPO, "configs", family)) if f.endswith(".yaml"))


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_load_cfg_equals_the_jax_package(name):
    path = os.path.join(REPO, "configs", f"{name}.yaml")
    opts = ["synthetic", "True", "test.eval_depth", "True"]
    assert _as_dict(load_cfg(path, opts)) == _as_dict(jax_load_cfg(path, opts))


def test_synthetic_loader_equals_the_jax_package():
    opts = ["synthetic", "True", "synthetic_hw", "[24, 40]", "train.num_workers", "0"]
    cfg_file = os.path.join(REPO, "configs", "dtu_eval.yaml")
    ours = list(make_data_loader(load_cfg(cfg_file, opts), is_train=False))
    theirs = list(jax_make_data_loader(jax_load_cfg(cfg_file, opts), is_train=False))
    assert len(ours) == len(theirs) == 8
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert_same(a, b, f"batch{i}")


def test_loader_registry_resolves_to_the_port():
    for key in ("datasets.dataloader.dtu", "datasets.dataloader.llff",
                "datasets.dataloader.nerf", "datasets.synthetic"):
        assert loader.resolve_dataset(key).__module__.startswith("gdb_nerf_tpu_torch.datasets."), key


def _cfg(workspace):
    return SimpleNamespace(
        workspace=str(workspace), fix_random=True,
        nerf=SimpleNamespace(global_num_depth=64),
        mvs=SimpleNamespace(vol_scales=[0.125, 0.5]),
        train=SimpleNamespace(sampler_meta=SimpleNamespace(input_views_num=[2, 3, 4])),
        test=SimpleNamespace(sampler_meta=SimpleNamespace(input_views_num=[3])),
    )


def _lookat_ext(angle, radius=4.0):
    c, s = np.cos(angle), np.sin(angle)
    E = np.eye(4)
    E[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    E[:3, 3] = [0.3 * s, 0.0, radius]
    return E


def _textured(h, w, channels, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, channels), dtype=np.uint8)


def _dtu_tree(tmp_path):
    root, scene = tmp_path / "dtu", "scan1"
    (root / "Cameras" / "train").mkdir(parents=True)
    (root / "Depths" / scene).mkdir(parents=True)
    (root / f"Rectified/{scene}_train").mkdir(parents=True)
    K4 = np.array([[361.54, 0, 82.9], [0, 360.39, 66.4], [0, 0, 1]])
    for i in range(49):
        lines = ["extrinsic"] + [" ".join(f"{x:.6f}" for x in r) for r in _lookat_ext(0.02 * i, 600.0)]
        lines += ["", "intrinsic"] + [" ".join(f"{x:.6f}" for x in r) for r in K4]
        lines += ["", "425.0 2.5"]
        (root / "Cameras/train" / f"{i:08d}_cam.txt").write_text("\n".join(lines) + "\n")
    ann = tmp_path / "scenes.txt"
    ann.write_text(f"{scene}\n")

    def materialize(v):
        cv2.imwrite(str(root / f"Rectified/{scene}_train/rect_{v + 1:03d}_3_r5000.png"),
                    _textured(512, 640, 3, v))
        write_pfm(str(root / f"Depths/{scene}/depth_map_{v:04d}.pfm"),
                  np.random.default_rng(100 + v).uniform(400, 900, (1200, 1600)).astype(np.float32))

    return {"data_root": "dtu", "split": "test", "ann_file": str(ann), "scene": scene}, materialize


def _llff_tree(tmp_path):
    scene, root, n = "fern", tmp_path / "llff", 20
    (root / scene / "images_4").mkdir(parents=True)
    poses = np.zeros((n, 3, 5))
    for i in range(n):
        c2w = np.linalg.inv(_lookat_ext(0.05 * i))
        poses[i, :3, 0], poses[i, :3, 1] = c2w[:3, 1], c2w[:3, 0]
        poses[i, :3, 2], poses[i, :3, 3] = -c2w[:3, 2], c2w[:3, 3]
        poses[i, :, 4] = [32 / 0.25, 48 / 0.25, 60.0 / 0.25]
        cv2.imwrite(str(root / scene / "images_4" / f"image{i:03d}.png"), _textured(32, 48, 3, i))
    bounds = np.tile([2.0, 6.0], (n, 1))
    bounds[0] = [1.5, 5.0]
    np.save(root / scene / "poses_bounds.npy", np.concatenate([poses.reshape(n, 15), bounds], 1))
    return {"data_root": "llff", "split": "test", "input_h_w": [64, 96], "scene": scene}, None


def _nerf_tree(tmp_path):
    scene, root = "lego", tmp_path / "nerf"
    (root / scene / "train").mkdir(parents=True)
    b2c = np.diag([1.0, -1.0, -1.0, 1.0])
    frames = [{"transform_matrix": (np.linalg.inv(_lookat_ext(0.04 * i)) @ b2c).tolist()}
              for i in range(71)]
    meta = {"camera_angle_x": 0.6911112070083618, "frames": frames}
    (root / scene / "transforms_train.json").write_text(json.dumps(meta))

    def materialize(v):  # RGBA, so that the white-background blend shows
        cv2.imwrite(str(root / scene / "train" / f"r_{v}.png"), _textured(800, 800, 4, v))

    return {"data_root": "nerf", "split": "test", "scene": scene}, materialize


@pytest.mark.parametrize("reader", ["dtu", "llff", "nerf"])
def test_readers_equal_the_jax_package(reader, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_imageio.native, "available", lambda: False)
    monkeypatch.setattr(imageio.native, "available", lambda: False)
    tree, ours, theirs = {"dtu": (_dtu_tree, DTU, JaxDTU), "llff": (_llff_tree, LLFF, JaxLLFF),
                          "nerf": (_nerf_tree, NeRF, JaxNeRF)}[reader]
    kwargs, materialize = tree(tmp_path)
    cfg = _cfg(tmp_path)
    a, b = ours(cfg, **kwargs), theirs(cfg, **kwargs)
    assert a.metas == b.metas and len(a) == len(b) == 4
    if materialize is not None:  # the images the first two items read
        for _, tar, src in a.metas[:2]:
            for v in set(src + [tar]):
                materialize(v)
    for spec in ((0, 3, 1.0), (1, 3, 0.5)):
        assert_same(a[spec], b[spec], f"{reader}{spec}")
