"""The port's native image decoder (``gdb_nerf_tpu_torch/datasets/native.py``
over ``csrc/gdbn_io.cpp``) against cv2, the JAX package's binding and the
port's own Python readers, on the CPU.

The library is built into a temporary directory, never the JAX package's
``native`` folder.  Where a prerequisite of the build is missing (g++,
png.h, jpeglib.h, zlib.h) each test skips inside itself with the reason;
where they are present a failed build fails the tests.  The cases of
``tests/test_native_io.py`` run at its tolerances; the JAX binding's output
on the same files is compared where that library is built.
"""

import os
from pathlib import Path

import cv2
import numpy as np
import pytest

from gdb_nerf_tpu.datasets import native as jax_native
from gdb_nerf_tpu.utils.io import write_pfm
from gdb_nerf_tpu_torch.datasets import imageio, native
from gdb_nerf_tpu_torch.utils.io import read_pfm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The port's library built once into a temporary directory and bound:
    (its path, the loaded library); None where a prerequisite is missing."""
    if native.unavailable_reason() is not None:
        return None
    build_dir = tmp_path_factory.mktemp("build")
    loaded = native.load(build_dir)
    files = list(build_dir.iterdir())
    assert len(files) == 1 and files[0].suffix == ".so"
    return files[0], loaded


@pytest.fixture
def lib(built, monkeypatch):
    """The library of ``built`` as the one ``native``'s functions call."""
    if built is None:
        pytest.skip(f"the native decoder cannot be built here: {native.unavailable_reason()}")
    monkeypatch.setattr(native, "_LIB", built[1])
    return built[0]


def write_rgb(path, img):
    cv2.imwrite(str(path), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    return str(path)


def against_jax(path, *args, **kwargs):
    """The JAX binding's decode of ``path``, or None where it is not built."""
    return jax_native.decode_image(path, *args, **kwargs) if jax_native.available() else None


def test_decode_matches_cv2_and_the_jax_binding(lib, rng, tmp_path):
    img = rng.uniform(0, 255, (40, 56, 3)).astype(np.uint8)
    path = write_rgb(tmp_path / "t.png", img)
    out = native.decode_image(path)
    assert out.shape == (40, 56, 3) and out.dtype == np.float32
    np.testing.assert_allclose(out, img.astype(np.float32) / 255.0, atol=1e-6)
    assert native.image_size(path) == (40, 56)
    theirs = against_jax(path)
    if theirs is not None:
        np.testing.assert_allclose(out, theirs, atol=1e-6)


def test_decode_resize_matches_cv2_linear(lib, rng, tmp_path):
    img = rng.uniform(0, 255, (40, 56, 3)).astype(np.uint8)
    path = write_rgb(tmp_path / "t.png", img)
    out = native.decode_image(path, (20, 28))
    ref = cv2.resize(img.astype(np.float32) / 255.0, (28, 20), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(out, ref, atol=2e-3)
    theirs = against_jax(path, (20, 28))
    if theirs is not None:
        np.testing.assert_allclose(out, theirs, atol=1e-6)


def test_decode_rgba_white_background(lib, rng, tmp_path):
    rgba = rng.uniform(0, 255, (16, 16, 4)).astype(np.uint8)
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, cv2.cvtColor(rgba, cv2.COLOR_RGBA2BGRA))
    out = native.decode_image(path, white_bg=True)
    a = rgba[..., 3:].astype(np.float32) / 255.0
    ref = (rgba[..., :3].astype(np.float32) / 255.0) * a + (1 - a)
    np.testing.assert_allclose(out, ref, atol=1e-5)
    theirs = against_jax(path, None, True)
    if theirs is not None:
        np.testing.assert_allclose(out, theirs, atol=1e-6)


def test_jpeg_decode(lib, rng, tmp_path):
    img = rng.uniform(0, 255, (32, 32, 3)).astype(np.uint8)
    path = str(tmp_path / "t.jpg")
    cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    out = native.decode_image(path)
    ref = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB).astype(np.float32) / 255
    np.testing.assert_allclose(out, ref, atol=0.02)  # codec noise only
    theirs = against_jax(path)
    if theirs is not None:
        np.testing.assert_allclose(out, theirs, atol=1e-6)


def test_pfm_roundtrip(lib, rng, tmp_path):
    """The library's PFM reader against the written depth, the port's
    ``utils/io.read_pfm`` and the JAX binding's reader."""
    depth = rng.uniform(400, 900, (24, 30)).astype(np.float32)
    path = str(tmp_path / "d.pfm")
    write_pfm(path, depth)
    ours = native.read_pfm(path)
    np.testing.assert_allclose(ours, depth, rtol=1e-6)
    np.testing.assert_array_equal(ours, read_pfm(path)[0])
    if jax_native.available():
        np.testing.assert_array_equal(ours, jax_native.read_pfm(path))


def test_decode_pool_parallel(lib, rng, tmp_path):
    """Eight PNGs through a pool of 4 threads: each equal to its bytes / 255
    and to a single ``decode_image`` of the same file."""
    paths, refs = [], []
    for i in range(8):
        img = rng.uniform(0, 255, (24, 24, 3)).astype(np.uint8)
        paths.append(write_rgb(tmp_path / f"p{i}.png", img))
        refs.append(img.astype(np.float32) / 255.0)
    pool = native.DecodePool(4)
    outs = [pool.submit(p, (24, 24)) for p in paths]
    pool.wait()
    for out, ref, p in zip(outs, refs, paths):
        np.testing.assert_allclose(out, ref, atol=1e-6)
        np.testing.assert_array_equal(out, native.decode_image(p, (24, 24)))


def test_missing_file_raises(lib):
    with pytest.raises(IOError):
        native.decode_image("/nonexistent/file.png")


def test_pool_reports_errors(lib):
    pool = native.DecodePool(2)
    pool.submit("/nonexistent/x.png", (8, 8))
    with pytest.raises(IOError):
        pool.wait()


def test_load_rgb_takes_the_library_where_it_builds(lib, rng, tmp_path, monkeypatch):
    """``load_rgb`` decodes through the library when ``available()``, with and
    without a white background, and through cv2 when a prerequisite is
    missing; both agree within 1e-6."""
    calls = []
    decode = native.decode_image
    monkeypatch.setattr(native, "decode_image", lambda *a: calls.append(a) or decode(*a))
    img = rng.uniform(0, 255, (12, 20, 3)).astype(np.uint8)
    path = write_rgb(tmp_path / "l.png", img)
    rgba = rng.uniform(0, 255, (12, 20, 4)).astype(np.uint8)
    path_a = str(tmp_path / "la.png")
    cv2.imwrite(path_a, cv2.cvtColor(rgba, cv2.COLOR_RGBA2BGRA))
    got = [imageio.load_rgb(path), imageio.load_rgb(path_a, white_bg=True)]
    assert calls == [(path, None, False), (path_a, None, True)]
    monkeypatch.setattr(native, "unavailable_reason", lambda: "g++ not found")
    assert not native.available()
    want = [imageio.load_rgb(path), imageio.load_rgb(path_a, white_bg=True)]
    assert len(calls) == 2
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_the_build_reads_only_the_ports_source(lib):
    """The library comes from ``gdb_nerf_tpu_torch/csrc/gdbn_io.cpp``, keyed
    by a hash of it: nothing of the JAX package's ``native`` folder."""
    assert native.SOURCE == Path(REPO, "gdb_nerf_tpu_torch", "csrc", "gdbn_io.cpp")
    assert lib.name.startswith("libgdbn_io-") and "native" not in lib.parts
    assert native.BUILD_DIR.relative_to(REPO).parts == ("build", "gdbn_io")
