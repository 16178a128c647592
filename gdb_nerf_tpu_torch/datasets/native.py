"""ctypes binding of the port's native image decoder (``csrc/gdbn_io.cpp``).

Host C++: PNG/JPEG decode straight into float32 RGB in [0, 1], a bilinear
resize, PFM reading and an async decode pool, with the API of the JAX
package's ``datasets/native.py``.  The library builds with g++ at first
use into ``build/gdbn_io/`` (gitignored), named by a hash of the source and
the flags, so an edited source builds anew; two processes may build at once.

``available()`` is False only where a prerequisite is missing: no ``g++``,
or no ``png.h``, ``jpeglib.h`` or ``zlib.h`` where g++ looks
(``unavailable_reason`` says which); ``datasets/imageio.py`` then decodes
with cv2.  Where they are present, a build or load error raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "gdb_nerf_tpu_torch" / "csrc" / "gdbn_io.cpp"
BUILD_DIR = REPO / "build" / "gdbn_io"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
LIBS = ["-lpng", "-ljpeg", "-lz", "-lpthread"]
HEADERS = ("png.h", "jpeglib.h", "zlib.h")

_LIB: ctypes.CDLL | None = None

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {  # name: (argument types, result type)
    "gdbn_decode_image": ([ctypes.c_char_p, _F, ctypes.c_int, ctypes.c_int, ctypes.c_int],
                          ctypes.c_int),
    "gdbn_image_size": ([ctypes.c_char_p, _I, _I], ctypes.c_int),
    "gdbn_pfm_size": ([ctypes.c_char_p, _I, _I], ctypes.c_int),
    "gdbn_read_pfm": ([ctypes.c_char_p, _F, ctypes.c_int, ctypes.c_int], ctypes.c_int),
    "gdbn_pool_create": ([ctypes.c_int], ctypes.c_void_p),
    "gdbn_pool_destroy": ([ctypes.c_void_p], None),
    "gdbn_pool_submit_image": ([ctypes.c_void_p, ctypes.c_char_p, _F, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int], None),
    "gdbn_pool_wait": ([ctypes.c_void_p], ctypes.c_int),
}


@functools.cache
def unavailable_reason() -> str | None:
    """The missing prerequisites, or None when the library can be built."""
    cxx = shutil.which("g++")
    if cxx is None:
        return "g++ not found"
    missing = [h for h in HEADERS if subprocess.run(
        [cxx, "-E", "-x", "c++", "-", "-o", os.devnull], input=f"#include <{h}>\n",
        capture_output=True, text=True).returncode != 0]
    return f"{', '.join(missing)} not found by g++" if missing else None


def available() -> bool:
    """True when the library is built and loaded (building it at first
    call); False only when ``unavailable_reason`` names a prerequisite."""
    if unavailable_reason() is not None:
        return False
    _lib()
    return True


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``SOURCE`` with g++ into ``build_dir`` unless a library built
    from the same source and flags is there; returns its path."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode())
    out = Path(build_dir) / f"libgdbn_io-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SOURCE), *LIBS],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """Build (if needed) into ``build_dir``, load and bind the library, and
    make it the one this module's functions call."""
    global _LIB
    lib = ctypes.CDLL(str(build(build_dir)))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    _LIB = lib
    return lib


def _lib() -> ctypes.CDLL:
    return _LIB if _LIB is not None else load()


def _fptr(arr: np.ndarray):
    return arr.ctypes.data_as(_F)


def image_size(path: str) -> tuple[int, int]:
    h, w = ctypes.c_int(), ctypes.c_int()
    if _lib().gdbn_image_size(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        raise IOError(f"cannot read image: {path}")
    return h.value, w.value


def decode_image(path: str, out_hw: tuple[int, int] | None = None,
                 white_bg: bool = False) -> np.ndarray:
    """Decode (and optionally resize, bilinear with half-pixel centers) to
    float32 RGB (H, W, 3) in [0, 1]; ``white_bg`` composites an alpha
    channel over white."""
    if out_hw is None:
        out_hw = image_size(path)
    out = np.empty((*out_hw, 3), np.float32)
    if _lib().gdbn_decode_image(path.encode(), _fptr(out), out_hw[0], out_hw[1],
                                int(white_bg)) != 0:
        raise IOError(f"decode failed: {path}")
    return out


def read_pfm(path: str) -> np.ndarray:
    """A single-channel PFM as float32 (H, W), top row first."""
    lib = _lib()
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.gdbn_pfm_size(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 1:
        raise IOError(f"not a 1-channel PFM: {path}")
    out = np.empty((h.value, w.value), np.float32)
    if lib.gdbn_read_pfm(path.encode(), _fptr(out), h.value, w.value) != 0:
        raise IOError(f"pfm read failed: {path}")
    return out


class DecodePool:
    """Async decode pool: submit many images, then wait once per batch."""

    def __init__(self, num_threads: int = 4):
        self._lib = _lib()
        self._pool = self._lib.gdbn_pool_create(num_threads)
        self._keep: list = []

    def submit(self, path: str, out_hw: tuple[int, int], white_bg: bool = False) -> np.ndarray:
        """Queue a decode into a new (H, W, 3) float32 array, returned now and
        filled once ``wait`` returns."""
        out = np.empty((*out_hw, 3), np.float32)
        bpath = path.encode()
        self._keep.append((bpath, out))
        self._lib.gdbn_pool_submit_image(self._pool, bpath, _fptr(out), out_hw[0], out_hw[1],
                                         int(white_bg))
        return out

    def wait(self) -> None:
        """Wait for every submitted decode; raises IOError if any failed."""
        errors = self._lib.gdbn_pool_wait(self._pool)
        self._keep.clear()
        if errors:
            raise IOError(f"{errors} decode jobs failed")

    def __del__(self):
        if getattr(self, "_pool", None):
            self._lib.gdbn_pool_destroy(self._pool)
            self._pool = None
