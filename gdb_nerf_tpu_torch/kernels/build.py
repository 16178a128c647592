"""nvcc at first use: each CUDA source of ``csrc/`` becomes a shared library
with a plain C interface, loaded with ctypes.

Libraries go to ``build/kernels/`` (gitignored), named by the source's stem
and a hash of its text and the flags, so that an edited source or changed
flags build anew and an unchanged one is reused.  Two builds of different
sources may run at once (``chip_smoke.py`` starts them together).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CSRC = REPO / "gdb_nerf_tpu_torch" / "csrc"
BUILD_DIR = REPO / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def build_library(source: Path, build_dir: Path = BUILD_DIR) -> tuple[Path, str]:
    """Compile ``source`` with nvcc into ``build_dir`` unless a library built
    from the same source and flags is already there.

    Returns (library path, compiler log; empty when nothing was built).
    """
    text = source.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = build_dir / f"{source.stem}-{digest}.so"
    if out.exists():
        return out, ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, proc.stdout + proc.stderr
