"""The host decode rate: cv2 against the port's native decoder.

The port's counterpart of ``tools/microbench_loader.py``.  Each eval frame
needs V = 3 source images decoded (and resized) on the host; the loader's
threads overlap that with the device, but its rate must clear the frame
time.  On reference-shaped files written here from seed 0, a 512x640 RGB
PNG (DTU's ``rect_*_3_r5000.png``) and a 1024x1280 float32 PFM (its depth
maps), it times, each ``--n`` times after a warm-up:

  cv2.imread of the PNG, the native ``decode_image``, the native
  ``DecodePool`` of 4 threads (per image), cv2.imread of the PFM and the
  native ``read_pfm`` (``datasets/native.py`` over ``csrc/gdbn_io.cpp``).

A row is printed only where its decoder is there: cv2 where it imports, the
native rows where the library builds (``native.available()``; the reason
is printed where it does not).  Then the per-frame decode of V = 3 images
at the fastest PNG decode, against ``--frame-ms`` when given, and one JSON
line.

    python -m gdb_nerf_tpu_torch.tools.microbench_loader [--n 60] [--frame-ms MS]
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import tempfile
import time
import zlib

import numpy as np

from gdb_nerf_tpu_torch.datasets import native
from gdb_nerf_tpu_torch.utils.io import write_pfm

VIEWS = 3


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit RGB PNG (H, W, 3) written with the standard library's zlib."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def bench(fn, n: int) -> float:
    """Seconds a call of ``fn``, the mean of ``n`` after a warm-up."""
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


def measure(n: int = 60, frame_ms: float | None = None) -> dict:
    """Every row of the module's docstring; returns them with the frame's
    decode time."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    reason = native.unavailable_reason()
    rng = np.random.default_rng(0)
    rows = []

    def report(name, sec_per, note=""):
        rows.append({"name": name, "ms": sec_per * 1e3, "per_s": 1.0 / sec_per})
        print(f"{name:<34s} {sec_per * 1e3:7.2f} ms  {1.0 / sec_per:8.1f}/s  {note}", flush=True)

    with tempfile.TemporaryDirectory() as td:
        png = os.path.join(td, "rect.png")
        write_png(png, rng.integers(0, 255, (512, 640, 3), dtype=np.uint8))
        pfm = os.path.join(td, "d.pfm")
        write_pfm(pfm, rng.uniform(400, 900, (1024, 1280)).astype(np.float32))
        if cv2 is not None:
            report("cv2.imread 512x640 png", bench(lambda: cv2.imread(png), n))
        else:
            print("cv2 not importable: no cv2 rows", flush=True)
        if reason is None:
            report("native decode 512x640 png", bench(lambda: native.decode_image(png), n))
            pool = native.DecodePool(num_threads=4)

            def pooled():
                for _ in range(4):
                    pool.submit(png, (512, 640))
                pool.wait()

            report("native pooled decode (4 threads)", bench(pooled, max(n // 4, 8)) / 4,
                   "per image")
        else:
            print(f"native decoder unavailable ({reason}): no native rows", flush=True)
        if cv2 is not None:
            report("cv2.imread 1024x1280 pfm",
                   bench(lambda: cv2.imread(pfm, cv2.IMREAD_UNCHANGED), n))
        if reason is None:
            report("native read_pfm 1024x1280", bench(lambda: native.read_pfm(pfm), n))

    decodes = [r["ms"] for r in rows if "png" in r["name"] or "decode" in r["name"]]
    per_frame = VIEWS * min(decodes) if decodes else None
    if per_frame is None:
        print("no PNG decoder here: no per-frame decode time", flush=True)
    elif frame_ms is None:
        print(f"\nper-frame host decode (V={VIEWS}): {per_frame:.2f} ms", flush=True)
    else:
        verdict = (f"{frame_ms / per_frame:.1f}x headroom" if per_frame < frame_ms
                   else "over the frame time")
        print(f"\nper-frame host decode (V={VIEWS}): {per_frame:.2f} ms against a "
              f"{frame_ms:.2f} ms frame: {verdict}", flush=True)
    return {"rows": rows, "per_frame_decode_ms": per_frame, "frame_ms": frame_ms,
            "cv2": cv2 is not None, "native_decoder": reason or "available", "n": n}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=60)
    ap.add_argument("--frame-ms", type=float, default=None,
                    help="the frame time to hold the V = 3 decode against")
    args = ap.parse_args(argv)
    result = measure(args.n, args.frame_ms)
    print(json.dumps({"microbench_loader": result}), flush=True)
    return result


if __name__ == "__main__":
    main()
