"""File readers for the MVS datasets (DTU camera files, PFM depth maps),
and the PFM writer.

Formats match the reference's parsers (its utils/data_utils.py:
read_cam_file at 55-67, read_pfm at 83-118): DTU `*_cam.txt` files hold a
4x4 extrinsic block, a 3x3 intrinsic block, and a `depth_min depth_interval`
line; `.pfm` is the Portable Float Map format with a scale/endianness line
and bottom-up row order.
"""

from __future__ import annotations

import re

import numpy as np


def read_cam_file(path: str):
    """Parse a DTU camera file.

    Returns (intrinsics (3,3), extrinsics (4,4) w2c, depth_min, depth_interval).
    """
    with open(path) as f:
        lines = [line.rstrip() for line in f.readlines()]
    extrinsics = np.fromstring(" ".join(lines[1:5]), dtype=np.float32, sep=" ")
    extrinsics = extrinsics.reshape(4, 4)
    intrinsics = np.fromstring(" ".join(lines[7:10]), dtype=np.float32, sep=" ")
    intrinsics = intrinsics.reshape(3, 3)
    depth_min, depth_interval = (float(x) for x in lines[11].split()[:2])
    return intrinsics, extrinsics, depth_min, depth_interval


def read_pfm(path: str):
    """Read a PFM image. Returns (data (H, W[, 3]) float32, scale)."""
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"Not a PFM file: {path}")

        dims = f.readline().decode("utf-8")
        m = re.match(r"^(\d+)\s(\d+)\s$", dims)
        if not m:
            raise ValueError(f"Malformed PFM header: {path}")
        width, height = map(int, m.groups())

        scale = float(f.readline().decode("utf-8").rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    data = data.reshape(shape)
    return np.flipud(data).copy(), scale


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    """Write a float32 image as PFM (for depth-map dumps)."""
    image = np.flipud(image).astype(np.float32)
    color = image.ndim == 3 and image.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        image.tofile(f)
