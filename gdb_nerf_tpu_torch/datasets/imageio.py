"""Image loading helper: the port's native decoder where it builds, cv2 otherwise.

As the JAX package's ``datasets/imageio.py``: ``load_rgb`` decodes with the
native library (``datasets/native.py``, built from ``csrc/gdbn_io.cpp``)
when ``native.available()``, and with cv2 where a prerequisite of that
build is missing.  cv2 is imported where it is used, so that the package
imports on a machine without it.
"""

from __future__ import annotations

import numpy as np

from gdb_nerf_tpu_torch.datasets import native


def load_rgb(path: str, white_bg: bool = False) -> np.ndarray:
    """Load an image as float32 RGB (H, W, 3) in [0, 1].

    white_bg composites an alpha channel over white (NeRF-synthetic).
    """
    if native.available():
        return native.decode_image(path, None, white_bg)
    import cv2

    if white_bg:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED).astype(np.float32) / 255.0
        img = img[..., :3] * img[..., -1:] + (1 - img[..., -1:])
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
