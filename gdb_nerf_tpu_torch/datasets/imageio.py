"""Image loading helper: cv2 decode to float32 RGB.

The JAX package decodes with its optional native C++ library
(``native/libgdbn_io.so``) when that is built and with cv2 otherwise; the
port takes the cv2 path only (the native decoder is still to be ported).
cv2 is imported where it is used, so that the package imports on a
machine without it.
"""

from __future__ import annotations

import numpy as np


def load_rgb(path: str, white_bg: bool = False) -> np.ndarray:
    """Load an image as float32 RGB (H, W, 3) in [0, 1].

    white_bg composites an alpha channel over white (NeRF-synthetic).
    """
    import cv2

    if white_bg:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED).astype(np.float32) / 255.0
        img = img[..., :3] * img[..., -1:] + (1 - img[..., -1:])
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
