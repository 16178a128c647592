"""Image visualization helpers.

A copy of ``gdb_nerf_tpu/utils/img.py``, the reference's depth colormap
visualization: nan-zeroed depth normalized to
[0, 1] by (min positive, max) or an explicit ``minmax``, then colormapped
with cv2 (JET by default, BGR uint8 output — matching the reference, which
writes the result with ``cv2.imwrite``).
"""

from __future__ import annotations

import cv2
import numpy as np


def visualize_depth_numpy(
    depth: np.ndarray,
    minmax: tuple[float, float] | None = None,
    cmap: int = cv2.COLORMAP_JET,
) -> tuple[np.ndarray, list[float]]:
    """Colormap an (H, W) depth map.  Returns (BGR uint8 image, [mi, ma]).

    ``minmax=None`` normalizes by the minimum *positive* depth (background
    zeros ignored) and the maximum, exactly as the reference does; pass an
    explicit range to keep frames of one scene on a shared scale.

    Deviation: out-of-range values clamp to [0, 255] — the reference feeds
    negative floats (background zeros when mi > 0) straight into a uint8
    cast, which wraps to arbitrary bytes.
    """
    x = np.nan_to_num(np.asarray(depth, np.float32))
    if minmax is None:
        pos = x[x > 0]
        mi = float(np.min(pos)) if pos.size else 0.0
        ma = float(np.max(x))
    else:
        mi, ma = float(minmax[0]), float(minmax[1])
    x = (x - mi) / (ma - mi + 1e-8)
    x = (255 * np.clip(x, 0.0, 1.0)).astype(np.uint8)
    return cv2.applyColorMap(x, cmap), [mi, ma]
