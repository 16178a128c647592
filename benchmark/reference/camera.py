"""Camera geometry: rays, projections, plane-sweep projection matrices.

Port of ``gdb_nerf_tpu/ops/camera.py`` with the same conventions:
world-to-camera 4x4 extrinsics, 3x3 pinhole intrinsics in pixel units, and
pixel (i, j) centered at (j + 0.5, i + 0.5).  Every function broadcasts over
leading batch dimensions.

All math here is float32 and must stay so: run it outside any autocast
region and never lower ``torch.set_float32_matmul_precision`` below
"highest" (a TF32 matmul costs ~0.1 px of projection error).  ``mm`` is the
single place geometry matmuls go through.
"""

from __future__ import annotations

import math

import torch


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Float32 matmul for small geometry matrices."""
    return torch.matmul(a, b)


def invert_extrinsics(ext: torch.Tensor) -> torch.Tensor:
    """Invert rigid w2c (..., 4, 4) into c2w with the closed form [R^T | -R^T t]."""
    Rt = ext[..., :3, :3].transpose(-1, -2)
    t = ext[..., :3, 3:]
    top = torch.cat([Rt, -mm(Rt, t)], dim=-1)
    bottom = torch.zeros_like(ext[..., 3:, :])
    bottom[..., 3].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def invert_intrinsics(K: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of upper-triangular pinhole intrinsics (..., 3, 3)."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    s = K[..., 0, 1]
    inv = torch.zeros_like(K)
    inv[..., 0, 0] = 1.0 / fx
    inv[..., 1, 1] = 1.0 / fy
    inv[..., 2, 2].fill_(1.0)
    inv[..., 0, 1] = -s / (fx * fy)
    inv[..., 0, 2] = (s * cy - cx * fy) / (fx * fy)
    inv[..., 1, 2] = -cy / fy
    return inv


def scale_intrinsics(K: torch.Tensor, s: float) -> torch.Tensor:
    """Scale the first two rows of (..., 3, 3) intrinsics by s (an image
    resized by s).  Built on K's device: a host-made factor tensor would be a
    blocking host-to-device copy in the middle of the forward."""
    return torch.cat([K[..., :2, :] * s, K[..., 2:, :]], dim=-2)


def pixel_centers(H: int, W: int, device=None, dtype=torch.float32):
    """(H, W) grids of pixel-center x and y coordinates."""
    x = torch.arange(W, device=device, dtype=dtype) + 0.5
    y = torch.arange(H, device=device, dtype=dtype) + 0.5
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return xx, yy


def build_rays(tar_ext: torch.Tensor, tar_int: torch.Tensor, H: int, W: int):
    """World-space rays through every pixel center of the target view(s).

    Args: tar_ext (..., 4, 4), tar_int (..., 3, 3).
    Returns:
      rays_o: (..., 3) camera center; rays_d: (..., H, W, 3) unnormalized
      directions (z=1 in the camera frame); uv: (H, W, 2) normalized pixel
      coordinates in [-1, 1]; z_axis: (..., 3) viewing direction.
    """
    c2w = invert_extrinsics(tar_ext)
    x, y = pixel_centers(H, W, tar_ext.device, tar_ext.dtype)
    pix = torch.stack([x, y, torch.ones_like(x)], dim=-1)  # (H, W, 3)
    M = mm(c2w[..., :3, :3], invert_intrinsics(tar_int))  # (..., 3, 3)
    lead = M.shape[:-2]
    rays_d = mm(pix.reshape(-1, 3), M.transpose(-1, -2)).reshape(*lead, H, W, 3)
    uv = torch.stack([2.0 * x / W - 1.0, 2.0 * y / H - 1.0], dim=-1)
    return c2w[..., :3, 3], rays_d, uv, c2w[..., :3, 2]


def pixel_radius(K: torch.Tensor) -> torch.Tensor:
    """Radius of the disk with one pixel's area on the z=1 plane: 1/sqrt(fx fy pi)."""
    return 1.0 / torch.sqrt(K[..., 0, 0] * K[..., 1, 1] * math.pi)


def project_points(xyz: torch.Tensor, ext: torch.Tensor, K: torch.Tensor):
    """Project world points (..., P, 3) into cameras ext (..., 4, 4), K (..., 3, 3).

    Returns pix (..., P, 2) divided by the clamped depth, depth (..., P),
    and camera-space coordinates (..., P, 3).
    """
    cam = mm(xyz, ext[..., :3, :3].transpose(-1, -2)) + ext[..., None, :3, 3]
    img = mm(cam, K.transpose(-1, -2))
    depth = img[..., 2]
    pix = img[..., :2] / torch.clamp_min(depth, 1e-6)[..., None]
    return pix, depth, cam


def plane_sweep_projection(
    src_ext: torch.Tensor,
    src_int: torch.Tensor,
    tar_ext: torch.Tensor,
    tar_int: torch.Tensor,
) -> torch.Tensor:
    """(..., 3, 4) matrix P mapping a target pixel p = (x+.5, y+.5, 1) at depth
    d to source homogeneous coordinates ``P[:, :3] @ p * d + P[:, 3]``."""
    src_proj = mm(src_int, src_ext[..., :3, :])  # (..., 3, 4)
    tar_proj = mm(tar_int, tar_ext[..., :3, :])
    last = torch.zeros_like(tar_proj[..., :1, :])
    last[..., 3].fill_(1.0)
    tar_proj4 = torch.cat([tar_proj, last], dim=-2)
    # inv_ex, not inv: inv reads its error flag back to the host, a sync in
    # the middle of the forward.  A camera's projection is never singular.
    return mm(src_proj, torch.linalg.inv_ex(tar_proj4)[0])
