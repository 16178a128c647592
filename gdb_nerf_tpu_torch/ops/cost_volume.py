"""Plane-sweep cost volume and depth regression.

Port of ``gdb_nerf_tpu/ops/cost_volume.py`` (eval form): uniform depth or
disparity hypotheses, a zeros-padded bilinear warp of every source feature
map onto the target's depth planes, the variance across views as the cost,
and a softmax-expectation depth with a std-derived confidence interval.

Layouts: feature maps and the volume are NC(D)HW, as the Conv3d U-Net that
consumes the volume wants them; hypotheses are (B, D, H, W).
"""

from __future__ import annotations

import torch

from gdb_nerf_tpu_torch.ops import camera
from gdb_nerf_tpu_torch.ops.grid_sample import grid_sample_2d_nchw


def get_depth_values(near_far: torch.Tensor, num_depth: int, inv_depth: bool) -> torch.Tensor:
    """Uniform hypotheses (B, D, H, W) between near and far (B, 2, H, W).

    With ``inv_depth`` the values are disparities (decreasing along D).
    Steps are ``unit_steps``.
    """
    near = near_far[:, 0:1]
    far = near_far[:, 1:2]
    if inv_depth:
        near = 1.0 / near
        far = 1.0 / far
    steps = unit_steps(num_depth, near.device, near.dtype)
    return near + (far - near) * steps[:, None, None]


def unit_steps(n: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """``n`` uniform steps from 0 to 1 as XLA evaluates ``jnp.linspace(0, 1, n)``:
    ``i * (1 / (n - 1))``, with an exact 1 at the end."""
    steps = torch.arange(n, device=device, dtype=dtype) * (1.0 / max(n - 1, 1))
    steps[-1].fill_(1.0)  # fill_: assigning a Python float would sync with the device
    return steps


def warp_src_to_volume(
    src_feat: torch.Tensor, proj: torch.Tensor, metric_depth: torch.Tensor
) -> torch.Tensor:
    """Warp source features onto target depth planes.

    Args:
      src_feat: (B, C, Hs, Ws) source features.
      proj: (B, 3, 4) plane-sweep projection (camera.plane_sweep_projection).
      metric_depth: (B, D, Ht, Wt) metric depth per plane.

    Returns:
      (B, C, D, Ht, Wt), zero where the projection leaves the source image.
    """
    Hs, Ws = src_feat.shape[-2:]
    B, D, Ht, Wt = metric_depth.shape
    x, y = camera.pixel_centers(Ht, Wt, metric_depth.device, metric_depth.dtype)
    pix = torch.stack([x, y, torch.ones_like(x)], dim=-1)  # (Ht, Wt, 3)
    base = camera.mm(pix.reshape(-1, 3), proj[:, :, :3].transpose(-1, -2))
    base = base.reshape(B, 1, Ht, Wt, 3)
    xyz = base * metric_depth[..., None] + proj[:, None, None, None, :, 3]
    z = torch.clamp_min(xyz[..., 2], 1e-6)
    gx = 2.0 * (xyz[..., 0] / z) / Ws - 1.0
    gy = 2.0 * (xyz[..., 1] / z) / Hs - 1.0
    grid = torch.stack([gx, gy], dim=-1)  # (B, D, Ht, Wt, 2)
    warped = grid_sample_2d_nchw(src_feat, grid, padding_mode="zeros")
    return warped.permute(0, 4, 1, 2, 3)


def build_cost_volume(
    src_feats: torch.Tensor,
    src_exts: torch.Tensor,
    src_ints: torch.Tensor,
    tar_ext: torch.Tensor,
    tar_int: torch.Tensor,
    depth_values: torch.Tensor,
    inv_depth: bool,
) -> torch.Tensor:
    """Variance-metric cost volume over all source views.

    Args:
      src_feats: (B, V, C, Hs, Ws) source features (any float dtype).
      src_exts (B, V, 4, 4), src_ints (B, V, 3, 3) at feature resolution.
      tar_ext (B, 4, 4), tar_int (B, 3, 3) at volume resolution.
      depth_values: (B, D, Ht, Wt) hypotheses (disparity if inv_depth).

    Returns:
      (B, C, D, Ht, Wt) population variance across views, in the features'
      dtype.  The moments are accumulated in float32 as ``s2/V - mean**2``
      even for bf16 features: the variance drives the depth softmax.
    """
    metric_depth = 1.0 / depth_values if inv_depth else depth_values
    V = src_feats.shape[1]
    projs = camera.plane_sweep_projection(
        src_exts, src_ints, tar_ext[:, None], tar_int[:, None]
    )  # (B, V, 3, 4)
    feats32 = src_feats.float()
    s1 = s2 = None
    for v in range(V):
        w = warp_src_to_volume(feats32[:, v], projs[:, v], metric_depth)
        s1 = w if s1 is None else s1 + w
        s2 = w * w if s2 is None else s2 + w * w
    mean = s1 / V
    return (s2 / V - mean * mean).to(src_feats.dtype)


def depth_regression(
    depth_values: torch.Tensor,
    depth_prob: torch.Tensor,
    ci_scale: float,
    inv_depth: bool,
):
    """Softmax-expectation depth plus a confidence interval.

    Args: depth_values, depth_prob (B, D, H, W); ci_scale in units of std.
    Returns: depth (B, H, W) metric; ci (B, 2, H, W) metric (near, far),
      clamped to the hypothesis range.
    """
    expect = (depth_prob * depth_values).sum(dim=1, keepdim=True)
    var = (depth_prob * torch.square(depth_values - expect)).sum(dim=1, keepdim=True)
    half = ci_scale * torch.sqrt(torch.clamp_min(var, 1e-12))
    if inv_depth:
        hi = torch.minimum(expect + half, depth_values[:, 0:1])
        lo = torch.maximum(expect - half, depth_values[:, -1:])
        ci = 1.0 / torch.cat([hi, lo], dim=1)
        depth = 1.0 / expect
    else:
        lo = torch.maximum(expect - half, depth_values[:, 0:1])
        hi = torch.minimum(expect + half, depth_values[:, -1:])
        ci = torch.cat([lo, hi], dim=1)
        depth = expect
    return depth[:, 0], ci
