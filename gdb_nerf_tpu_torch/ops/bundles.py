"""Depth-guided bundle sampling and sample encoding.

Port of ``gdb_nerf_tpu/ops/bundles.py``.  Every b x b block of target rays
is a bundle; samples sit inside the bundle's MVS confidence interval in a
dense (B, H, W, S) layout with a validity mask, S = max_num_samples, and
the adaptive path shrinks each bundle's count to ceil(interval /
min_spacing) clamped to [1, S].  Encoding gathers, for every sample, the
cost-volume feature (trilinear, border), the b*b member rays' source RGB
(bilinear, border), a mip-filtered source feature at the sample's
footprint level, and IBRNet-style ray-difference features.

All tensors carry the batch axis; per-view tensors carry the view axis
right after it: (B, V, H, W, S, ...).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gdb_nerf_tpu_torch.ops import camera
from gdb_nerf_tpu_torch.ops.grid_sample import grid_sample_2d_nchw, grid_sample_3d_ncdhw
from gdb_nerf_tpu_torch.ops.mip import mip_texture_fetch


class RayBundle(NamedTuple):
    """Target rays grouped into b x b bundles.

    Member k = i*b + j has direction ``bundle_d + member_off[k]``: ray
    directions are linear in the pixel coordinate, so the offsets are the
    same for every bundle of an image.
    """

    rays_o: torch.Tensor  # (B, 3) camera center (world)
    bundle_d: torch.Tensor  # (B, H, W, 3) mean member direction (unnormalized)
    member_off: torch.Tensor  # (B, b*b, 3) image-constant member offsets
    uv: torch.Tensor  # (H, W, 2) normalized bundle-center pixel coords
    cos: torch.Tensor  # (B, H, W) cos(bundle axis, camera z-axis)
    disk_radius: torch.Tensor  # (B,) bundle disk radius on the z=1 plane
    near: torch.Tensor  # (B,) scene near depth
    far: torch.Tensor  # (B,) scene far depth


class BundleSamples(NamedTuple):
    """Dense samples along bundles."""

    z_vals: torch.Tensor  # (B, H, W, S) depth (or disparity) at bin midpoints
    z_metric: torch.Tensor  # (B, H, W, S) metric depth
    valid: torch.Tensor  # (B, H, W, S) bool validity mask
    uvd: torch.Tensor  # (B, H, W, S, 3) normalized volume coords
    ball_radii: torch.Tensor  # (B, H, W, S) sphere radii
    samples_per_bundle: torch.Tensor  # (B, H, W) number of valid samples


class EncodedSamples(NamedTuple):
    """Per-sample features from the source views and the cost volume."""

    rgbs: torch.Tensor  # (B, V, H, W, S, b*b, 3) member-ray source RGB
    mip_feat: torch.Tensor  # (B, V, H, W, S, F) filtered source feature ++ rgb
    ray_diff: torch.Tensor  # (B, V, H, W, S, 4) direction difference + dot
    vox_feat: torch.Tensor  # (B, H, W, S, C) cost-volume features


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)


def make_ray_bundles(
    tar_ext: torch.Tensor,
    tar_int: torch.Tensor,
    im_size: tuple[int, int],
    near: torch.Tensor,
    far: torch.Tensor,
    b_size: int,
) -> RayBundle:
    """Build per-pixel rays for (B, 4, 4) / (B, 3, 3) cameras and group them."""
    H_orig, W_orig = im_size
    rays_o, rays_d, uv, z_axis = camera.build_rays(tar_ext, tar_int, H_orig, W_orig)
    # Member means, summed in the reference's (i, j) order.
    acc_d = acc_uv = None
    for i in range(b_size):
        for j in range(b_size):
            d_ij = rays_d[:, i::b_size, j::b_size]
            u_ij = uv[i::b_size, j::b_size]
            acc_d = d_ij if acc_d is None else acc_d + d_ij
            acc_uv = u_ij if acc_uv is None else acc_uv + u_ij
    inv = 1.0 / (b_size * b_size)
    bundle_d = acc_d * inv
    member_off = torch.stack(
        [rays_d[:, i, j] for i in range(b_size) for j in range(b_size)], dim=1
    ) - bundle_d[:, None, 0, 0]
    cos = (bundle_d * z_axis[:, None, None]).sum(-1) / torch.linalg.vector_norm(
        bundle_d, dim=-1
    )
    disk_radius = b_size * camera.pixel_radius(tar_int)
    return RayBundle(rays_o, bundle_d, member_off, acc_uv * inv, cos, disk_radius, near, far)


def sample_bundles(
    rb: RayBundle,
    depth_range: torch.Tensor,
    vol_range: torch.Tensor,
    max_num_samples: int,
    global_num_depth: int,
    inv_depth: bool,
    is_adaptive: bool,
) -> BundleSamples:
    """Place S samples inside each bundle's interval.

    Args:
      depth_range: (B, 2, H, W) metric (near, far) per bundle.
      vol_range: (B, 2, H, W) metric range of the cost-volume hypotheses.
    """
    S = max_num_samples
    B, _, H, W = depth_range.shape
    if inv_depth:
        depth_range = 1.0 / depth_range
        vol_range = 1.0 / vol_range
        min_interval = (1.0 / rb.near - 1.0 / rb.far) / global_num_depth
    else:
        min_interval = (rb.far - rb.near) / global_num_depth
    b_near, b_far = depth_range[:, 0], depth_range[:, 1]  # (B, H, W)
    if is_adaptive:
        spb = torch.ceil(torch.abs(b_far - b_near) / min_interval[:, None, None])
        spb = torch.clamp(spb, 1.0, float(S))
    else:
        spb = torch.full_like(b_near, float(S))

    idx = torch.arange(S + 1, device=spb.device, dtype=spb.dtype)
    t_vals = b_near[..., None] + (b_far - b_near)[..., None] / spb[..., None] * idx
    z_vals = 0.5 * (t_vals[..., :-1] + t_vals[..., 1:])  # (B, H, W, S)
    valid = idx[:-1] < spb[..., None]

    vol_near = vol_range[:, 0, ..., None]
    vol_far = vol_range[:, 1, ..., None]
    d = 2.0 * (z_vals - vol_near) / (vol_far - vol_near) - 1.0
    uvd = torch.cat([rb.uv[None, :, :, None, :].expand(B, H, W, S, 2), d[..., None]], dim=-1)
    z_metric = 1.0 / z_vals if inv_depth else z_vals

    # Cone geometry -> unit ball radius, scaled by the sample's distance.
    cos = rb.cos
    tan = torch.sqrt(torch.clamp_min(1.0 / torch.square(cos) - 1.0, 1e-12))
    disk = rb.disk_radius[:, None, None]
    unit_radius = disk * cos / torch.sqrt(torch.square(tan - disk) + 1.0)
    distances = z_metric * torch.linalg.vector_norm(rb.bundle_d, dim=-1)[..., None]
    ball_radii = distances * unit_radius[..., None]
    return BundleSamples(z_vals, z_metric, valid, uvd, ball_radii, spb)


def fetch_vox(feat_volume: torch.Tensor, samples: BundleSamples) -> torch.Tensor:
    """Trilinear, border-padded cost-volume features (B, H, W, S, C).

    ``feat_volume`` is (B, C, D, Hv, Wv); it is sampled through a float32
    copy and the result returned in its dtype.
    """
    out = grid_sample_3d_ncdhw(feat_volume.float(), samples.uvd, padding_mode="border")
    return out.to(feat_volume.dtype)


def encode_samples(
    rb: RayBundle,
    samples: BundleSamples,
    src_images: torch.Tensor,
    pyramid: list[torch.Tensor],
    feat_volume: torch.Tensor,
    src_exts: torch.Tensor,
    src_ints: torch.Tensor,
    max_mipmap_level: int,
) -> EncodedSamples:
    """Sphere-based encoding of bundle samples from all source views.

    Args:
      rb, samples: the bundles and their samples (H bundle rows).
      src_images: (B, V, H_orig, W_orig, 3) float32 source images.
      pyramid: ``mip.build_pyramid`` levels of the (B*V, F, Hf, Wf) source
        feature ++ rgb maps at bundle resolution, float32.
      feat_volume: (B, C, D, Hv, Wv) regularized cost volume.
      src_exts (B, V, 4, 4), src_ints (B, V, 3, 3) at full resolution.

    Returns EncodedSamples, float32.
    """
    B, V, H0, W0, _ = src_images.shape
    _, H, W, S = samples.z_vals.shape
    bsq = rb.member_off.shape[1]
    b_size = int(round(bsq**0.5))
    Hf, Wf = pyramid[0].shape[-2:]

    vox_feat = fetch_vox(feat_volume, samples)

    z = samples.z_metric[:, None]  # (B, 1, H, W, S)
    bundle_d = rb.bundle_d  # (B, H, W, 3)
    bundle_xyz = rb.rays_o[:, None, None, None] + bundle_d[..., None, :] * samples.z_metric[..., None]
    src_cam_xyz = camera.invert_extrinsics(src_exts)[..., :3, 3]  # (B, V, 3)
    src_ints_scaled = camera.scale_intrinsics(src_ints, 1.0 / b_size)
    src_pix_radius = camera.pixel_radius(src_ints_scaled)  # (B, V)
    tar_diff = _l2norm(bundle_d)[:, None, :, :, None, :]  # (B, 1, H, W, 1, 3)

    R = src_exts[..., :3, :3]  # (B, V, 3, 3)
    t = src_exts[..., :3, 3]
    Rt = R.transpose(-1, -2)
    # Sphere centers in source camera coordinates: cam0 + (R d_mean) * z.
    cam0 = camera.mm(rb.rays_o[:, None, None, :], Rt)[:, :, 0] + t  # (B, V, 3)
    Rd = camera.mm(bundle_d.reshape(B, 1, H * W, 3), Rt).reshape(B, V, H, W, 1, 3)
    ccenter = cam0[:, :, None, None, None] + Rd * z[..., None]  # (B, V, H, W, S, 3)

    # Member projections: affine in the member offset,
    # img_k = K ccenter + (K R off_k) z.
    K = src_ints
    img_c = camera.mm(ccenter.reshape(B, V, -1, 3), K.transpose(-1, -2)).reshape(ccenter.shape)
    KR = camera.mm(K, R)
    KRoff = camera.mm(rb.member_off[:, None], KR.transpose(-1, -2))  # (B, V, bsq, 3)
    img = img_c[..., None, :] + KRoff[:, :, None, None, None] * z[..., None, None]
    zc = torch.clamp_min(img[..., 2], 1e-6)
    grid = torch.stack(
        [2.0 * (img[..., 0] / zc) / W0 - 1.0, 2.0 * (img[..., 1] / zc) / H0 - 1.0], dim=-1
    )  # (B, V, H, W, S, bsq, 2)
    src_nchw = src_images.reshape(B * V, H0, W0, 3).permute(0, 3, 1, 2)
    rgbs = grid_sample_2d_nchw(
        src_nchw.float(), grid.reshape(B * V, H, W, S, bsq, 2), padding_mode="border"
    ).reshape(B, V, H, W, S, bsq, 3)

    # Sphere projection radius -> fractional mip level.  ``dist`` is also
    # |bundle_xyz - cam_xyz| (rigid transforms preserve norms).
    dist = torch.linalg.vector_norm(ccenter, dim=-1)
    cimg = camera.mm(ccenter.reshape(B, V, -1, 3), src_ints_scaled.transpose(-1, -2))
    cimg = cimg.reshape(ccenter.shape)
    zc2 = torch.clamp_min(cimg[..., 2], 1e-6)
    uv = torch.stack([(cimg[..., 0] / zc2) / Wf, (cimg[..., 1] / zc2) / Hf], dim=-1)
    sec_sq = torch.square(dist / ccenter[..., 2])
    ratio = torch.square(dist / samples.ball_radii[:, None]) - 1.0
    proj_radii = sec_sq / (
        torch.sqrt(torch.clamp_min(ratio, 1e-12)) + torch.sqrt(torch.clamp_min(sec_sq - 1.0, 1e-12))
    )
    lod = torch.log2(proj_radii / src_pix_radius[..., None, None, None])
    mip_feat = mip_texture_fetch(
        pyramid, uv.reshape(B * V, -1, 2), lod.reshape(B * V, -1), max_mipmap_level
    ).reshape(B, V, H, W, S, -1)

    # Ray-difference features.  The direction keeps its own norm: near-
    # parallel rays cancel catastrophically through sqrt(2 - 2 dot).
    src_diff = (bundle_xyz[:, None] - src_cam_xyz[:, :, None, None, None]) / torch.clamp_min(
        dist, 1e-12
    )[..., None]
    direction = _l2norm(tar_diff - src_diff)
    dot = (tar_diff * src_diff).sum(-1, keepdim=True)
    ray_diff = torch.cat([direction, dot], dim=-1)
    return EncodedSamples(rgbs, mip_feat, ray_diff, vox_feat)
