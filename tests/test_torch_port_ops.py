"""Parity of the PyTorch port's ops against the JAX package's ops.

The same numpy inputs (from a seed) go through the JAX function on the CPU
and its counterpart in ``gdb_nerf_tpu_torch.ops``.  Float32; tolerance
atol 1e-5 / rtol 1e-4 unless a test states another with its reason.
JAX functions are per-element, so they run on element 0 of a batch of 1
(or under jax.vmap).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdb_nerf_tpu.ops import bundles as jbundles
from gdb_nerf_tpu.ops import camera as jcamera
from gdb_nerf_tpu.ops import cost_volume as jcv
from gdb_nerf_tpu.ops import grid_sample as jgs
from gdb_nerf_tpu.ops import mip as jmip
from gdb_nerf_tpu.ops import render as jrender
from gdb_nerf_tpu.ops import resize as jresize
from gdb_nerf_tpu_torch.ops import bundles, camera, cost_volume, grid_sample, mip, render, resize

ATOL, RTOL = 1e-5, 1e-4


def assert_no_reference_flags():
    """The JAX reference must run its default paths: no GDBN_* switches."""
    flags = sorted(k for k in os.environ if k.startswith("GDBN_"))
    assert not flags, f"GDBN_* variables change the JAX reference: {flags}"


@pytest.fixture(autouse=True)
def _reference_defaults():
    assert_no_reference_flags()


def close(t, j, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(
        np.asarray(t.detach().float().numpy() if isinstance(t, torch.Tensor) else t),
        np.asarray(j), atol=atol, rtol=rtol,
    )


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def make_scene(rng, V=3, H=32, W=48):
    """A small posed multi-view rig (numpy, float32): V source cameras and a
    target camera looking at a scene between depth 2 and 6."""
    K = np.array([[1.2 * W, 0, W / 2], [0, 1.2 * W, H / 2], [0, 0, 1]], np.float32)
    exts = []
    for v in range(V + 1):
        ang = 0.12 * (v - V / 2.0)
        c, s = np.cos(ang), np.sin(ang)
        E = np.eye(4, dtype=np.float32)
        E[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        E[:3, 3] = [0.25 * (v - V / 2.0), 0.05 * v, 0.1 * v]
        exts.append(E)
    return {
        "src_views": {
            "rgb": rng.uniform(size=(1, V, H, W, 3)).astype(np.float32),
            "extrinsics": np.stack(exts[:V])[None],
            "intrinsics": np.stack([K] * V)[None],
        },
        "tar_views": {"extrinsics": exts[V][None], "intrinsics": K[None]},
        "near_far": np.array([[2.0, 6.0]], np.float32),
    }


# --- camera ---------------------------------------------------------------


def test_camera_inverses_and_radius(rng):
    sc = make_scene(rng)
    ext, K = sc["src_views"]["extrinsics"][0, 1], sc["src_views"]["intrinsics"][0, 1]
    K = K.copy()
    K[0, 1] = 0.3  # exercise the skew term
    close(camera.invert_extrinsics(T(ext)), jcamera.invert_extrinsics(jnp.asarray(ext)))
    close(camera.invert_intrinsics(T(K)), jcamera.invert_intrinsics(jnp.asarray(K)))
    close(camera.pixel_radius(T(K)), jcamera.pixel_radius(jnp.asarray(K)))


def test_camera_build_rays(rng):
    sc = make_scene(rng)
    ext, K = sc["tar_views"]["extrinsics"], sc["tar_views"]["intrinsics"]
    got = camera.build_rays(T(ext), T(K), 12, 20)
    want = jcamera.build_rays(jnp.asarray(ext[0]), jnp.asarray(K[0]), 12, 20)
    for g, w in zip((got[0][0], got[1][0], got[2], got[3][0]), want):
        close(g, w)


def test_camera_projections(rng):
    sc = make_scene(rng)
    se, si = sc["src_views"]["extrinsics"][0], sc["src_views"]["intrinsics"][0]
    te, ti = sc["tar_views"]["extrinsics"][0], sc["tar_views"]["intrinsics"][0]
    xyz = rng.uniform(-1, 1, (50, 3)).astype(np.float32) + np.array([0, 0, 4], np.float32)
    got = camera.project_points(T(xyz), T(se[0]), T(si[0]))
    want = jcamera.project_points(jnp.asarray(xyz), jnp.asarray(se[0]), jnp.asarray(si[0]))
    for g, w in zip(got, want):
        close(g, w, atol=1e-4)  # pixel coordinates ~50: 1e-4 px is ~2e-6 relative
    close(
        camera.plane_sweep_projection(T(se), T(si), T(te)[None], T(ti)[None]),
        jax.vmap(lambda e, k: jcamera.plane_sweep_projection(e, k, te, ti))(se, si),
        atol=1e-4,  # entries up to ~60 (focal lengths): float32 inverse rounding
    )


# --- resize / render ------------------------------------------------------


@pytest.mark.parametrize("src_hw,dst_hw", [((16, 20), (8, 10)), ((16, 20), (4, 5)),
                                           ((8, 10), (16, 20)), ((10, 12), (7, 9))])
def test_resize_bilinear(rng, src_hw, dst_hw):
    img = rng.standard_normal((*src_hw, 5)).astype(np.float32)
    close(resize.resize_bilinear(T(img), dst_hw), jresize.resize_bilinear(jnp.asarray(img), dst_hw))


def test_resize_nearest_and_pixel_shuffle(rng):
    d = rng.standard_normal((2, 9, 14)).astype(np.float32)
    close(resize.resize_nearest(T(d), (6, 5)),
          np.stack([jresize.resize_nearest(jnp.asarray(x), (6, 5)) for x in d]))
    x = rng.standard_normal((2, 3, 4, 12)).astype(np.float32)
    close(resize.pixel_shuffle(T(x), 2),
          np.stack([jresize.pixel_shuffle(jnp.asarray(t), 2) for t in x]))


def test_render_weights_and_composite(rng):
    sigma = rng.uniform(0, 3, (4, 5, 6)).astype(np.float32)
    sigma[0, 0] = 0.0  # no mass: exercises the 1e-6 floor
    valid = rng.uniform(size=(4, 5, 6)) < 0.7
    feat = rng.standard_normal((4, 5, 6, 7)).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (4, 5, 6)).astype(np.float32), axis=-1)
    w = render.weights_from_sigma(T(sigma), T(valid))
    wj = jrender.weights_from_sigma(jnp.asarray(sigma), jnp.asarray(valid))
    close(w, wj)
    for g, j in zip(render.composite(w, T(feat), T(z)),
                    jrender.composite(wj, jnp.asarray(feat), jnp.asarray(z))):
        close(g, j)


# --- grid sampling --------------------------------------------------------


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
def test_grid_sample_2d_3d(rng, padding_mode):
    img = rng.standard_normal((9, 11, 4)).astype(np.float32)
    vol = rng.standard_normal((5, 6, 7, 3)).astype(np.float32)
    g2 = rng.uniform(-1.3, 1.3, (20, 3, 2)).astype(np.float32)  # includes out-of-range
    g3 = rng.uniform(-1.3, 1.3, (30, 3)).astype(np.float32)
    close(grid_sample.grid_sample_2d(T(img)[None], T(g2)[None], padding_mode)[0],
          jgs.grid_sample_2d(jnp.asarray(img), jnp.asarray(g2), padding_mode))
    close(grid_sample.grid_sample_3d(T(vol)[None], T(g3)[None], padding_mode)[0],
          jgs.grid_sample_3d(jnp.asarray(vol), jnp.asarray(g3), padding_mode))


# --- cost volume ----------------------------------------------------------


@pytest.mark.parametrize("inv", [True, False])
def test_cost_volume_and_depth_regression(rng, inv):
    sc = make_scene(rng, V=3)
    C, Hs, Ws, Ht, Wt, D = 6, 16, 24, 8, 12, 8
    feats = rng.standard_normal((1, 3, Hs, Ws, C)).astype(np.float32)
    se, si = sc["src_views"]["extrinsics"], sc["src_views"]["intrinsics"] * np.array(
        [[0.5], [0.5], [1.0]], np.float32)
    te, ti = sc["tar_views"]["extrinsics"], sc["tar_views"]["intrinsics"] * np.array(
        [[0.25], [0.25], [1.0]], np.float32)
    nf = np.broadcast_to(np.array([2.0, 6.0], np.float32)[None, :, None, None], (1, 2, Ht, Wt))
    dv = cost_volume.get_depth_values(T(nf.copy()), D, inv)
    dvj = jcv.get_depth_values(jnp.asarray(nf[0]), D, inv)
    close(dv[0], dvj, atol=0, rtol=0)  # the same float32 arithmetic
    vol = cost_volume.build_cost_volume(
        T(feats).permute(0, 1, 4, 2, 3), T(se), T(si), T(te), T(ti), dv, inv)
    volj = jcv.build_cost_volume(jnp.asarray(feats[0]), jnp.asarray(se[0]), jnp.asarray(si[0]),
                                 jnp.asarray(te[0]), jnp.asarray(ti[0]), dvj, inv)
    close(vol[0].permute(1, 2, 3, 0), volj)
    logits = rng.standard_normal((1, D, Ht, Wt)).astype(np.float32)
    prob = torch.softmax(T(logits), dim=1)
    depth, ci = cost_volume.depth_regression(dv, prob, 1.0, inv)
    dj, cij = jcv.depth_regression(dvj, jnp.asarray(prob[0].numpy()), 1.0, inv)
    close(depth[0], dj)
    close(ci[0], cij)


# --- mip ------------------------------------------------------------------


def test_mip_pyramid_and_fetch_at_borders(rng):
    tex = rng.standard_normal((16, 24, 5)).astype(np.float32)
    levels = mip.build_pyramid(T(tex).permute(2, 0, 1)[None], 3)
    jlevels = jmip.build_pyramid(jnp.asarray(tex), 3)
    for l, jl in zip(levels, jlevels):
        close(l[0].permute(1, 2, 0), jl)
    # uv reaches past [0, 1] so both the clamp and the level blend are hit.
    uv = rng.uniform(-0.2, 1.2, (64, 2)).astype(np.float32)
    uv[:4] = [[0, 0], [1, 1], [-0.5, 1.5], [1.5, -0.5]]
    lod = rng.uniform(-0.5, 3.5, (64,)).astype(np.float32)
    got = mip.mip_texture_fetch(levels, T(uv)[None], T(lod)[None], 3)[0]
    close(got, jmip.mip_texture_fetch(jlevels, jnp.asarray(uv), jnp.asarray(lod), 3))
    packed, offs = jmip.pack_pyramid(jlevels)
    close(got, jmip.mip_texture_fetch_packed(packed, offs, (16, 24), jnp.asarray(uv),
                                             jnp.asarray(lod), 3))


# --- bundles: sampling and encoding ---------------------------------------


def _bundle_inputs(rng, H0=32, W0=48, b=2):
    sc = make_scene(rng, V=3, H=H0, W=W0)
    H, W = H0 // b, W0 // b
    near = rng.uniform(2.5, 3.5, (1, 1, H, W)).astype(np.float32)
    far = near + rng.uniform(0.05, 1.5, (1, 1, H, W)).astype(np.float32)
    depth_range = np.concatenate([near, far], axis=1)
    vol_range = np.concatenate([np.full_like(near, 2.0), np.full_like(near, 6.0)], axis=1)
    return sc, depth_range, vol_range


def _rays(sc, b=2):
    te, ti, nf = sc["tar_views"]["extrinsics"], sc["tar_views"]["intrinsics"], sc["near_far"]
    H0, W0 = sc["src_views"]["rgb"].shape[2:4]
    rb = bundles.make_ray_bundles(T(te), T(ti), (H0, W0), T(nf[:, 0]), T(nf[:, 1]), b)
    rbj = jbundles.make_ray_bundles(jnp.asarray(te[0]), jnp.asarray(ti[0]), (H0, W0),
                                    jnp.asarray(nf[0, 0]), jnp.asarray(nf[0, 1]), b)
    return rb, rbj


def test_make_ray_bundles(rng):
    sc, _, _ = _bundle_inputs(rng)
    rb, rbj = _rays(sc)
    for name in rbj._fields:
        g = getattr(rb, name)
        close(g if name == "uv" else g[0], getattr(rbj, name))


@pytest.mark.parametrize("inv,adaptive", [(False, True), (True, True), (False, False)])
def test_sample_bundles(rng, inv, adaptive):
    sc, dr, vr = _bundle_inputs(rng)
    rb, rbj = _rays(sc)
    s = bundles.sample_bundles(rb, T(dr), T(vr), 4, 16, inv, adaptive)
    sj = jbundles.sample_bundles(rbj, jnp.asarray(dr[0]), jnp.asarray(vr[0]), 4, 16, inv, adaptive)
    np.testing.assert_array_equal(s.samples_per_bundle[0].numpy(), np.asarray(sj.samples_per_bundle))
    np.testing.assert_array_equal(s.valid[0].numpy(), np.asarray(sj.valid))
    for name in ("z_vals", "z_metric", "uvd", "ball_radii"):
        close(getattr(s, name)[0], getattr(sj, name))


def test_encode_samples(rng):
    sc, dr, vr = _bundle_inputs(rng)
    rb, rbj = _rays(sc)
    s = bundles.sample_bundles(rb, T(dr), T(vr), 3, 16, False, True)
    sj = jbundles.sample_bundles(rbj, jnp.asarray(dr[0]), jnp.asarray(vr[0]), 3, 16, False, True)
    src = sc["src_views"]["rgb"]
    H, W, F, C, D = 16, 24, 7, 4, 8
    img_feat = rng.standard_normal((1, 3, H, W, F)).astype(np.float32)
    fvol = rng.standard_normal((1, D, H, W, C)).astype(np.float32)
    se, si = sc["src_views"]["extrinsics"], sc["src_views"]["intrinsics"]
    pyr = mip.build_pyramid(T(img_feat[0]).permute(0, 3, 1, 2), 3)
    enc = bundles.encode_samples(rb, s, T(src), pyr, T(fvol).permute(0, 4, 1, 2, 3), T(se), T(si), 3)
    jpacked, joffs = jax.vmap(lambda t: jmip.pack_pyramid(jmip.build_pyramid(t, 3)))(
        jnp.asarray(img_feat[0]))
    encj = jbundles.encode_samples(
        rbj, sj, jnp.asarray(src[0]), jnp.asarray(img_feat[0]), jpacked, joffs[0],
        jnp.asarray(fvol[0]), jnp.asarray(se[0]), jnp.asarray(si[0]), 3)
    close(enc.vox_feat[0], encj.vox_feat)
    close(enc.rgbs[0], encj.rgbs)
    # mip_feat / ray_diff pass through a log2 level and normalizations: 1e-4.
    close(enc.mip_feat[0], encj.mip_feat, atol=1e-4)
    close(enc.ray_diff[0], encj.ray_diff, atol=1e-4)
