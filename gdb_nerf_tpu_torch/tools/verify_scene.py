"""End-to-end drive of the ops: reconstruct a textured plane from 2 views.

The port's counterpart of ``tools/verify_scene.py``.  A 32x32 target camera
and two source cameras 0.4 to either side look at a plane at z = 4 whose
color is a function of world x and y; the source images are exact renders
of it.  Through the port's ``camera``, ``cost_volume``, ``bundles``,
``render`` and ``mip``, with the raw RGB as features:

  1. a plane sweep over 32 depths in [3, 5]: the argmin of the variance
     must land within one bin of the plane, and the softmax-regressed depth
     within 0.07;
  2. bundles of 2x2 rays sampled adaptively (at most 6 samples) inside the
     regressed interval, resized to the bundle grid, and encoded (member
     RGB, mip feature from the list pyramid of the source images, a zero
     voxel volume); the adaptive sample counts must lie in [1, 6];
  3. a density bump at the plane composited over the views' mean member
     RGB: the depth within 0.35 of the plane (the composite lands at the
     near edge of the bump: occlusion, not a fault) and the first member
     ray's RGB within 0.03 of the target view's.

The scene's size is this drive's definition.  ``run(device)`` returns the
five numbers, ``check`` holds them to the bounds.

    python -m gdb_nerf_tpu_torch.tools.verify_scene [--device cuda|cpu]

It runs on ``cuda`` and stops without a GPU; ``--device cpu`` runs it on
the CPU.  Float32 throughout, TF32 off.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from gdb_nerf_tpu_torch.ops import bundles, camera, cost_volume, mip, render
from gdb_nerf_tpu_torch.runtime.renderer import set_float32_numerics
from gdb_nerf_tpu_torch.tools import measure_common as common

H = W = 32
PLANE_Z = 4.0
NEAR, FAR = 3.0, 5.0
N_DEPTH = 32
BIN = (FAR - NEAR) / (N_DEPTH - 1)
B_SIZE = 2
MAX_SAMPLES = 6
K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
INTERIOR = np.s_[8:-8, 8:-8]  # pixels, away from the views' borders
BUNDLE_INTERIOR = np.s_[5:-5, 5:-5]  # bundles
BOUNDS = {"argmin_depth_err": BIN + 1e-3, "mvs_depth_err": 0.07, "nerf_depth_err": 0.35,
          "rgb_err": 0.03}


def cam_at(dx: float) -> np.ndarray:
    ext = np.eye(4, dtype=np.float32)
    ext[0, 3] = dx
    return ext


def plane_color(x, y):
    return np.stack([np.sin(x * 7) * 0.5 + 0.5, np.cos(y * 9) * 0.5 + 0.5,
                     np.sin(5 * x + 6 * y) * 0.5 + 0.5], -1)


def render_view(ext: np.ndarray, device) -> np.ndarray:
    """The exact (H, W, 3) render of the plane through ``ext``."""
    ro, rd, _, _ = camera.build_rays(torch.from_numpy(ext).to(device),
                                     torch.from_numpy(K).to(device), H, W)
    pts = ro.cpu().numpy() + rd.cpu().numpy() * PLANE_Z
    return plane_color(pts[..., 0], pts[..., 1]).astype(np.float32)


def run(device="cuda") -> dict:
    """The scene's reconstruction on ``device``: the interior mean errors of
    the argmin and the regressed MVS depth and of the composited depth and
    RGB, and the adaptive sample counts' (min, max)."""
    device = torch.device(device)
    set_float32_numerics(tf32=False)

    def T(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    tar_ext = cam_at(0.0)
    src_exts = np.stack([cam_at(-0.4), cam_at(0.4)])
    src_imgs = np.stack([render_view(e, device) for e in src_exts])
    gt = render_view(tar_ext, device)
    exts, ints = T(src_exts)[None], T(np.stack([K, K]))[None]
    tar, k_tar = T(tar_ext)[None], T(K)[None]

    with torch.no_grad():
        # 1) Plane sweep with the raw RGB as features.
        near_far = T([NEAR, FAR])[None, :, None, None].expand(1, 2, H, W)
        dv = cost_volume.get_depth_values(near_far, N_DEPTH, False)  # (1, D, H, W)
        feats = T(src_imgs).permute(0, 3, 1, 2)[None]  # (1, V, 3, H, W)
        vol = cost_volume.build_cost_volume(feats, exts, ints, tar, k_tar, dv, False)
        var = vol.mean(1)  # (1, D, H, W)
        best_depth = dv[0, :, 0, 0][torch.argmin(var[0], dim=0)]
        argmin_err = float((best_depth - PLANE_Z).abs()[INTERIOR].mean())
        prob = torch.softmax(-2000.0 * var, dim=1)
        depth, ci = cost_volume.depth_regression(dv, prob, 3.0, False)
        mvs_err = float((depth[0] - PLANE_Z).abs()[INTERIOR].mean())

        # 2) Bundles inside the interval, encoded from the source views.
        b = B_SIZE
        hb, wb = H // b, W // b
        rb = bundles.make_ray_bundles(tar, k_tar, (H, W), T([NEAR]), T([FAR]), b)
        # The JAX drive's jax.image.resize(..., "linear"): antialiased bilinear.
        dr = F.interpolate(ci, (hb, wb), mode="bilinear", antialias=True, align_corners=False)
        vr = T([NEAR, FAR])[None, :, None, None].expand(1, 2, hb, wb)
        smp = bundles.sample_bundles(rb, dr, vr, MAX_SAMPLES, 64, False, True)
        spb = smp.samples_per_bundle
        images = T(src_imgs)[None]  # (1, V, H, W, 3)
        pyramid = mip.build_pyramid(images[0].permute(0, 3, 1, 2), 3)
        feat_vol = torch.zeros(1, 4, N_DEPTH, H, W, device=device)  # dummy voxel features
        enc = bundles.encode_samples(rb, smp, images, pyramid, feat_vol, exts, ints, 3)

        # 3) Density peaked at the plane, composited over the views' mean RGB.
        sigma = 50.0 * torch.exp(-torch.square(smp.z_metric - PLANE_Z) * 40.0)
        weights = render.weights_from_sigma(sigma, smp.valid)
        feat = enc.rgbs.mean(1).reshape(1, hb, wb, smp.z_vals.shape[-1], -1)
        fmap, dmap, _ = render.composite(weights, feat, smp.z_vals)
        nerf_err = float((dmap[0] - PLANE_Z).abs()[BUNDLE_INTERIOR].mean())
        first_member = fmap[0].reshape(hb, wb, b * b, 3)[:, :, 0].cpu().numpy()
        rgb_err = float(np.abs(first_member - gt[0::b, 0::b])[BUNDLE_INTERIOR].mean())
        ci_width = float((dr[0, 1] - dr[0, 0])[BUNDLE_INTERIOR].mean())
    return {"argmin_depth_err": argmin_err, "mvs_depth_err": mvs_err,
            "samples_per_bundle": [float(spb.min()), float(spb.max())],
            "nerf_depth_err": nerf_err, "rgb_err": rgb_err, "ci_width": ci_width,
            "encoded": {"rgbs": list(enc.rgbs.shape), "mip_feat": list(enc.mip_feat.shape)}}


def check(result: dict) -> None:
    """The drive's five checks: each error under its bound (``BOUNDS``), the
    sample counts in [1, MAX_SAMPLES]."""
    for key, bound in BOUNDS.items():
        if not result[key] < bound:
            raise AssertionError(f"verify_scene: {key} {result[key]:.4f} >= {bound:.4f}")
    lo, hi = result["samples_per_bundle"]
    if not 1.0 <= lo <= hi <= MAX_SAMPLES:
        raise AssertionError(f"verify_scene: adaptive samples per bundle in [{lo}, {hi}]")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = run(common.device_of(args.device))
    print(f"argmin-variance depth err (interior): {r['argmin_depth_err']:.4f}  "
          f"(plane at {PLANE_Z}, bin {BIN:.3f})")
    print(f"MVS regressed depth err (interior): {r['mvs_depth_err']:.4f}")
    print("adaptive samples/bundle: min", r["samples_per_bundle"][0], "max",
          r["samples_per_bundle"][1])
    print("encoded rgbs shape:", tuple(r["encoded"]["rgbs"]), "mip feat:",
          tuple(r["encoded"]["mip_feat"]))
    print(f"composited depth err (interior): {r['nerf_depth_err']:.4f}  rgb err vs GT: "
          f"{r['rgb_err']:.4f}  mean CI width: {r['ci_width']:.3f}")
    check(r)
    print("SCENE RECONSTRUCTION OK")
    print(json.dumps({"verify_scene": {**r, "device": args.device}}))
    return r


if __name__ == "__main__":
    main()
