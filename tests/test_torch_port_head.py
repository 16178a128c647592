"""The port's BundleNeRF head against the JAX head and the Pallas kernel.

``bundle_head_reference`` (the CUDA kernel's plain version) is held to
``BundleNeRF.apply`` (flax) and to ``fused_bundle_nerf(interpret=True)`` at
V in {2, 3} with N = 700 samples (not a tile multiple), f32, on the same
numpy inputs and the same weights (torch weights moved to JAX by the
repo's checkpoint converter).  A third check replays the CUDA kernel's
algorithm (packed weight offsets read from csrc/bundle_head.cu, Welford
view statistics, online view softmaxes) in torch on the packed weights.
"""

import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdb_nerf_tpu.models.nerf_head import BundleNeRF as JaxBundleNeRF
from gdb_nerf_tpu.ops.pallas.fused_nerf import fused_bundle_nerf
from gdb_nerf_tpu_torch.kernels import bundle_head
from gdb_nerf_tpu_torch.kernels.measure import bound_ms
from gdb_nerf_tpu_torch.models.nerf_head import BundleNeRF

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_checkpoint import Converter  # noqa: E402

N, P, F4, VOX, HID = 700, 31, 23, 8, 64


def make_head(rng) -> BundleNeRF:
    head = BundleNeRF(HID, 16, VOX)
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.3, p.shape).astype(np.float32)))
    return head.eval()


def jax_params(head: BundleNeRF) -> dict:
    """The torch head's weights as the flax BundleNeRF param tree."""
    c = Converter({f"nerf.{k}": v.numpy() for k, v in head.state_dict().items()})
    F = 19
    c.dense("nerf.view_fc.0", "nerf/agg/view_fc")
    c.dense_split("nerf.global_fc.0", [("nerf/agg/global_fc_pv", F, False),
                                       ("nerf/agg/global_fc_var", F, False),
                                       ("nerf/agg/global_fc_mean", F, True)])
    c.dense("nerf.agg_w_fc.0", "nerf/agg/agg_w_fc")
    c.dense("nerf.fc.0", "nerf/agg/fc")
    c.dense("nerf.lr0.0", "nerf/lr0")
    c.dense("nerf.sigma.0", "nerf/sigma")
    c.dense_split("nerf.weight.0", [("nerf/weight0_shared", HID + VOX + 16, True),
                                    ("nerf/weight0_view", F + 4, False)])
    c.dense("nerf.weight.2", "nerf/weight1")
    c.dense("nerf.feat_head.0", "nerf/feat_head")
    return c.params["nerf"]


def inputs(rng, V):
    return (rng.standard_normal((N, VOX)).astype(np.float32),
            rng.uniform(0, 1, (V, N, P)).astype(np.float32),
            rng.standard_normal((V, N, F4)).astype(np.float32))


@pytest.mark.parametrize("V", [2, 3])
@torch.no_grad()
def test_reference_matches_flax_head_and_pallas_kernel(rng, V):
    head = make_head(rng)
    vox, payload, frd = inputs(rng, V)
    sigma, feat = bundle_head.bundle_head_reference(
        head, torch.from_numpy(vox), torch.from_numpy(payload), torch.from_numpy(frd))
    params = jax_params(head)
    sj, fj = JaxBundleNeRF(hid_dim=HID, voxel_dim=VOX).apply(
        {"params": params}, jnp.asarray(vox)[None], jnp.asarray(payload)[None],
        jnp.asarray(frd)[None])
    sp, fp = fused_bundle_nerf(params, jnp.asarray(vox), jnp.asarray(payload),
                               jnp.asarray(frd), interpret=True)
    for s_ref, f_ref in ((sj[0], fj[0]), (sp, fp)):
        np.testing.assert_allclose(sigma.numpy(), np.asarray(s_ref), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(feat.numpy(), np.asarray(f_ref), rtol=1e-4, atol=1e-5)


def kernel_offsets() -> dict:
    """The ``constexpr int`` layout constants of csrc/bundle_head.cu."""
    env: dict = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);",
                                 bundle_head.SOURCE.read_text()):
        env[name] = eval(expr, {}, env)  # integer arithmetic over earlier constants
    return env


def emulate_kernel(w: torch.Tensor, vox, payload, frd):
    """csrc/bundle_head.cu's per-sample algorithm, vectorized over samples."""
    k = kernel_offsets()
    F, G, IMG, H, V = k["kF"], k["kG"], k["kImg"], k["kHid"], payload.shape[0]

    def mat(off, rows, cols):
        return w[off:off + rows * cols].reshape(rows, cols)

    def vec(off, n):
        return w[off:off + n]

    def view_feat(f):
        h = f[:, F:F + 4] @ mat(k["OFF_VIEW_W"], F, 4).T + vec(k["OFF_VIEW_B"], F)
        return f[:, :F] + torch.relu(h)

    mean = torch.zeros(frd.shape[1], F)
    m2 = torch.zeros_like(mean)
    for v in range(V):  # Welford
        x = view_feat(frd[v])
        d = x - mean
        mean = mean + d / (v + 1)
        m2 = m2 + d * (x - mean)
    shared = (vec(k["OFF_G_B"], G) + (m2 / max(V - 1, 1)) @ mat(k["OFF_GVAR_W"], G, F).T
              + mean @ mat(k["OFF_GMEAN_W"], G, F).T)
    pooled, run_max, denom = 0.0, torch.full((frd.shape[1], 1), -torch.inf), 0.0
    for v in range(V):  # online softmax
        gf = torch.relu(shared + view_feat(frd[v]) @ mat(k["OFF_GPV_W"], G, F).T)
        logit = torch.relu(gf @ vec(k["OFF_AGG_W"], G)[:, None] + vec(k["OFF_AGG_B"], 1))
        new_max = torch.maximum(run_max, logit)
        e, rescale = torch.exp(logit - new_max), torch.exp(run_max - new_max)
        denom = denom * rescale + e
        pooled = pooled * rescale + e * gf
        run_max = new_max
    img = torch.relu((pooled / denom) @ mat(k["OFF_FC_W"], IMG, G).T + vec(k["OFF_FC_B"], IMG))
    vox_img = torch.cat([vox, img], -1)
    x = torch.relu(vox_img @ mat(k["OFF_LR0_W"], H, vox_img.shape[1]).T + vec(k["OFF_LR0_B"], H))
    sigma = torch.nn.functional.softplus(x @ vec(k["OFF_SIG_W"], H) + w[k["OFF_SIG_B"]])
    extra = torch.relu(x @ mat(k["OFF_FH_W"], k["kVox"], H).T + vec(k["OFF_FH_B"], k["kVox"]))
    hs = torch.cat([x, vox_img], -1) @ mat(k["OFF_W0S_W"], H, k["kW0sIn"]).T + vec(k["OFF_W0S_B"], H)
    blended, run_max, denom = 0.0, torch.full((frd.shape[1], 1), -torch.inf), 0.0
    for v in range(V):
        h = torch.relu(hs + frd[v] @ mat(k["OFF_W0V_W"], H, k["kF4"]).T)
        logit = torch.relu(h @ vec(k["OFF_W1_W"], H)[:, None] + w[k["OFF_W1_B"]])
        new_max = torch.maximum(run_max, logit)
        e, rescale = torch.exp(logit - new_max), torch.exp(run_max - new_max)
        denom = denom * rescale + e
        blended = blended * rescale + e * payload[v]
        run_max = new_max
    return sigma, torch.cat([blended / denom, extra], -1)


@pytest.mark.parametrize("V", [2, 4])
@torch.no_grad()
def test_kernel_algorithm_on_packed_weights(rng, V):
    head = make_head(rng)
    vox, payload, frd = (torch.from_numpy(a) for a in inputs(rng, V))
    packed = head.packed_weights()
    assert packed.numel() == kernel_offsets()["kNumWeights"] == 11930
    sigma, feat = emulate_kernel(packed, vox, payload, frd)
    s_ref, f_ref = bundle_head.bundle_head_reference(head, vox, payload, frd)
    np.testing.assert_allclose(sigma.numpy(), s_ref.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(feat.numpy(), f_ref.numpy(), rtol=1e-4, atol=1e-5)


def test_work_counts_each_layer_of_the_head_once():
    """``bundle_head.work`` against a count made from the head's own layers:
    2 * in * out per sample for a layer that runs once, per view for one that
    runs on each view (view_fc, global_fc's per-view block, agg_w, weight.0's
    per-view block, weight.2) plus the payload blend.  At the dtu_eval shape
    (N = 245,760, V = 3) float32 is bound by float32 operations, bf16 by bytes."""
    head = BundleNeRF(HID, 16, VOX)
    F_, n_shared = head.feat_rgb_dim, HID + VOX + 16

    def macs(lin, cols=None):
        out, inp = lin.weight.shape
        return out * (inp if cols is None else cols)

    per_view = (macs(head.view_fc[0]) + macs(head.global_fc[0], F_) + macs(head.agg_w_fc[0])
                + macs(head.weight[0], F4) + macs(head.weight[2]) + P)
    once = (macs(head.global_fc[0], 2 * F_) + macs(head.fc[0]) + macs(head.lr0[0])
            + macs(head.sigma[0]) + macs(head.weight[0], n_shared) + macs(head.feat_head[0]))
    assert head.global_fc[0].weight.shape[1] == 3 * F_
    assert head.weight[0].weight.shape[1] == n_shared + F4
    for V in (2, 3, 4):
        assert bundle_head.work(100, V, torch.float32)[1] == 100 * 2 * (once + V * per_view)
    n = 256 * 320 * 3
    n_bytes, flops = bundle_head.work(n, 3, torch.float32)
    assert flops / n == 32642
    assert n_bytes == n * 840 + 11930 * 4
    ms, by = bound_ms(n_bytes, flops, torch.float32)
    assert by == "operations" and 0.119 < ms < 0.120
    ms, by = bound_ms(*bundle_head.work(n, 3, torch.bfloat16), torch.bfloat16)
    assert by == "bytes" and 0.030 < ms < 0.032
