"""The port's BundleNeRF head against the JAX head and the Pallas kernel.

``bundle_head_reference`` (the CUDA kernel's plain version) is held to
``BundleNeRF.apply`` (flax) and to ``fused_bundle_nerf(interpret=True)`` at
V in {2, 3} with N = 700 samples (not a tile multiple), f32, on the same
numpy inputs and the same weights (torch weights moved to JAX by the
repo's checkpoint converter).  Then both CUDA kernels' algorithms are
replayed in torch from csrc/bundle_head.cu's own constants: the float32
kernel's (the pack restaged into padded float4 rows by the .cu's block
table, Welford view statistics, online view softmaxes), and the bf16
kernel's (the weights read back from the B-fragment order, K and N padded,
16-sample tiles, bf16 rounding where the kernel rounds) against the plain
version on the golden head cast to bf16.
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
from tests.test_torch_port_network import run_jitted

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_checkpoint import Converter  # noqa: E402

N, P, F4, VOX, HID = 700, 31, 23, 8, 64
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "dtu_eval_golden.npz")


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
    sj, fj = run_jitted(lambda p, v, pl, f: JaxBundleNeRF(hid_dim=HID, voxel_dim=VOX).apply(
        {"params": p}, v[None], pl[None], f[None]), params, jnp.asarray(vox),
        jnp.asarray(payload), jnp.asarray(frd))
    sp, fp = fused_bundle_nerf(params, jnp.asarray(vox), jnp.asarray(payload),
                               jnp.asarray(frd), interpret=True)
    for s_ref, f_ref in ((sj[0], fj[0]), (sp, fp)):
        np.testing.assert_allclose(sigma.numpy(), np.asarray(s_ref), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(feat.numpy(), np.asarray(f_ref), rtol=1e-4, atol=1e-5)


def kernel_offsets() -> dict:
    """The ``constexpr int`` constants of csrc/bundle_head.cu: widths, the
    pack's offsets, the float32 staging (S_*, LD_*) and the bf16 fragment
    layout (KT_*, NT_*, FT_*, the permuted inputs *_K_*, V_*)."""
    env: dict = {"pad4": lambda n: (n + 3) // 4 * 4}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);",
                                 bundle_head.SOURCE.read_text()):
        env[name] = eval(expr, {}, env)  # integer arithmetic over earlier constants
    return env


def kernel_blocks(table: str) -> list[tuple[int, int, int, int, int]]:
    """The (src, rows, cols, dst, ld) rows of a ``Block`` table of the .cu
    file (``kF32Blocks``: the float32 staging; ``kVecBlocks``: the bf16
    kernel's float32 vectors)."""
    k = kernel_offsets()
    text = bundle_head.SOURCE.read_text()
    body = text[text.index(f"Block {table}["):]
    body = body[:body.index("};")]
    rows = [tuple(eval(f, {}, k) for f in m) for m in
            re.findall(r"\{(OFF_\w+), ([^,]+), ([^,]+), ((?:S|V)_\w+), ([^}]+)\}", body)]
    assert len(rows) == k["kNumF32Blocks" if table == "kF32Blocks" else "kNumVecBlocks"]
    return rows


def stage(w: torch.Tensor, table: str, size: int) -> torch.Tensor:
    """The pack restaged as the kernel's ``stage_blocks`` does: each block's
    rows padded to its ld with zeros; every shared float written at most once."""
    out = torch.zeros(size)
    written = torch.zeros(size, dtype=torch.int32)
    for src, rows, cols, dst, ld in kernel_blocks(table):
        view = out[dst:dst + rows * ld].view(rows, ld)
        view[:, :cols] = w[src:src + rows * cols].view(rows, cols)
        written[dst:dst + rows * ld] += 1
        assert dst % 4 == 0 and ld % 4 == 0, "rows start on 16 bytes"
    assert int(written.max()) == 1
    return out


def emulate_kernel(w: torch.Tensor, vox, payload, frd):
    """csrc/bundle_head.cu's float32 per-sample algorithm, vectorized over
    samples, reading every weight from the padded staging (S_*, LD_*)."""
    k = kernel_offsets()
    F, G, IMG, H, VOX, V = k["kF"], k["kG"], k["kImg"], k["kHid"], k["kVox"], payload.shape[0]
    sw = stage(w, "kF32Blocks", k["kStagedF32"])

    def mat(name, rows, cols, col0=0):
        ld = k[f"LD_{name}"]
        return sw[k[f"S_{name}_W"]:k[f"S_{name}_W"] + rows * ld].view(rows, ld)[:, col0:col0 + cols]

    def vec(off, n):
        return sw[off:off + n]

    def view_feat(f):
        h = f[:, F:F + 4] @ mat("VIEW", F, 4).T + vec(k["S_VIEW_B"], F)
        return f[:, :F] + torch.relu(h)

    mean = torch.zeros(frd.shape[1], F)
    m2 = torch.zeros_like(mean)
    for v in range(V):  # Welford
        x = view_feat(frd[v])
        d = x - mean
        mean = mean + d / (v + 1)
        m2 = m2 + d * (x - mean)
    k["LD_GVAR"] = k["LD_GMEAN"] = k["LD_GPV"] = k["LD_G"]
    shared = (vec(k["S_G_B"], G) + (m2 / max(V - 1, 1)) @ mat("GVAR", G, F).T
              + mean @ mat("GMEAN", G, F).T)
    pooled, run_max, denom = 0.0, torch.full((frd.shape[1], 1), -torch.inf), 0.0
    for v in range(V):  # online softmax
        gf = torch.relu(shared + view_feat(frd[v]) @ mat("GPV", G, F).T)
        logit = torch.relu(gf @ vec(k["S_AGG_W"], G)[:, None] + vec(k["S_AGG_B"], 1))
        new_max = torch.maximum(run_max, logit)
        e, rescale = torch.exp(logit - new_max), torch.exp(run_max - new_max)
        denom = denom * rescale + e
        pooled = pooled * rescale + e * gf
        run_max = new_max
    img = torch.relu((pooled / denom) @ mat("FC", IMG, G).T + vec(k["S_FC_B"], IMG))
    x = torch.relu(vox @ mat("LR0", H, VOX).T + img @ mat("LR0", H, IMG, VOX).T
                   + vec(k["S_LR0_B"], H))
    sigma = torch.nn.functional.softplus(x @ vec(k["S_SIG_W"], H) + sw[k["S_SIG_B"]])
    extra = torch.relu(x @ mat("FH", VOX, H).T + vec(k["S_FH_B"], VOX))
    hs = (x @ mat("W0S", H, H).T + vox @ mat("W0S", H, VOX, H).T
          + img @ mat("W0S", H, IMG, H + VOX).T + vec(k["S_W0S_B"], H))
    blended, run_max, denom = 0.0, torch.full((frd.shape[1], 1), -torch.inf), 0.0
    for v in range(V):
        h = torch.relu(hs + frd[v] @ mat("W0V", H, k["kF4"]).T)
        logit = torch.relu(h @ vec(k["S_W1_W"], H)[:, None] + sw[k["S_W1_B"]])
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


# The tensor-core layers of the bf16 kernel: (fragment base, K tiles, N tiles,
# the pack block's offset, its rows and columns, and the pack column that
# each padded input k reads, or None for a zero).
def bf16_layers(k: dict) -> dict:
    F, F4, G, IMG, H, VOX = k["kF"], k["kF4"], k["kG"], k["kImg"], k["kHid"], k["kVox"]

    def lr0_col(i):
        if k["LR0_K_IMG"] <= i < k["LR0_K_IMG"] + IMG:
            return VOX + i - k["LR0_K_IMG"]
        if k["LR0_K_VOX"] <= i < k["LR0_K_VOX"] + VOX:
            return i - k["LR0_K_VOX"]
        return None

    def w0s_col(i):
        if k["W0S_K_X"] <= i < k["W0S_K_X"] + H:
            return i - k["W0S_K_X"]
        if k["W0S_K_IMG"] <= i < k["W0S_K_IMG"] + IMG:
            return H + VOX + i - k["W0S_K_IMG"]
        if k["W0S_K_VOX"] <= i < k["W0S_K_VOX"] + VOX:
            return H + i - k["W0S_K_VOX"]
        return None

    def first(n):
        return lambda i: i if i < n else None

    return {  # name: (FT, KT, NT, pack offset, rows, cols, column of k)
        "VIEW": ("FT_VIEW", "KT_VIEW", "NT_VIEW", "OFF_VIEW_W", F, 4, first(4)),
        "GPV": ("FT_GPV", "KT_G", "NT_G", "OFF_GPV_W", G, F, first(F)),
        "GVAR": ("FT_GVAR", "KT_G", "NT_G", "OFF_GVAR_W", G, F, first(F)),
        "GMEAN": ("FT_GMEAN", "KT_G", "NT_G", "OFF_GMEAN_W", G, F, first(F)),
        "FC": ("FT_FC", "KT_FC", "NT_FC", "OFF_FC_W", IMG, G, first(G)),
        "LR0": ("FT_LR0", "KT_LR0", "NT_LR0", "OFF_LR0_W", H, VOX + IMG, lr0_col),
        "FH": ("FT_FH", "KT_FH", "NT_FH", "OFF_FH_W", VOX, H, first(H)),
        "W0S": ("FT_W0S", "KT_W0S", "NT_W0S", "OFF_W0S_W", H, H + VOX + IMG, w0s_col),
        "W0V": ("FT_W0V", "KT_W0V", "NT_W0V", "OFF_W0V_W", H, F4, first(F4)),
    }


def bf16_fragments(w: torch.Tensor) -> dict:
    """Each tensor-core layer's padded (N, K) weight, read back from the B
    fragments as ``stage_fragments`` lays them out: fragment FT + nt * KT +
    kt, lane (g, t), register r holds k = 16 kt + 2t + 8r (and k + 1) of
    n = 8 nt + g.  Every fragment slot is written once and every padded
    (n, k) read once."""
    k = kernel_offsets()
    frags = torch.full((k["kNumFrags"], 32, 2, 2), float("nan"))
    out = {}
    for name, (ft, kt_, nt_, off, rows, cols, col) in bf16_layers(k).items():
        FT, KT, NT = k[ft], k[kt_], k[nt_]
        wl = w[k[off]:k[off] + rows * cols].view(rows, cols)
        dense = torch.zeros(NT * 8, KT * 16)
        for n in range(NT * 8):
            for i in range(KT * 16):
                c = col(i)
                if n < rows and c is not None:
                    dense[n, i] = wl[n, c]
        padded = torch.full_like(dense, float("nan"))
        for nt in range(NT):
            for kt in range(KT):
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    for r in range(2):
                        kk = kt * 16 + 2 * t + 8 * r
                        assert frags[FT + nt * KT + kt, lane, r].isnan().all()
                        frags[FT + nt * KT + kt, lane, r] = dense[nt * 8 + g, kk:kk + 2]
                        assert padded[nt * 8 + g, kk:kk + 2].isnan().all()
                        padded[nt * 8 + g, kk:kk + 2] = frags[FT + nt * KT + kt, lane, r]
        assert not padded.isnan().any()
        out[name] = padded.to(torch.bfloat16).float()  # the kernel's bf16 fragments
    assert not frags.isnan().any()
    return out


def emulate_bf16_kernel(w: torch.Tensor, vox, payload, frd):
    """csrc/bundle_head.cu's bf16 algorithm: 16-sample tiles (the ragged tail
    padded), K and N padded as the fragments are, bf16 products summed in
    float32, and a bf16 rounding wherever the kernel rounds."""
    k = kernel_offsets()
    F, G, IMG, H, V, T = k["kF"], k["kG"], k["kImg"], k["kHid"], payload.shape[0], k["kTile"]
    Wt = bf16_fragments(w)
    sv = stage(w, "kVecBlocks", k["kNumVec"])
    N = vox.shape[0]
    pad = (-N) % T

    def r(x):
        return x.to(torch.bfloat16).float()

    def tiles(x):  # (..., N, C) -> (..., N + pad, C): whole 16-sample tiles
        return torch.nn.functional.pad(x.float(), (0, 0, 0, pad))

    def kpad(x, K):
        return torch.nn.functional.pad(x, (0, K - x.shape[-1]))

    def vec(name, n):
        return sv[k[name]:k[name] + n]

    vox, payload, frd = tiles(vox), tiles(payload), tiles(frd)

    def view_feat(f):
        h = r(kpad(f[:, F:F + 4], 16) @ Wt["VIEW"].T + vec("V_VIEW_B", 8 * k["NT_VIEW"]))
        return r(f[:, :F] + torch.relu(h[:, :F]))

    mean = torch.zeros(frd.shape[1], F)
    m2 = torch.zeros_like(mean)
    for v in range(V):
        x = view_feat(frd[v])
        d = x - mean
        mean = mean + d * (1.0 / (v + 1))
        m2 = m2 + d * (x - mean)
    var_b, mean_b = r(m2 * (1.0 / max(V - 1, 1))), r(mean)
    shared = r(r(kpad(var_b, 32) @ Wt["GVAR"].T)
               + r(kpad(mean_b, 32) @ Wt["GMEAN"].T + vec("V_G_B", G)))
    pooled, run_max, denom = 0.0, torch.full((frd.shape[1], 1), -torch.inf), 0.0
    for v in range(V):
        gf = torch.relu(r(r(kpad(view_feat(frd[v]), 32) @ Wt["GPV"].T) + shared))
        logit = torch.relu(r(gf @ vec("V_AGG_W", G)[:, None] + sv[k["V_AGG_B"]]))
        new_max = torch.maximum(run_max, logit)
        e, rescale = torch.exp(logit - new_max), torch.exp(run_max - new_max)
        denom = denom * rescale + e
        pooled = pooled * rescale + e * gf
        run_max = new_max
    img = torch.relu(r(r(pooled * (1.0 / denom)) @ Wt["FC"].T + vec("V_FC_B", IMG)))
    a_lr0 = torch.zeros(vox.shape[0], 16 * k["KT_LR0"])
    a_lr0[:, k["LR0_K_IMG"]:k["LR0_K_IMG"] + IMG] = img
    a_lr0[:, k["LR0_K_VOX"]:k["LR0_K_VOX"] + vox.shape[1]] = vox
    x = torch.relu(r(a_lr0 @ Wt["LR0"].T + vec("V_LR0_B", H)))
    sigma = torch.nn.functional.softplus(x @ vec("V_SIG_W", H) + sv[k["V_SIG_B"]])
    extra = torch.relu(r(x @ Wt["FH"].T + vec("V_FH_B", k["kVox"])))
    a_w0s = torch.zeros(vox.shape[0], 16 * k["KT_W0S"])
    a_w0s[:, k["W0S_K_X"]:k["W0S_K_X"] + H] = x
    a_w0s[:, k["W0S_K_IMG"]:k["W0S_K_IMG"] + IMG] = img
    a_w0s[:, k["W0S_K_VOX"]:k["W0S_K_VOX"] + vox.shape[1]] = vox
    hs = r(a_w0s @ Wt["W0S"].T + vec("V_W0S_B", H))
    logits = torch.stack([
        torch.relu(r(torch.relu(r(hs + r(kpad(frd[v], 32) @ Wt["W0V"].T))) @ vec("V_W1_W", H)
                     + sv[k["V_W1_B"]]))
        for v in range(V)])
    wv = r(torch.softmax(logits, dim=0))
    blended = r(sum(r(payload[v] * wv[v][:, None]) for v in range(V)))
    return sigma[:N], torch.cat([blended, extra], -1)[:N].to(torch.bfloat16)


@pytest.mark.parametrize("V", [2, 3, 4])
@torch.no_grad()
def test_bf16_kernel_algorithm_on_a_bf16_head(rng, V):
    """The bf16 kernel's tiles, padding and rounding points replayed on the
    CPU against the plain version, on the golden fixture's head cast as the
    bf16 network casts it (sigma float32; chip_smoke.py's phase 2 uses the
    same head), within chip_smoke.BF16_ATOL; the error is printed.  Rounding
    where the plain version rounds leaves fewer elements of feat off it than
    float32 sums rounded once at the end (the float32 algorithm on bf16
    values)."""
    from chip_smoke import BF16_ATOL
    from gdb_nerf_tpu_torch.models.layers import cast_weights

    g = np.load(GOLDEN)
    head = BundleNeRF(HID, 16, VOX).eval()
    head.load_state_dict({k[len("sd/nerf."):]: torch.from_numpy(np.array(g[k]))
                          for k in g.files if k.startswith("sd/nerf.")})
    cast_weights(head, torch.bfloat16, keep=(head.sigma[0],))
    vox, payload, frd = (torch.from_numpy(a).to(torch.bfloat16) for a in inputs(rng, V))
    packed = head.packed_weights()
    sigma, feat = emulate_bf16_kernel(packed, vox, payload, frd)
    s_ref, f_ref = bundle_head.bundle_head_reference(head, vox, payload, frd)
    assert sigma.dtype == s_ref.dtype == torch.float32 and feat.dtype == f_ref.dtype
    err_s = float((sigma - s_ref).abs().max())
    err_f = float((feat.float() - f_ref.float()).abs().max())
    off = float((feat != f_ref).float().mean())
    _, f32_sums = emulate_kernel(packed, vox.float(), payload.float(), frd.float())
    off_f32 = float((f32_sums.to(torch.bfloat16) != f_ref).float().mean())
    print(f"bf16 replay V={V}: max|dsigma| {err_s:.3e}, max|dfeat| {err_f:.3e}; feat elements "
          f"off the plain version {off:.3f} (float32 sums: {off_f32:.3f})")
    assert err_s <= BF16_ATOL and err_f <= BF16_ATOL
    assert off < off_f32


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
