"""Bytes and operations of one call of the fused bundle head (K1).

The head runs a chain of dense layers over V views on every sample and
blends the payload with a softmax over views.  Inputs read once (the 11,930
float32 weights, vox, payload and the per-view feature ++ ray difference),
outputs written once (sigma float32, the blended feature); a multiply-add
counts 2.  Per view: view_fc, the per-view column block of global_fc,
agg_w, the per-view block of weight.0, weight.2 and the payload blend.
Once per sample: global_fc's var and mean blocks, fc, lr0, sigma, the
shared block of weight.0 and feat_head.  The widths are the dtu_eval head's:
feature 16 + rgb 3, payload 3 * 2 * 2 + 19, voxel 8, hidden 64.
"""

FEAT_RGB_DIM, PAYLOAD_DIM, VOXEL_DIM, HIDDEN_DIM = 19, 31, 8, 64
N_WEIGHTS = 11930
ELEMENT_SIZE = {"float32": 4, "bfloat16": 2}


def work(n: int, views: int, dtype: str) -> tuple[int, int]:
    """(bytes, operations) of one call on ``n`` samples and ``views`` views."""
    es = ELEMENT_SIZE[dtype]
    F_, P, vox, hid, g, img = FEAT_RGB_DIM, PAYLOAD_DIM, VOXEL_DIM, HIDDEN_DIM, 32, 16
    per_view = 2 * (4 * F_ + F_ * g + g + (F_ + 4) * hid + hid + P)
    once = 2 * (2 * F_ * g + g * img + (vox + img) * hid + hid + (hid + vox + img) * hid
                + hid * vox)
    n_bytes = n * ((vox + views * (P + F_ + 4) + P + vox) * es + 4) + N_WEIGHTS * 4
    return n_bytes, n * (once + views * per_view)
