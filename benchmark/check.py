"""The numbers that decide ``correct``: the measured program's outputs against
the plain reference's, each held to its limit from ``checks/<cell>.json``.

Render cells (every sampled request of the window, the worst one): the
program's absolute error against the float32 reference over the
yardstick's, the reference with the inputs and weights of every weighted
layer rounded to bfloat16, the configuration's precision.  A ratio, because
a seed's weights set how far any rounding moves the output: the seeds that
read highest in the program read highest in the fp8 control too.  Read at
quantiles ``QS`` of the rgb (``rgb_q50_vs_bf16`` ...; the 90th and 99th
percentiles see a fault that touches a tenth or a hundredth of the frame)
and of the depth map of the cascade's last stage, the depth the bundles are
sampled from (``mvs_depth_q50_vs_bf16`` ...).  The cell's checks file
names the ones compared.

The training cell (its first three steps): ``loss1_rel``, ``loss2_rel``,
``loss3_rel``, each step's loss against the reference's, relative (apart,
because the first is the forward alone and the later ones carry the
optimizer's steps, which the card's unordered gradient sums move more);
``grad1_leaf_gap``, the
first gradient's norm as the optimizer got it (adam's first moment after
one step over 1 - beta1) against the reference's clipped gradient's, per
leaf, over the reference's norm of that leaf or of the median leaf,
whichever is larger, the worst leaf; ``dparam3_leaf_gap``, the same for the
parameters' change after three steps; ``feed_mismatch``, 1 where a batch
the program's loader gave differs from the one the reference rebuilt.
Leaves whose reference gradient is under a thousandth of the median leaf's
(moved by round-off alone under adam) are left out of both leaf numbers.
"""

from __future__ import annotations

import numpy as np
import torch

EXCLUDE_BELOW = 1e-3  # of the median leaf's reference gradient norm


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def quantile(t: torch.Tensor, q: float) -> float:
    v = torch.sort(t.flatten()).values
    return float(v[int(round(q * (v.numel() - 1)))])


QS = (0.5, 0.9, 0.99)


def render_readings(triples) -> dict:
    """``triples``: [(program, reference, yardstick)] of {'rgb': (H, W, 3),
    'mvs': [each stage's depth map]} tensors on one device; the yardstick is
    the reference rounded to the configuration's precision."""
    out = {}

    def worst(name, value):
        out[name] = max(out.get(name, 0.0), value)

    for p, r, y in triples:
        for key, a, b, c in (("rgb", p["rgb"], r["rgb"], y["rgb"]),
                             ("mvs_depth", p["mvs"][-1], r["mvs"][-1], y["mvs"][-1])):
            ref = b.double()
            err, yard = (a.double() - ref).abs(), (c.double() - ref).abs()
            for q in QS:
                worst(f"{key}_q{round(q * 100)}_vs_bf16",
                      quantile(err, q) / max(quantile(yard, q), 1e-30))
    return out


def leaf_gaps(prog: dict, ref: dict, keep: list) -> dict:
    """Each leaf's |norm(prog) - norm(ref)| over max(norm(ref), the median
    leaf's norm(ref))."""
    rn = {n: _norm(ref[n]) for n in keep}
    med = float(np.median(list(rn.values())))
    return {n: abs(_norm(prog[n]) - rn[n]) / max(rn[n], med, 1e-30) for n in keep}


def train_readings(prog: dict, ref: dict, p0: dict) -> tuple[dict, dict]:
    """``prog``/``ref``: {'losses': [float], 'grad1': {name: tensor}, 'p3':
    {name: tensor}}; ``p0`` the seeded parameters.  Returns the readings and
    what explains them: the leaves left out, the worst leaves, the losses."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError(f"{len(prog['losses'])} program steps against {len(ref['losses'])}")
    losses = {f"loss{k + 1}_rel": abs(a - b) / max(abs(b), 1e-30)
              for k, (a, b) in enumerate(zip(prog["losses"], ref["losses"]))}
    norms = {n: _norm(g) for n, g in ref["grad1"].items()}
    med = float(np.median(list(norms.values())))
    keep = [n for n, v in norms.items() if v >= EXCLUDE_BELOW * med]
    left_out = sorted(set(norms) - set(keep))
    d_prog = {n: prog["p3"][n] - p0[n] for n in keep}
    d_ref = {n: ref["p3"][n] - p0[n] for n in keep}
    g1 = leaf_gaps(prog["grad1"], ref["grad1"], keep)
    dp = leaf_gaps(d_prog, d_ref, keep)

    def worst(gaps):
        return sorted(gaps.items(), key=lambda x: -x[1])[:3]

    return ({**losses, "grad1_leaf_gap": max(g1.values()),
             "dparam3_leaf_gap": max(dp.values())},
            {"left_out": left_out, "worst_grad1": worst(g1), "worst_dparam3": worst(dp),
             "median_dparam3": float(np.median(list(dp.values()))),
             "losses": [prog["losses"], ref["losses"]]})


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Each number that the cell's checks file names against its limit (a
    NaN reading fails; a name the run did not read raises); returns
    (correct, {name: {'value', 'limit'}}).  Readings it does not name are
    the calibration's, and decide nothing."""
    checks, ok = {}, True
    for name, lim in limits.items():
        if name not in readings:
            raise KeyError(f"the run read no {name!r}, which this cell's checks file names")
        value = readings[name]
        checks[name] = {"value": value, "limit": lim["limit"]}
        ok = ok and bool(value <= lim["limit"])
    return ok, checks
