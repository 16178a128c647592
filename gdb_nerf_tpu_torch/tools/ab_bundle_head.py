"""The bundle-head kernel K1 (``csrc/bundle_head.cu``) against an earlier
tree's, on one card in one run.

The dtu_eval head at a 512x640 frame's size (N = 245,760 samples, V = 3),
in float32 and in bf16 (a head cast as the bf16 network casts it: sigma's
layer float32), with seeded weights (the layers' default initialization)
and inputs made on the card from a seed.  Three versions: the plain version
(``bundle_head_reference``), the earlier tree's kernel through that tree's
own ``BundleHeadKernel`` (its package imported from OTHER beside this one,
its library built into OTHER/build/kernels) and this tree's.  Both kernels
take the same weight pack.  Each kernel must agree with the plain version
(float32 within 1e-4 absolute and relative, bf16 within 0.03, the tolerances
of chip_smoke.py); then ``measure.timed_ms`` times the three, ``ITERS``
calls a turn, in turns plain, earlier, this, this, earlier, plain.

    mkdir -p build/parent
    git archive <commit> gdb_nerf_tpu_torch | tar -x -C build/parent
    python -m gdb_nerf_tpu_torch.tools.ab_bundle_head build/parent [--out PATH]

It prints both builds' ptxas lines, then per dtype each version's mean and
per-turn times, the share of the bound and the error, each line with the
card's name and power limit; the same as JSON in ``--out``
(``build/ab_bundle_head.json``).  It needs a GPU and exits non-zero without
one, or if a version disagrees with the plain one.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from gdb_nerf_tpu_torch.kernels.build import REPO
from gdb_nerf_tpu_torch.kernels.bundle_head import BundleHeadKernel, bundle_head_reference, work
from gdb_nerf_tpu_torch.kernels.measure import bound_ms, timed_ms
from gdb_nerf_tpu_torch.models.layers import cast_weights
from gdb_nerf_tpu_torch.models.nerf_head import BundleNeRF
from gdb_nerf_tpu_torch.runtime.renderer import set_float32_numerics
from gdb_nerf_tpu_torch.tools.ab_common import card_name, import_from_tree, ptxas_lines

ORDER = ("plain", "earlier", "this", "this", "earlier", "plain")
N, VIEWS = 256 * 320 * 3, 3  # bundles of a 512x640 frame x 3 samples
ITERS = 20
F32_TOL = 1e-4
BF16_ATOL = 0.03


def heads(device: torch.device) -> dict:
    """The float32 head and its bf16 cast, from one seed."""
    torch.manual_seed(0)
    f32 = BundleNeRF(64, 16, 8).to(device).eval()
    bf16 = BundleNeRF(64, 16, 8).to(device).eval()
    bf16.load_state_dict(f32.state_dict())
    cast_weights(bf16, torch.bfloat16, keep=(bf16.sigma[0],))
    return {torch.float32: f32, torch.bfloat16: bf16}


def inputs(device: torch.device) -> tuple:
    gen = torch.Generator(device=device).manual_seed(0)
    return (torch.randn(N, 8, device=device, generator=gen),
            torch.rand(VIEWS, N, 31, device=device, generator=gen),
            torch.randn(VIEWS, N, 23, device=device, generator=gen))


def agree(got, want, dtype) -> tuple[float, bool]:
    """Max abs error over sigma and feat, and whether it is within the
    dtype's tolerance."""
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    if dtype == torch.bfloat16:
        return err, err <= BF16_ATOL
    return err, all(bool(((g - w).abs() <= F32_TOL + F32_TOL * w.abs()).all())
                    for g, w in zip(got, want))


def compare(earlier, this, head, base, dtype, device: torch.device) -> dict:
    """One dtype's three versions: agreement, then the times in ``ORDER``."""
    vox, payload, frd = (t.to(dtype) for t in base)
    packed = head.packed_weights()
    fns = {"plain": lambda: bundle_head_reference(head, vox, payload, frd),
           "earlier": lambda: earlier.launch(packed, vox, payload, frd),
           "this": lambda: this.launch(packed, vox, payload, frd)}
    want = fns["plain"]()
    errors = {}
    for k in ("earlier", "this"):
        got = fns[k]()
        torch.cuda.synchronize(device)
        errors[k], ok = agree(got, want, dtype)
        if not ok:
            raise AssertionError(f"{str(dtype)[6:]}: the {k} kernel disagrees with the plain "
                                 f"version: max abs error {errors[k]:.3e}")
    times = {k: [] for k in fns}
    for k in ORDER:
        times[k].append(timed_ms(fns[k], device, ITERS))
    b_ms, by = bound_ms(*work(N, VIEWS, dtype), dtype)
    r = {"bound_ms": b_ms, "bound_by": by, "max_abs_err": errors, "times": times}
    for k, ts in times.items():
        ms = sum(ts) / len(ts)
        r[k] = {"ms": ms, "bound_share": b_ms / ms}
    return r


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path,
                    help="the root of another tree holding gdb_nerf_tpu_torch (an earlier commit's)")
    ap.add_argument("--out", type=Path, default=REPO / "build" / "ab_bundle_head.json",
                    help="where the results go as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this comparison runs on the card")
    card = card_name()
    print(card)
    device = torch.device("cuda")
    set_float32_numerics(tf32=False)
    this = BundleHeadKernel()
    this.load()
    earlier = import_from_tree(args.other.resolve(), "kernels.bundle_head").BundleHeadKernel()
    earlier.load()
    builds = {"this": ptxas_lines(this.build_log), "earlier": ptxas_lines(earlier.build_log)}
    for tag, lines in builds.items():
        for line in lines:
            print(f"[ptxas {tag}] {line}")
    result = {"card": card, "iters": ITERS, "order": ORDER, "n": N, "views": VIEWS,
              "ptxas": builds, "dtypes": {}}
    base = inputs(device)
    with torch.no_grad():  # not inference_mode: the head's pack is keyed by version counters
        for dtype, head in heads(device).items():
            r = compare(earlier, this, head, base, dtype, device)
            result["dtypes"][str(dtype)[6:]] = r
            line = (f"[ab] bundle_head {str(dtype)[6:]} N={N} V={VIEWS} ({card}): bound "
                    f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
            for k in ("plain", "earlier", "this"):
                line += (f"; {k} {r[k]['ms']:.4f} ms ({', '.join(f'{t:.4f}' for t in r['times'][k])})"
                         f", {100 * r[k]['bound_share']:.1f} % of the bound")
                if k in r["max_abs_err"]:
                    line += f", max|err| {r['max_abs_err'][k]:.3e}"
            print(line)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
