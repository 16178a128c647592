"""Probe kernels against an earlier tree's, on one card in one run: the
plane-conv chain K3 (``csrc/plane_conv.cu``, convchain) in float32 and bf16
and the element gather K5b (``csrc/gather.cu``, take_along).

Each case runs four versions on the same inputs, made on the card from a
seed: the plain version (``convchain_reference``, ``take_along_reference``),
the library call (cuDNN's chain: ``microbench_conv.library_fn``;
``torch.take_along_dim`` over the int64 index broadcast to (N, C)), the
earlier tree's kernel through that tree's own wrappers (its package
imported from OTHER beside this one, its libraries built into
OTHER/build/kernels) and this tree's.  Each kernel must agree with the
plain version (the chain: float32 within 1e-5 absolute and 1e-4 relative,
bf16 within ``microbench_conv.bf16_tol``; the gather bit for bit); then
``measure.timed_ms`` times the four, ``ITERS`` calls a turn, in turns
plain, library, earlier, this, this, earlier, library, plain.

Cases: K3 at the conv probe's bench size (a chain of 4 C8 3x3 convs on
512x640 planes), float32 and bf16; K5b at the gather probe's size (a bf16
table (8192, 16), N = 1,048,576 indices (N, 1)).  Float32 convs run
without TF32.

    mkdir -p build/parent
    git archive <commit> gdb_nerf_tpu_torch | tar -x -C build/parent
    python -m gdb_nerf_tpu_torch.tools.ab_probe_kernels build/parent [--out PATH]

It prints the card's name and power limit, both trees' ptxas lines for
plane_conv.cu and gather.cu, then per case each version's mean and
per-turn times, the share of the bound and the kernels' errors, each line
with the card's name and power limit; the same as JSON in ``--out``
(``build/ab_probe_kernels.json``).  It needs a GPU and exits non-zero
without one, or if a kernel disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import json
from collections.abc import Callable
from dataclasses import dataclass
from pathlib import Path

import torch

from gdb_nerf_tpu_torch.kernels import gather, plane_conv
from gdb_nerf_tpu_torch.kernels.build import REPO
from gdb_nerf_tpu_torch.kernels.measure import bound_ms, timed_ms
from gdb_nerf_tpu_torch.runtime.renderer import set_float32_numerics
from gdb_nerf_tpu_torch.tools import microbench_conv, microbench_gather
from gdb_nerf_tpu_torch.tools.ab_common import card_name, import_from_tree, ptxas_lines

ORDER = ("plain", "library", "earlier", "this", "this", "earlier", "library", "plain")
ITERS = 20
CONV_F32_ATOL, CONV_F32_RTOL = 1e-5, 1e-4
CHAIN = dict(c=8, H=512, W=640, n=4)  # microbench_conv.bench's chain


@dataclass
class Case:
    """One comparison: the kernel's name on its wrapper (``lib``: plane_conv
    or gather), its inputs, its plain version and library call, its bound
    (ms, by) and whether it must equal the plain version bit for bit."""
    label: str
    kernel: str
    lib: str
    args: tuple
    plain: Callable
    library: Callable
    bound: tuple[float, str]
    exact: bool


def cases(device: torch.device) -> list[Case]:
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        args = microbench_conv.inputs("convchain", dtype=dtype, device=device, **CHAIN)
        out.append(Case(f"K3 convchain {str(dtype)[6:]} C8 512x640 n=4", "convchain", "plane_conv",
                        args, plane_conv.convchain_reference,
                        microbench_conv.library_fn("convchain", args),
                        bound_ms(*plane_conv.work("convchain", args), dtype), exact=False))
    p = microbench_gather.PROBE
    table, idx = microbench_gather.inputs(p.rows, p.C, p.N, torch.bfloat16, device, p.idx_2d)
    out.append(Case(f"K5b take_along bf16 table ({p.rows}, {p.C}) N={p.N}", "take_along", "gather",
                    (table, idx), gather.take_along_reference,
                    microbench_gather.library_calls(table, idx)["take_along_dim"],
                    bound_ms(*gather.work("take_along", p.rows, p.C, p.N, torch.bfloat16),
                             torch.bfloat16), exact=True))
    return out


def agree(got, want, exact: bool) -> tuple[float, bool]:
    """Max abs error, and whether it is within the case's tolerance: equal
    bit for bit where ``exact``, else as ``microbench_conv.agree`` holds
    the chain."""
    if exact:
        return float((got.float() - want.float()).abs().max()), torch.equal(got, want)
    return microbench_conv.agree(got, want, CONV_F32_ATOL, CONV_F32_RTOL)


def compare(case: Case, fns: dict, device: torch.device) -> dict:
    """One case's versions: agreement of both kernels, then the times in
    ``ORDER``."""
    want = fns["plain"]()
    errors = {}
    for k in ("earlier", "this"):
        got = fns[k]()
        torch.cuda.synchronize(device)
        errors[k], ok = agree(got, want, case.exact)
        if not ok:
            raise AssertionError(f"{case.label}: the {k} kernel disagrees with the plain version: "
                                 f"max abs error {errors[k]:.3e}")
    times = {k: [] for k in fns}
    for k in ORDER:
        times[k].append(timed_ms(fns[k], device, ITERS))
    b_ms, by = case.bound
    r = {"kernel": case.kernel, "bound_ms": b_ms, "bound_by": by, "max_abs_err": errors, "times": times}
    for k, ts in times.items():
        ms = sum(ts) / len(ts)
        r[k] = {"ms": ms, "bound_share": b_ms / ms}
    return r


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path,
                    help="the root of another tree holding gdb_nerf_tpu_torch (an earlier commit's)")
    ap.add_argument("--out", type=Path, default=REPO / "build" / "ab_probe_kernels.json",
                    help="where the results go as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this comparison runs on the card")
    card = card_name()
    print(card)
    device = torch.device("cuda")
    set_float32_numerics(tf32=False)
    other = args.other.resolve()
    wrappers = {
        "plane_conv": {"this": plane_conv.PlaneConvKernels(),
                       "earlier": import_from_tree(other, "kernels.plane_conv").PlaneConvKernels()},
        "gather": {"this": gather.GatherKernels(),
                   "earlier": import_from_tree(other, "kernels.gather").GatherKernels()},
    }
    builds = {}
    for lib, versions in wrappers.items():
        for tag, w in versions.items():
            w.load()
            builds[f"{lib} {tag}"] = ptxas_lines(w.build_log)
            for line in builds[f"{lib} {tag}"]:
                print(f"[ptxas {lib} {tag}] {line}")
    result = {"card": card, "iters": ITERS, "order": ORDER, "ptxas": builds, "cases": {}}
    with torch.no_grad():
        for case in cases(device):
            earlier, this = (getattr(wrappers[case.lib][k], case.kernel) for k in ("earlier", "this"))
            fns = {"plain": lambda: case.plain(*case.args), "library": case.library,
                   "earlier": lambda: earlier(*case.args), "this": lambda: this(*case.args)}
            r = compare(case, fns, device)
            result["cases"][case.label] = r
            line = f"[ab] {case.label} ({card}): bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
            for k in ("plain", "library", "earlier", "this"):
                line += (f"; {k} {r[k]['ms']:.4f} ms ({', '.join(f'{t:.4f}' for t in r['times'][k])})"
                         f", {100 * r[k]['bound_share']:.1f} % of the bound")
                if k in r["max_abs_err"]:
                    line += f", max|err| {r['max_abs_err'][k]:.3e}"
            print(line, flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
