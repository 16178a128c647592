"""Cuts of the grouped conv (K7g): this tree's ``csrc/plane_ops.cu`` with
one phase taken out, each built as its own library and timed in turns with
the whole kernel on one card, to show what holds the kernel.

    python -m gdb_nerf_tpu_torch.tools.cut_grouped_conv3 [--out PATH]

The cuts (``CUTS``, text edits of the source, each applied to a copy of the
package under ``build/cuts/<cut>/``):

* ``no_load``: no frame copies (the FMAs run on what shared memory holds);
* ``no_fma``: no FMAs (zeros are stored): the load and the stores;
* ``no_store``: the stores only under a condition the data never meets:
  the load and the FMAs.

At C8 512x640 float32 (``ab_plane_ops.SIZE``, ``probe_ops.inputs``) the
whole kernel is held to the plain version within 1e-5 / 1e-4; then every
version is timed with ``measure.timed_ms``, ``ITERS`` calls a turn, in the
order of ``CUTS`` and back.  It prints the card's name and power limit,
each build's registers and spills, and each version's mean and per-turn
times; the same as JSON in ``--out`` (``build/cut_grouped_conv3.json``).
It needs a GPU and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import torch

from gdb_nerf_tpu_torch.kernels import plane_ops
from gdb_nerf_tpu_torch.kernels.build import REPO
from gdb_nerf_tpu_torch.kernels.measure import timed_ms
from gdb_nerf_tpu_torch.runtime.renderer import set_float32_numerics
from gdb_nerf_tpu_torch.tools import probe_ops
from gdb_nerf_tpu_torch.tools.ab_common import PACKAGE, card_name, import_from_tree
from gdb_nerf_tpu_torch.tools.ab_plane_ops import ITERS, SIZE

_STORE = "      if (co >= c) continue;\n"
CUTS = {
    "whole": [],
    "no_load": [("  load_conv3_frame(frame, x, c, H + 2, W + 2, oy, ox, pairs);\n", "")],
    "no_fma": [("for (int j = 0; j < kGroup; ++j) acc[p][j] = fmaf(in[p + kx], wv[j], acc[p][j]);",
                "for (int j = 0; j < kGroup; ++j) {}")],
    "no_store": [(_STORE, "      if (co >= c || acc[0][0] != 1234.5f) continue;\n")],
}


def cut_source(text: str, cut: str) -> str:
    """plane_ops.cu's text with ``cut``'s edits; each anchor must occur once."""
    for old, new in CUTS[cut]:
        if text.count(old) != 1:
            raise ValueError(f"cut {cut}: {old.strip()!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    return text


def cut_kernels(cut: str, root: Path):
    """A ``PlaneOpsKernels`` of a copy of this package under ``root/cut``
    whose source carries ``cut``'s edits, built."""
    tree = root / cut
    shutil.rmtree(tree, ignore_errors=True)
    package = plane_ops.SOURCE.parents[1]
    shutil.copytree(package, tree / PACKAGE, ignore=shutil.ignore_patterns("__pycache__"))
    source = tree / PACKAGE / "csrc" / plane_ops.SOURCE.name
    source.write_text(cut_source(plane_ops.SOURCE.read_text(), cut))
    kernels = import_from_tree(tree.resolve(), "kernels.plane_ops").PlaneOpsKernels()
    kernels.load()
    return kernels


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=REPO / "build" / "cut_grouped_conv3.json",
                    help="where the results go as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the cuts are timed on the card")
    card = card_name()
    print(card)
    device = torch.device("cuda")
    set_float32_numerics(tf32=False)
    x, w = probe_ops.inputs("grouped_conv3", *SIZE, device)
    want = plane_ops.grouped_conv3_reference(x, w)
    versions, result = {}, {"card": card, "iters": ITERS, "cuts": {}}
    for cut in CUTS:
        kernels = cut_kernels(cut, REPO / "build" / "cuts")
        log = kernels.build_log.splitlines()
        at = next(i for i, line in enumerate(log) if "grouped_conv3_kernel" in line)
        build = [line.strip() for line in log[at:at + 4] if "registers" in line or "spill" in line]
        print(f"[cut] {cut}: {'; '.join(build)}")
        if cut == "whole":  # the one version that still computes the conv
            err, ok = probe_ops.agree("grouped_conv3", kernels.grouped_conv3(x, w), want)
            if not ok:
                raise AssertionError(f"cut {cut} disagrees with the plain version: {err:.3e}")
        versions[cut] = kernels
        result["cuts"][cut] = {"ptxas": build, "times": []}
    for cut in [*CUTS, *reversed(CUTS)]:
        kernels = versions[cut]
        result["cuts"][cut]["times"].append(timed_ms(lambda: kernels.grouped_conv3(x, w), device,
                                                     ITERS))
    for cut, r in result["cuts"].items():
        r["ms"] = sum(r["times"]) / len(r["times"])
        print(f"[cut] {cut}: {r['ms']:.4f} ms ({', '.join(f'{t:.4f}' for t in r['times'])})")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
