"""Fractional mip LOD population of the eval forward on synthetic scenes.

The port's counterpart of ``tools/measure_lod.py``.  The mip fetch
(``ops/mip.py::mip_texture_fetch``) blends two levels, floor(lod) and
floor(lod) + 1, of the source feature pyramid.  Where the lods sit decides
what a cheaper fetch may do exactly:

  * lod <= 0 everywhere         -> the upper tap has weight 0: one level-0
                                   tap is exact;
  * lod in [0, 1] everywhere    -> levels 0 and 1 only;
  * lod >= max_level anywhere   -> both taps hit the same level.

The tool wraps ``ops.bundles.mip_texture_fetch`` in its own process and
keeps each call's lod before the clamp, during the real eval forward
through the ``Renderer`` (the bundle head's kernel on the card), over
``--scenes`` synthetic scenes of each config at its protocol size.  It
prints one JSON line per config: ``config``, ``max_level``, ``n``,
``raw_min``, ``raw_max``, ``mean`` (of the clamped lods), ``frac_le_0``,
``frac_lt_1``, ``frac_ge_max``, ``frac_frac_lt_0.05``, ``hist_halves``
(the clamped lods in half-level bins, the JAX tool's keys), and the frame
size, dtype and weights.

    python -m gdb_nerf_tpu_torch.tools.measure_lod [--cfgs dtu_eval llff_eval nerf_eval]
        [--scenes 2] [--ckpt DIR_OR_PTH] [--dtype float32|bfloat16] [--device cuda|cpu]

Without ``--ckpt`` the weights are initialized from seed 0.  It runs on
``cuda`` and stops without a GPU; ``--device cpu`` runs the plain head on
the CPU.
"""

from __future__ import annotations

import contextlib
import json

import torch

from gdb_nerf_tpu_torch.ops import bundles
from gdb_nerf_tpu_torch.runtime.renderer import to_device
from gdb_nerf_tpu_torch.tools import measure_common as common


@contextlib.contextmanager
def lods_tapped():
    """Inside the block every call of ``bundles.mip_texture_fetch`` appends
    its lod, before the clamp, flattened, to the yielded list."""
    fetch, stash = bundles.mip_texture_fetch, []

    def tapped(levels, uv, lod, max_level):
        stash.append(lod.detach().reshape(-1))
        return fetch(levels, uv, lod, max_level)

    bundles.mip_texture_fetch = tapped
    try:
        yield stash
    finally:
        bundles.mip_texture_fetch = fetch


def lod_stats(lods: torch.Tensor, max_level: int) -> dict:
    """The statistics of the JAX tool on the lods before the clamp: raw
    range, the clamped mean, the shares at or under 0, under 1 (clamped), at
    or over ``max_level`` and with a clamped fraction under 0.05, and the
    clamped lods' histogram in half-level bins (the first bin is [-0.01, 0),
    the last closed on the right)."""
    lods = lods.reshape(-1).double()
    clamped = lods.clamp(0.0, float(max_level))
    frac = clamped - clamped.floor()
    edges = [-0.01] + [0.5 * i for i in range(2 * max_level + 1)]
    bins = torch.bucketize(clamped, torch.tensor(edges[1:-1], dtype=lods.dtype,
                                                 device=lods.device), right=True)
    hist = torch.bincount(bins, minlength=len(edges) - 1).tolist()
    return {
        "max_level": max_level,
        "n": lods.numel(),
        "raw_min": float(lods.min()),
        "raw_max": float(lods.max()),
        "mean": float(clamped.mean()),
        "frac_le_0": float((lods <= 0.0).double().mean()),
        "frac_lt_1": float((clamped < 1.0).double().mean()),
        "frac_ge_max": float((lods >= max_level).double().mean()),
        "frac_frac_lt_0.05": float((frac < 0.05).double().mean()),
        "hist_halves": {f"[{edges[i]:.1f},{edges[i + 1]:.1f})": hist[i]
                        for i in range(len(edges) - 1)},
    }


def measure(renderer, batches) -> dict:
    """``lod_stats`` of every mip fetch in the eval forward of ``batches``."""
    with lods_tapped() as stash:
        for batch in batches:
            renderer.render(to_device(batch, renderer.device))
    return lod_stats(torch.cat(stash), renderer.network.max_mipmap_level)


def main(argv=None) -> None:
    args = common.parser(__doc__, scenes=2).parse_args(argv)
    device = common.device_of(args.device)
    state = common.load_state(args.ckpt)
    for name in args.cfgs:
        cfg = common.eval_cfg(name, ["compute_dtype", args.dtype])
        renderer = common.renderer_for(cfg, device, state)
        stats = measure(renderer, common.first_batches(cfg, args.scenes))
        print(json.dumps({"config": name, **stats, "hw": list(cfg.synthetic_hw),
                          "dtype": args.dtype, "device": str(device),
                          "weights": args.ckpt or "initialized from seed 0"}), flush=True)


if __name__ == "__main__":
    main()
