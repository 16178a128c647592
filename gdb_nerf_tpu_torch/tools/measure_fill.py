"""Adaptive-sampling fill factor of the eval forward on synthetic scenes.

The port's counterpart of ``tools/measure_fill.py``.  Adaptive sampling
gives each bundle spb = ceil(|CI| / min_interval) in [1, S] samples; the
dense masked layout (``ops/bundles.py::sample_bundles``) pays S for every
bundle whatever its spb, so the mean fill factor mean(spb) / S bounds what a
compacted sample layout could save on the encode and the bundle head.

Runs the eval forward with ``Network.debug_outputs`` and ``is_adaptive`` on,
through the ``Renderer`` (the bundle head's kernel on the card), over
``--scenes`` synthetic scenes of each config at its protocol size
(dtu_eval 512x640, llff_eval 640x960, nerf_eval 800x800), and prints one
JSON line per config: ``config``, ``S``, ``mean_spb``, ``fill_factor``,
``spb_hist`` (count of bundles by spb), ``note``, and the frame size,
dtype and weights.

    python -m gdb_nerf_tpu_torch.tools.measure_fill [--cfgs dtu_eval llff_eval nerf_eval]
        [--scenes 4] [--ckpt DIR_OR_PTH] [--dtype float32|bfloat16] [--device cuda|cpu]

Without ``--ckpt`` the weights are initialized from seed 0.  It runs on
``cuda`` and stops without a GPU; ``--device cpu`` runs the plain head on
the CPU.
"""

from __future__ import annotations

import json

import torch

from gdb_nerf_tpu_torch.runtime.renderer import to_device
from gdb_nerf_tpu_torch.tools import measure_common as common


def spb_counts(renderer, batches) -> torch.Tensor:
    """The count of bundles by spb, (S + 1,) int64 on the host, over the
    eval forward of every batch.  Raises if a bundle's spb leaves [1, S]:
    every bundle has at least one valid sample."""
    net = renderer.network
    if not net.debug_outputs:
        raise ValueError("the renderer's network must be built with debug_outputs")
    S = net.max_num_samples
    counts = torch.zeros(S + 1, dtype=torch.int64)
    for batch in batches:
        ret, _ = renderer.render(to_device(batch, renderer.device))
        spb = ret["spb"].reshape(-1)
        lo, hi = int(spb.min()), int(spb.max())
        if lo < 1 or hi > S:
            raise AssertionError(f"spb in [{lo}, {hi}], outside [1, {S}]")
        counts += torch.bincount(spb, minlength=S + 1).cpu()
    return counts


def fill_stats(config: str, counts: torch.Tensor, note: str) -> dict:
    """The JSON row of one config from its spb counts."""
    S = len(counts) - 1
    mean_spb = float((torch.arange(S + 1) * counts).sum()) / max(int(counts.sum()), 1)
    return {"config": config, "S": S, "mean_spb": mean_spb, "fill_factor": mean_spb / S,
            "spb_hist": {str(k): int(v) for k, v in enumerate(counts.tolist()) if v},
            "note": note}


def main(argv=None) -> None:
    args = common.parser(__doc__, scenes=4).parse_args(argv)
    device = common.device_of(args.device)
    state = common.load_state(args.ckpt)
    weights = args.ckpt or "initialized from seed 0"
    for name in args.cfgs:
        cfg = common.eval_cfg(name, ["compute_dtype", args.dtype, "nerf.is_adaptive", "True"])
        renderer = common.renderer_for(cfg, device, state, debug_outputs=True)
        counts = spb_counts(renderer, common.first_batches(cfg, args.scenes))
        row = fill_stats(name, counts, f"{args.scenes} synthetic scenes, weights {weights}")
        print(json.dumps({**row, "hw": list(cfg.synthetic_hw), "dtype": args.dtype,
                          "device": str(device)}), flush=True)


if __name__ == "__main__":
    main()
