"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for.  The run builds the measured program (``gdb_nerf_tpu_torch``)
with weights and inputs made from the seed, warms up the cell's shapes,
measures for ``--seconds`` and checks what the timed path produced against
the plain reference (``reference/``).  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a traced
segment after the window.  The numbers compared, each beside its limit, end
standard error and close the result's line (``checks``).

The kernels that the program builds go to ``build/kernels/`` in the
checkout; Triton's and torch's extension caches are pointed into
``build/bench_cache/`` there.  Exit codes: 0 a result was printed (correct
or not); 2 no card, or fewer than the cell asks for; 3 a JAX module was
loaded.
"""

import time

T_START = time.time()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark import spec  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "gdb_nerf_tpu"}
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def loaded_jax() -> list:
    """Forbidden top-level module names in ``sys.modules``, compared whole:
    ``gdb_nerf_tpu_torch`` is not ``gdb_nerf_tpu``."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def execute(cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
            t_start: float | None = None, controls: bool = False) -> dict:
    """One run of ``cell`` on ``device`` -> the result's fields, every
    number the run read, and the controls' where ``controls``."""
    import torch

    from benchmark import check

    t_start = time.time() if t_start is None else t_start
    dev = torch.device(device)
    kind = spec.load_kind(cell.mix["kind"], cell.data)
    out = kind.run(cell, seed, seconds, traced, dev, t_start, controls)
    obs = out["obs"]
    obs["platform"] = "gpu" if dev.type == "cuda" else dev.type
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = spec.read_metric(cell.readers[m["name"]], obs, cell.data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, checks = check.verdict(out["readings"], cell.limits)
    device_info = {
        "platform": obs["platform"],
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": out["memory_peak"],
    }
    result = {"correct": correct and out["failed"] == 0 and out["attempted"] > 0,
              "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": device_info}
    if traced and obs["trace"] is not None:
        t = obs["trace"]
        device_info["busy_s"], device_info["window_s"] = t["busy_s"], t["window_s"]
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
        result["traced_units"] = out["traced_units"]  # requests or steps in the traced segment
    result["checks"] = checks
    return {"result": result, "readings": out["readings"], "controls": out["controls"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.load_cell(args.workload)
    cache = spec.ROOT / "build" / "bench_cache"
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(cache / sub)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell {cell.name} needs {cell.chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = loaded_jax()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}; the port must run without JAX",
              file=sys.stderr)
        return 3
    result = out["result"]
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
