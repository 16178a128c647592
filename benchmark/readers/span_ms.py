"""Milliseconds the program spent in some of its spans, per unit.

The program records spans and counters while a profiler session records
(``gdb_nerf_tpu_torch/runtime/tracing.py``); the benchmark's profiler runs
over the traced segment alone, so the program's last recording, read in the
run's process after it, is that segment.  ``spans`` lists span names or
``fnmatch`` patterns (``sync.*``) of spans that do not nest in one another;
their total ms on ``clock`` (``device``: CUDA events at the span's ends on
the stream; ``host``: the host's clock) is divided by the number of spans
named ``per`` (a request's ``render``, a step's ``train.step``).  Nothing
where the program has no tracing module (a tree before it), where its last
recording holds no ``per`` span, or, on the ``device`` clock, where a span
of the list took no device events (off the card)."""

import importlib
from fnmatch import fnmatchcase


def program_report():
    """The program's ``tracing.report()``, or None where it has none."""
    try:
        tracing = importlib.import_module("gdb_nerf_tpu_torch.runtime.tracing")
    except ImportError:
        return None
    return tracing.report()


def units(report, per):
    """The number of ``per`` spans in ``report`` (0 where there is none)."""
    return report["spans"].get(per, {}).get("n", 0) if report else 0


def read(obs, spans, clock, per):
    report = program_report()
    n = units(report, per)
    if not n:
        return None
    rows = [row for name, row in report["spans"].items()
            if any(fnmatchcase(name, p) for p in spans)]
    values = [row[f"{clock}_ms"] for row in rows]
    if clock == "device" and (not values or None in values):
        return None
    return sum(values) / n
