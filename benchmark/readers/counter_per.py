"""A counter of the program's last recording per unit: its total over the
number of spans named ``per`` (``span_ms.py`` says which recording that is).
Nothing where the program has no tracing module or its last recording holds
no ``per`` span; a counter the recording never counted reads 0."""

from benchmark.readers.span_ms import program_report, units


def read(obs, counter, per):
    report = program_report()
    n = units(report, per)
    return report["counters"].get(counter, 0) / n if n else None
