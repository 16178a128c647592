"""The readers of the program's spans and counters (``readers/span_ms.py``,
``readers/counter_per.py``) on a made-up report and on a real recording, and
the metric files that name them against the spans the program records."""

import fnmatch
import json
import re
import sys

import pytest

from benchmark import spec

REPORT = {
    "spans": {
        "render": {"n": 4, "host_ms": 40.0, "host_self_ms": 8.0, "device_ms": 400.0,
                   "device_self_ms": 4.0},
        "model.features": {"n": 4, "host_ms": 4.0, "host_self_ms": 4.0, "device_ms": 40.0,
                           "device_self_ms": 40.0},
        "model.encode": {"n": 8, "host_ms": 6.0, "host_self_ms": 6.0, "device_ms": 80.0,
                         "device_self_ms": 80.0},
        "sync.stats": {"n": 16, "host_ms": 2.0, "host_self_ms": 2.0, "device_ms": None,
                       "device_self_ms": None},
        "sync.vgg_weights": {"n": 160, "host_ms": 6.0, "host_self_ms": 6.0, "device_ms": None,
                             "device_self_ms": None},
    },
    "counters": {"host_syncs": 176, "bundle_head.launches": 8},
    "roots": 4,
}


def reader(name):
    return spec.load_module(spec.HERE / "readers" / f"{name}.py")


@pytest.fixture
def report(monkeypatch):
    from gdb_nerf_tpu_torch.runtime import tracing

    monkeypatch.setattr(tracing, "report", lambda: REPORT)


def test_span_ms_on_a_made_up_report(report):
    read = reader("span_ms").read
    assert read({}, ["model.features"], "device", "render") == 10.0
    assert read({}, ["model.features", "model.encode"], "device", "render") == 30.0
    assert read({}, ["render"], "host", "render") == 10.0
    assert read({}, ["sync.*"], "host", "render") == 2.0
    assert read({}, ["sync.*"], "host", "sync.vgg_weights") == 0.05
    assert read({}, ["model.head"], "host", "render") == 0  # no such span: none of its time
    # Device time needs every listed span's events, and the unit a span.
    assert read({}, ["sync.*"], "device", "render") is None
    assert read({}, ["model.head"], "device", "render") is None
    assert read({}, ["render"], "host", "train.step") is None


def test_counter_per_on_a_made_up_report(report):
    read = reader("counter_per").read
    assert read({}, "host_syncs", "render") == 44.0
    assert read({}, "bundle_head.launches", "model.encode") == 1.0
    assert read({}, "host_syncs.stats", "render") == 0
    assert read({}, "host_syncs", "train.step") is None


def test_readers_read_nothing_without_a_recording_or_a_tracing_module(monkeypatch):
    from gdb_nerf_tpu_torch.runtime import tracing

    monkeypatch.setattr(tracing, "report", lambda: None)
    assert reader("span_ms").read({}, ["render"], "host", "render") is None
    assert reader("counter_per").read({}, "host_syncs", "render") is None
    # A tree before the tracing module: the import fails, the readers say nothing.
    monkeypatch.setitem(sys.modules, "gdb_nerf_tpu_torch.runtime.tracing", None)
    assert reader("span_ms").read({}, ["render"], "host", "render") is None
    assert reader("counter_per").read({}, "host_syncs", "render") is None


def test_readers_on_a_real_recording():
    from gdb_nerf_tpu_torch.runtime import tracing

    with tracing.recording():
        for _ in range(2):
            with tracing.span("train.step"):
                with tracing.host_wait("stats", "cuda", 3):
                    pass
                tracing.count("bundle_head.launches")
    rep = tracing.report()
    host = rep["spans"]["sync.stats"]["host_ms"]
    assert reader("span_ms").read({}, ["sync.*"], "host", "train.step") == host / 2
    assert reader("span_ms").read({}, ["train.step"], "device", "train.step") is None  # CPU
    assert reader("counter_per").read({}, "host_syncs", "train.step") == 3.0
    assert reader("counter_per").read({}, "bundle_head.launches", "train.step") == 1.0


def program_spans() -> set:
    """Every span name the program's source opens, and ``sync.<site>``."""
    names = set()
    for path in (spec.ROOT / "gdb_nerf_tpu_torch").rglob("*.py"):
        text = path.read_text()
        names |= set(re.findall(r'(?:span|spanned)\("([a-z0-9_.]+)"', text))
        names |= {f"sync.{s}" for s in re.findall(r'host_wait\("([a-z0-9_]+)"', text)}
    return names


def test_metric_files_name_spans_the_program_records():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    spans = program_spans()
    readers = {"span_ms", "counter_per"}
    seen = 0
    for m in bench["per_layer"]:
        conf = json.loads((spec.HERE / "metrics" / f"{m['name']}.json").read_text())
        if conf["reader"] not in readers:
            continue
        seen += 1
        args = conf["args"]
        assert args["per"] in spans, m["name"]
        for pattern in args.get("spans", []):
            assert fnmatch.filter(spans, pattern), (m["name"], pattern)
        if conf["reader"] == "span_ms":
            assert args["clock"] in ("device", "host")
            assert m["source"] == "program_span" and m["unit"] == "ms"
        else:
            assert m["source"] == "program_counter"
    assert seen == 16
