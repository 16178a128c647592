"""The port's spans and counters (``gdb_nerf_tpu_torch/runtime/tracing.py``)
on the CPU.

* Off (no profiler, no ``recording()``): a forward and a training step
  record no span, make no CUDA event and count nothing.
* Inside ``recording()``: a forward of the 64x64 dtu_eval network and one
  ``Trainer.train_step`` record the layer boundaries' spans in order, with
  parents, units and host times; the loader's threads record into the same
  recording; self time is total less the children, on made-up spans and
  clocks (host and CUDA events).
* Under ``torch.profiler.profile``: the ``gdbn.*`` ranges are among the
  profiler's events, and tracing turns on and off with the session.
* The waits a backward issues are counted where the graph records their op.
* Sixteen threads switching every microsecond lose no count and no span.
"""

import itertools
import sys
import threading
import time

import numpy as np
import pytest
import torch

from gdb_nerf_tpu_torch.config import load_cfg
from gdb_nerf_tpu_torch.datasets import make_data_loader
from gdb_nerf_tpu_torch.datasets.loader import DataLoader
from gdb_nerf_tpu_torch.runtime import tracing
from gdb_nerf_tpu_torch.runtime.registry import make_network
from gdb_nerf_tpu_torch.runtime.renderer import to_device
from gdb_nerf_tpu_torch.tools import measure_common
from gdb_nerf_tpu_torch.train import losses
from gdb_nerf_tpu_torch.train.trainer import Trainer

FORWARD = (["render", "model.features"] + ["model.cost_volume", "model.cost_reg"] * 2
           + ["model.windows", "model.pyramid", "model.sample", "model.encode", "model.head",
              "model.decode"])
MODEL = FORWARD[1:]
# Input and output channels of the tiny VGG16 stand-in's ten convs.
VGG_WIDTHS = [(3, 4), (4, 4), (4, 6), (6, 6), (6, 8), (8, 8), (8, 8), (8, 8), (8, 8), (8, 8)]


class FakeEvent:
    """A CUDA event on a made-up device clock: ``record`` reads ``CLOCK``."""

    CLOCK = itertools.count()
    made = 0

    def __init__(self, enable_timing=False):
        FakeEvent.made += 1
        self.at = None

    def record(self, stream=None):
        self.at = float(next(FakeEvent.CLOCK))

    def elapsed_time(self, end):
        return end.at - self.at


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA in use, with made-up events and no-op synchronizes."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    FakeEvent.made = 0
    return FakeEvent


@pytest.fixture
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def renderer_and_batch():
    cfg = measure_common.eval_cfg("dtu_eval", ["synthetic_hw", "[64,64]", "mvs.num_depth",
                                               "[16,8]", "compute_dtype", "float32"])
    renderer = measure_common.renderer_for(cfg, "cpu", None)
    return renderer, to_device(measure_common.first_batches(cfg, 1)[0], "cpu")


@pytest.fixture
def trainer_and_loader(tmp_path, monkeypatch):
    """dtu_pretrain at 64x64, B = 1, on the synthetic loader, with a VGG16
    stand-in of the same ten convs at a few channels in the workspace."""
    rng = np.random.default_rng(0)
    (tmp_path / "weights").mkdir()
    np.savez(tmp_path / "weights" / "vgg16.npz",
             **{k: v for i, (ci, co) in enumerate(VGG_WIDTHS) for k, v in (
                 (f"conv{i}_w", rng.normal(0, 0.3, (3, 3, ci, co)).astype(np.float32)),
                 (f"conv{i}_b", rng.normal(0, 0.1, co).astype(np.float32)))})
    monkeypatch.setenv("workspace", str(tmp_path))
    losses._vgg_weights.cache_clear()
    cfg = load_cfg(f"{measure_common.REPO}/configs/dtu_pretrain.yaml",
                   ["synthetic", "True", "synthetic_hw", "[64,64]", "mvs.num_depth", "[16,8]",
                    "train.batch_size", "1", "train.num_workers", "2",
                    "workspace", str(tmp_path)])
    torch.manual_seed(0)
    trainer = Trainer(cfg, make_network(cfg, torch.float32), "cpu", use_perceptual=True)
    yield trainer, make_data_loader(cfg, is_train=True, max_iter=3)
    losses._vgg_weights.cache_clear()


def names(spans):
    return [s.name for s in spans]


@torch.no_grad()
def test_off_records_nothing_makes_no_event_and_counts_nothing(
        renderer_and_batch, trainer_and_loader, fake_cuda, few_threads):
    renderer, batch = renderer_and_batch
    trainer, loader = trainer_and_loader
    with tracing.recording() as rec:  # a recording to compare with, then tracing off
        tracing.count("bundle_head.launches")
    last = tracing.report()
    assert tracing.span("render") is tracing.span("train.step")  # the shared no-op
    assert tracing.host_wait("stats", "cuda") is tracing.span("x")
    renderer.render(batch)
    batches = iter(loader)
    with torch.enable_grad():
        trainer.train_step(next(batches))
    tracing.count("bundle_head.launches")
    for _ in batches:
        pass
    assert fake_cuda.made == 0
    assert rec.recording is tracing._last and not rec.recording.live
    assert tracing.report() == last
    assert last["counters"] == {"bundle_head.launches": 1} and last["spans"] == {}


@torch.no_grad()
def test_a_forward_records_its_stages_in_order(renderer_and_batch, few_threads):
    renderer, batch = renderer_and_batch
    with tracing.recording() as rec:
        renderer.render(batch)
        renderer.render(batch)
    spans = rec.spans
    assert names(spans) == FORWARD * 2
    roots = [s for s in spans if s.parent is None]
    assert names(roots) == ["render", "render"]
    assert [s.unit for s in spans] == [roots[0].unit] * len(FORWARD) + [roots[1].unit] * len(
        FORWARD)
    assert roots[1].unit == roots[0].unit + 1
    for s in spans:
        assert s.parent is None or s.parent.name == "render"
        assert s.thread == threading.get_ident() and s.t1 >= s.t0 and s.events is None
        if s.parent is not None:
            assert s.parent.t0 <= s.t0 <= s.t1 <= s.parent.t1
    report = tracing.report()
    assert report["roots"] == 2 and report["counters"] == {}
    assert report["spans"]["render"]["n"] == 2 and report["spans"]["model.cost_reg"]["n"] == 4
    host = report["spans"]["render"]
    inside = sum(report["spans"][n]["host_ms"] for n in set(MODEL))
    assert host["host_self_ms"] == pytest.approx(host["host_ms"] - inside)
    assert all(row["device_ms"] is None for row in report["spans"].values())


def test_a_training_step_records_its_phases_in_order(trainer_and_loader, few_threads):
    trainer, loader = trainer_and_loader
    with tracing.recording() as rec:
        batches = iter(loader)
        batch = next(batches)
        stats = trainer.train_step(batch)
        for _ in batches:
            pass
    main = [s for s in rec.spans if s.thread == threading.get_ident()]
    step = [s for s in main if not s.name.startswith("loader.")]
    top = [s.name for s in step if s.parent is not None and s.parent.name == "train.step"]
    assert top == ["train.h2d", "train.zero_grad", "train.forward", "train.loss",
                   "train.backward", "train.update", "train.readback"]
    (root,) = [s for s in step if s.parent is None]
    assert root.name == "train.step" and {s.unit for s in step} == {root.unit}

    def under(name):
        return [s.name for s in step if s.parent is not None and s.parent.name == name]

    n_copies = 6 + 1 + len(batch["tar_gt_ms"]["rgb"]) + 2 * len(batch["tar_gt_ms"]["depth"])
    assert under("train.h2d") == ["sync.to_device_train"] * n_copies
    forward = under("train.forward")
    assert [n for n in forward if n.startswith("model.")] == MODEL
    loss_waits = under("train.loss")
    # two photometric losses (the image and the coarse stage's render): five
    # SSIM windows, the VGG constants and ten convs' weights for each image
    assert loss_waits == (["sync.ssim_window"] * 5 + ["sync.vgg_norm"]
                          + ["sync.vgg_weights"] * 20) * 2
    assert under("train.readback") == ["sync.stats"] * len(stats)
    assert all(under(n) == [] for n in ("train.zero_grad", "train.backward", "train.update"))
    # The loader: the consumer's waits on this thread, every batch loaded on
    # the producer's thread, each its own root.
    waits = [s for s in main if s.name == "loader.wait"]
    loads = [s for s in rec.spans if s.name == "loader.batch"]
    assert len(waits) == 4 and len(loads) == 3  # the last wait takes the loader's end
    assert all(s.parent is None and s.thread != threading.get_ident() for s in loads)
    assert len({s.unit for s in waits + loads + [root]}) == 8
    report = tracing.report()
    assert report["counters"] == {}  # no wait on a CUDA device
    assert report["spans"]["train.step"]["n"] == 1
    row = report["spans"]["train.loss"]
    assert row["host_self_ms"] == pytest.approx(
        row["host_ms"] - sum(report["spans"][n]["host_ms"]
                             for n in ("sync.ssim_window", "sync.vgg_norm", "sync.vgg_weights")))


def test_a_backwards_waits_are_counted_where_the_graph_records_them(
        renderer_and_batch, trainer_and_loader, few_threads, monkeypatch):
    """``torch.cumprod``'s backward reads a device value: each cumprod a
    training step's graph records (the head's compositing and the coarse
    stage's render) is one deferred wait; an eval forward records none.
    ``deferred_wait`` counts like ``host_wait`` and makes no span."""
    renderer, batch = renderer_and_batch
    trainer, loader = trainer_and_loader
    calls = []
    monkeypatch.setattr(tracing, "deferred_wait", lambda *args: calls.append(args))
    with torch.no_grad():
        renderer.render(batch)
    assert calls == []
    batches = iter(loader)
    trainer.train_step(next(batches))
    for _ in batches:
        pass
    assert calls == [("cumprod_backward", torch.device("cpu"))] * 2
    monkeypatch.undo()
    with tracing.recording() as rec:
        tracing.deferred_wait("d", "cuda", 2)
        tracing.deferred_wait("d", "cpu")
    assert rec.spans == [] and tracing.report()["counters"] == {"host_syncs": 2,
                                                                "host_syncs.d": 2}


def test_self_time_is_total_less_children(fake_cuda, monkeypatch):
    """Made-up clocks: the host's advances 10 ns a read, the device's 1 ms
    an event; ``b`` and ``c`` nest in ``a``, ``sync.s`` (host only) in ``b``."""
    clock = itertools.count(0, 10)
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(clock))
    with tracing.recording() as rec:
        with tracing.span("a"):
            with tracing.span("b"):
                with tracing.host_wait("s", "cuda", 3):
                    pass
            with tracing.span("c"):
                pass
        tracing.count("k", 2)
        with tracing.host_wait("s", "cpu"):
            pass
    a, b, s, c, s2 = rec.spans
    assert [x.name for x in rec.spans] == ["a", "b", "sync.s", "c", "sync.s"]
    assert (b.parent, s.parent, c.parent, s2.parent) == (a, b, a, None)
    assert s.events is None and a.events is not None
    host = {x.name: x.host_ms for x in (a, b, c)}
    report = tracing.report()
    rows = report["spans"]
    assert report["counters"] == {"host_syncs": 3, "host_syncs.s": 3, "k": 2}
    assert report["roots"] == 2
    assert rows["a"]["host_self_ms"] == pytest.approx(host["a"] - host["b"] - host["c"])
    assert rows["b"]["host_self_ms"] == pytest.approx(host["b"] - s.host_ms)
    assert rows["sync.s"]["n"] == 2 and rows["sync.s"]["device_ms"] is None
    dev = {x.name: x.events[0].elapsed_time(x.events[1]) for x in (a, b, c)}
    assert dev == {"a": 5.0, "b": 1.0, "c": 1.0}  # events a0 b0 b1 c0 c1 a1
    assert (rows["a"]["device_ms"], rows["a"]["device_self_ms"]) == (5.0, 3.0)
    assert (rows["b"]["device_ms"], rows["b"]["device_self_ms"]) == (1.0, 1.0)


@torch.no_grad()
def test_a_profiler_session_turns_tracing_on_and_off(renderer_and_batch, few_threads):
    renderer, batch = renderer_and_batch
    acts = [torch.profiler.ProfilerActivity.CPU]
    for _ in range(2):
        before = tracing._last
        assert tracing.span("render") is tracing.span("x")  # off before the session
        with torch.profiler.profile(activities=acts) as prof:
            assert isinstance(tracing.span("x"), tracing.Span)
            renderer.render(batch)
        assert tracing.span("render") is tracing.span("x")  # off after it
        report = tracing.report()
        assert tracing._last is not before and not tracing._last.live  # a new recording
        assert report["spans"]["render"]["n"] == 1 and report["roots"] == 1
        seen = [e.name for e in prof.events() if e.name.startswith(tracing.PREFIX)]
        assert seen[0] == "gdbn.render" and sorted(set(seen)) == sorted(
            tracing.PREFIX + n for n in set(FORWARD))


def test_the_loaders_threads_follow_the_owners_recording():
    items = [{"x": np.full(2, i, np.float32)} for i in range(6)]
    loader = DataLoader(items, [[0, 1], [2, 3], [4, 5]], num_workers=2)
    with tracing.recording() as rec:
        got = [b["x"][:, 0].tolist() for b in loader]
    assert got == [[0, 1], [2, 3], [4, 5]]
    assert names(rec.spans).count("loader.batch") == 3
    assert names(rec.spans).count("loader.wait") == 4
    # Off on the owner's thread: the other threads stop recording too.
    assert tracing.span("x") is tracing.span("y")
    assert [b["x"][:, 0].tolist() for b in loader] == got
    assert tracing.report()["spans"]["loader.batch"]["n"] == 3


def test_threads_lose_no_count_and_no_span():
    """More threads than cores, switching often: every count and span lands."""
    n_threads, each = 16, 300
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording() as rec:
            def work():
                for _ in range(each):
                    tracing.count("k")
                    with tracing.span("w", False):
                        pass

            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    assert rec.counter("k") == n_threads * each
    assert len(rec.spans) == n_threads * each
    assert all(s.parent is None for s in rec.spans)
    assert len({s.unit for s in rec.spans}) == n_threads * each
