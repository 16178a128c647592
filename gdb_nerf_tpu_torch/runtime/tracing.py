"""Spans and counters at the port's layer boundaries.

Tracing is on while a ``torch.profiler`` session records on the calling
thread (as ``record_function`` itself is), or inside ``recording()``.
There is no other switch.  While it is off, ``span`` and ``host_wait``
return one shared no-op context and ``count`` returns at once: a flag and
the profiler's state are read, nothing is allocated, no CUDA event is made
and the profiler is not called.

While it is on, a span is
1. a ``torch.profiler.record_function`` range named ``gdbn.<name>``, on the
   profiler's clock beside the device's kernels and copies, so that an
   exported chrome trace shows each idle gap under the span the host was
   in; and
2. a record in memory (``Span``): its name, thread, parent span, unit (the
   sequence number of its root span: a request or a training step), host
   start and end (``time.perf_counter_ns``) and, for a span of device work
   once CUDA is in use, two timing CUDA events recorded on the current
   stream at entry and exit.  Host-only spans (``host_wait``, the loader's)
   take no events.

``count(name, n)`` adds to a counter of the recording.

A recording runs from the time tracing turns on until it turns off; a new
one replaces the last.  The thread whose profiler (or ``recording()``)
turned tracing on owns it; other threads, such as the loader's, record
into it while it lasts, and it ends when its owner next finds tracing off.
``report()`` resolves the last recording (one device synchronize) into
time by span name and the counters' totals.  Nothing is written out.

Spans (``PERF.md`` names the metric that reads each): ``render`` (a
request's root), ``model.features``, ``model.cost_volume``,
``model.cost_reg``, ``model.windows``, ``model.pyramid``, ``model.sample``,
``model.encode``, ``model.head``, ``model.decode``; ``train.step`` (a
step's root), ``train.h2d``, ``train.zero_grad``, ``train.forward``,
``train.loss``, ``train.backward``, ``train.update``, ``train.readback``;
``sync.<site>`` for each blocking host wait; ``loader.wait`` and
``loader.batch``.  Counters: ``host_syncs`` and ``host_syncs.<site>``
(waits on a CUDA device, also those a backward issues:
``deferred_wait``), ``bundle_head.launches``.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time

import torch

PREFIX = "gdbn."  # the profiler's name of a span is PREFIX + its name
HOST_SYNCS = "host_syncs"

_OFF = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled  # the profiler's state on this thread
_forced = 0  # depth of the open ``recording()`` blocks
_last: "Recording | None" = None  # the last recording; live while tracing is on


class Span:
    """One span of a recording; also the context manager that times it."""

    __slots__ = ("rec", "name", "device", "thread", "parent", "unit", "t0", "t1", "events",
                 "_range")

    def __init__(self, rec: "Recording", name: str, device: bool):
        self.rec, self.name, self.device = rec, name, device
        self.parent = self.unit = self.t0 = self.t1 = self.events = None

    def __enter__(self) -> "Span":
        rec = self.rec
        stack = rec.stack()
        self.thread = threading.get_ident()
        self.parent = stack[-1] if stack else None
        self.unit = self.parent.unit if self.parent is not None else next(rec.units)
        self._range = torch.profiler.record_function(PREFIX + self.name)
        self._range.__enter__()
        if self.device and torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        stack.append(self)
        rec.spans.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self._range.__exit__(*exc)
        stack = self.rec.stack()
        if stack and stack[-1] is self:
            stack.pop()
        return False

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) * 1e-6


class Recording:
    """The spans and counters recorded while tracing was on."""

    def __init__(self):
        self.owner = threading.get_ident()
        self.live = True
        self.spans: list[Span] = []  # in the order they were entered
        self.counters: dict[str, int] = {}
        self.units = itertools.count()  # the next root's unit
        self._local = threading.local()  # each thread's stack of open spans
        self._lock = threading.Lock()
        self._report = None

    def stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def report(self) -> dict:
        """Time by span name and the counters' totals (see ``report``)."""
        if self._report is not None and not self.live:
            return self._report
        done = [s for s in self.spans if s.t1 is not None]
        if any(s.events is not None for s in done):
            torch.cuda.synchronize()
        device = {id(s): s.events[0].elapsed_time(s.events[1]) for s in done
                  if s.events is not None}
        child_host, child_device = {}, {}
        for s in done:
            p = s.parent
            if p is None:
                continue
            child_host[id(p)] = child_host.get(id(p), 0.0) + s.host_ms
            if id(s) in device:
                child_device[id(p)] = child_device.get(id(p), 0.0) + device[id(s)]
        spans = {}
        for s in done:
            row = spans.setdefault(s.name, {"n": 0, "host_ms": 0.0, "host_self_ms": 0.0,
                                            "device_ms": None, "device_self_ms": None})
            row["n"] += 1
            row["host_ms"] += s.host_ms
            row["host_self_ms"] += s.host_ms - child_host.get(id(s), 0.0)
            if id(s) in device:
                d = device[id(s)]
                row["device_ms"] = (row["device_ms"] or 0.0) + d
                row["device_self_ms"] = ((row["device_self_ms"] or 0.0) + d
                                         - child_device.get(id(s), 0.0))
        out = {"spans": spans, "counters": dict(self.counters),
               "roots": sum(s.parent is None for s in done)}
        if not self.live:
            self._report = out
        return out


def _active() -> Recording | None:
    """The recording spans go to, or None while tracing is off; starts a
    recording as tracing turns on and ends it when its owner finds it off."""
    global _last
    rec = _last
    if _forced or _profiling():
        if rec is None or not rec.live:
            rec = _last = Recording()
        return rec
    if rec is None or not rec.live:
        return None
    if rec.owner == threading.get_ident():
        rec.live = False
        return None
    return rec  # another thread's recording, which this thread follows


def span(name: str, device: bool = True):
    """A span named ``name`` around a block (see the module's docstring);
    ``device`` False for host work alone, which takes no CUDA events."""
    rec = _active()
    return _OFF if rec is None else Span(rec, name, device)


def spanned(name: str):
    """Decorator: each call of the function is a span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return traced

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    rec = _active()
    if rec is not None:
        rec.add(name, n)


def host_wait(site: str, device, n: int = 1):
    """A blocking host wait the program issues at ``site`` (a pageable copy
    to ``device``, a synchronize, a read of a device value): the host-only
    span ``sync.<site>``, and ``n`` waits counted in ``host_syncs`` and
    ``host_syncs.<site>`` when ``device`` is a CUDA device."""
    rec = _active()
    if rec is None:
        return _OFF
    _count_waits(rec, site, device, n)
    return Span(rec, "sync." + site, False)


def deferred_wait(site: str, device, n: int = 1) -> None:
    """A blocking host wait that a later call issues for the program (the
    backward of an op that reads a device value): counted as ``host_wait``
    counts, where the program makes the op; no span, since the wait
    happens elsewhere."""
    rec = _active()
    if rec is not None:
        _count_waits(rec, site, device, n)


def _count_waits(rec: Recording, site: str, device, n: int) -> None:
    if torch.device(device).type == "cuda":
        rec.add(HOST_SYNCS, n)
        rec.add(f"{HOST_SYNCS}.{site}", n)


class Block:
    """What one ``recording()`` block saw: the spans entered in it and each
    counter's increase over it."""

    def __init__(self, rec: Recording):
        self.recording = rec
        self._first = len(rec.spans)
        self._before = dict(rec.counters)

    @property
    def spans(self) -> list[Span]:
        return self.recording.spans[self._first:]

    def counter(self, name: str) -> int:
        return self.recording.counters.get(name, 0) - self._before.get(name, 0)


@contextlib.contextmanager
def recording():
    """Tracing on for the block, without a profiler; yields its ``Block``.
    The block records into a new recording, or into the one already live
    (inside a profiler session or another ``recording()``)."""
    global _forced, _last
    rec = _active()
    if rec is None:  # begun here before the flag is set, so that this thread owns it
        rec = _last = Recording()
    _forced += 1
    try:
        yield Block(rec)
    finally:
        _forced -= 1
        _active()


def report() -> dict | None:
    """The last recording (ending it if tracing is off on its owner's
    thread), resolved: ``{"spans": {name: {"n", "host_ms", "host_self_ms",
    "device_ms", "device_self_ms"}}, "counters": {name: total}, "roots": n}``.
    Self time is a span's interval less what its child spans cover; device
    times are None for a name none of whose spans took events.  None before
    any recording."""
    _active()
    return None if _last is None else _last.report()
