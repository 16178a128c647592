"""The ``render`` kind: a closed loop of ``in_flight`` requests over a pool of
``pool`` seeded scenes at ``hw`` with ``views`` source views, held in
pinned host memory.

A request copies its inputs in (``non_blocking``), runs
``Renderer.render`` (the eval forward: FPN, MVS cascade, bundle sampling,
encode, the fused head, composite, decoder) and copies its rgb back into
its slot, one pinned buffer of ``in_flight``; its latency runs from the
submit to the rgb on the host, after a sync.  The host waits for the oldest
request only when ``in_flight`` are queued.  ``warmup`` requests run before
the window; ``sample_per_slot`` requests of each slot, drawn from the seed
among the window's, are checked against the plain reference once the
window has closed.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from benchmark import check, common, trace
from benchmark.reference import precision, scenes
from benchmark.reference import weights as seeded
from benchmark.work import model

# Requests of the pool whose BatchNorm statistics a ``bn_calibrated``
# network takes (``calibrated_state``).
BN_REQUESTS = 2


class Reservoir:
    """A uniform sample of ``m`` of the units offered, drawn from the seed."""

    def __init__(self, m: int, seed: int, slot: int = 0):
        self.m, self.seen, self.items = m, 0, []
        self.rng = np.random.default_rng([seed, 0x5A3, slot])

    def offer(self, make) -> None:
        self.seen += 1
        if len(self.items) < self.m:
            self.items.append(make())
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.m:
                self.items[j] = make()


def to_device(req: dict, device) -> dict:
    return {k: ({kk: vv.to(device, non_blocking=True) for kk, vv in v.items()}
                if isinstance(v, dict) else v.to(device, non_blocking=True))
            for k, v in req.items()}


def calibrated_state(cfg: dict, state: dict, requests: list, device) -> dict:
    """``state`` with the BatchNorm statistics the reference measures on
    ``requests`` (``weights.calibrate_batchnorm``), in float32."""
    net = common.reference_network(cfg, device)
    net.load_state_dict(state, strict=True)
    with precision.float32_exact():
        out = seeded.calibrate_batchnorm(net, [to_device(r, device) for r in requests])
    del net
    common.free(device)
    common.reset_peak(device)  # the program's memory peak is what the run reports
    return out


def request_pool(mix: dict, seed: int, device: torch.device) -> tuple[list, list]:
    """The pool's requests in (pinned) host memory, and the order in which
    the loop visits them."""
    K = scenes.intrinsics(mix["hw"])
    exts = scenes.extrinsics(seed, mix["pool"])
    images = scenes.render(exts, K, mix["hw"], device).cpu()
    pin = device.type == "cuda"

    def host(t):
        t = t.contiguous()
        return t.pin_memory() if pin else t

    pool = []
    for i in range(mix["pool"]):
        req = scenes.request_inputs(images[i], exts[i], K, mix["views"])
        pool.append({k: ({kk: host(vv) for kk, vv in v.items()} if isinstance(v, dict) else host(v))
                     for k, v in req.items()})
    order = np.random.default_rng(seed).permutation(mix["pool"]).tolist()
    return pool, order


class RenderLoop:
    """The closed loop of ``in_flight`` requests (see the module's doc)."""

    def __init__(self, renderer, pool: list, order: list, in_flight: int, device):
        self.renderer, self.pool, self.order = renderer, pool, order
        self.in_flight, self.device = in_flight, device
        H, W = pool[0]["src_views"]["rgb"].shape[2:4]
        pin = device.type == "cuda"
        self.slots = [torch.empty(1, H, W, 3, pin_memory=pin) for _ in range(in_flight)]
        self.next = 0  # the pool's next request

    def run(self, seconds: float | None = None, count: int | None = None, traced: bool = False,
            keep: list | None = None) -> dict:
        """Submit until ``seconds`` have passed (or ``count`` requests), then
        drain; ``keep`` holds a Reservoir for each slot.  Returns the
        latencies, the enqueue times, the number of requests and the
        window's length."""
        queue, lat, enq = deque(), [], []
        t0 = time.perf_counter()
        t_last = t0
        i = 0
        while True:
            now = time.perf_counter()
            if (seconds is not None and now - t0 >= seconds) or (count is not None and i >= count):
                break
            if len(queue) == self.in_flight:
                t_last = self._finish(queue.popleft(), lat, traced, keep)
            scene = self.order[self.next % len(self.order)]
            self.next += 1
            t_sub = time.perf_counter()
            with trace.mark("bench.submit", traced):
                batch = to_device(self.pool[scene], self.device)
            with trace.mark("bench.render", traced):
                te = time.perf_counter()
                ret, mvs = self.renderer.render(batch)
                enq.append((time.perf_counter() - te) * 1e3)
            with trace.mark("bench.copy_back", traced):
                slot = i % self.in_flight
                self.slots[slot].copy_(ret["rgb"], non_blocking=True)
                ev = None
                if self.device.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record()
            queue.append((scene, t_sub, ev, slot, mvs))
            i += 1
        while queue:
            t_last = self._finish(queue.popleft(), lat, traced, keep)
        return {"latency_ms": lat, "enqueue_ms": enq, "n": i, "window_s": t_last - t0}

    def _finish(self, entry, lat: list, traced: bool, keep) -> float:
        scene, t_sub, ev, slot, mvs = entry
        with trace.mark("bench.wait", traced):
            if ev is not None:
                ev.synchronize()
            t_done = time.perf_counter()
        lat.append((t_done - t_sub) * 1e3)
        if keep is not None:
            out = self.slots[slot]
            keep[slot].offer(lambda: {"scene": scene, "rgb": out[0].clone(),
                                      "mvs": [d[0].clone() for d in mvs]})
        return t_done


def render_reference(cfg: dict, state: dict, pool: list, samples: list, device,
                     rounding=None) -> list:
    """The reference's rgb and MVS depths for each sampled request, its
    layers rounded by ``rounding`` (``precision.to_bf16``, ``to_fp8``)."""
    net = common.reference_network(cfg, device)
    net.load_state_dict(state, strict=True)
    net.eval()
    if rounding is not None:
        rounding(net)
    out = []
    with precision.float32_exact(), torch.no_grad():
        for s in samples:
            ret, mvs, _ = net(to_device(pool[s["scene"]], device))
            out.append({"rgb": ret["rgb"][0], "mvs": [d[0] for d in mvs]})
    del net
    return out


def run(cell, seed: int, seconds: float, traced: bool, device: torch.device,
        t_start: float, controls: bool = False) -> dict:
    from gdb_nerf_tpu_torch.runtime.renderer import Renderer

    mix, cfg = cell.mix, cell.config["cfg"]
    H, W = mix["hw"]
    dtype = getattr(torch, cell.config["dtype"])
    pool, order = request_pool(mix, seed, device)
    state = common.seeded_state(cfg, seed, device)
    reference_s = 0.0  # the reference's share of set-up, which setup_s leaves out
    if cell.config["init"] == "bn_calibrated":
        t = time.time()
        state = calibrated_state(cfg, state, pool[:BN_REQUESTS], device)
        reference_s = time.time() - t
    renderer = Renderer(common.program_network(cfg, dtype, state, device), device)
    loop = RenderLoop(renderer, pool, order, mix["in_flight"], device)
    loop.run(count=mix["warmup"])
    setup_s = time.time() - t_start - reference_s

    keep = [Reservoir(mix["sample_per_slot"], seed, s) for s in range(mix["in_flight"])]
    common.reset_peak(device)
    win = loop.run(seconds=seconds, keep=keep)
    window_peak = common.peak_bytes(device)
    summary, traced_units = None, 0
    if traced:
        with trace.profiler(device) as prof:
            with trace.mark(trace.WINDOW, True):
                traced_units = loop.run(seconds=mix["trace_seconds"], traced=True)["n"]
        summary = trace.summarize(prof)
    memory_peak = common.peak_bytes(device)
    n = len(win["latency_ms"])
    S = cfg["nerf"]["max_num_samples"]
    b = cfg["nerf"]["bundle_size"]
    obs = {
        "setup_s": setup_s, "window_s": win["window_s"],
        "count": {"frames": n, "requests": win["n"]},
        "series": {"latency_ms": win["latency_ms"], "enqueue_ms": win["enqueue_ms"]},
        "flops": n * model.forward_flops(cfg, 1, H, W, mix["views"]),
        "window_peak_bytes": window_peak, "trace": summary,
        "calls": {"bundle_head": {"n": (H // b) * (W // b) * S, "views": mix["views"],
                                  "dtype": cell.config["dtype"]}},
    }

    del loop, renderer
    common.free(device)
    samples = [s for r in keep for s in r.items]
    ref = render_reference(cfg, state, pool, samples, device)
    yard = render_reference(cfg, state, pool, samples, device, precision.to_bf16)
    prog = [{"rgb": s["rgb"].to(device), "mvs": s["mvs"]} for s in samples]
    readings = check.render_readings(list(zip(prog, ref, yard)))
    extra = {}
    if controls:
        low = render_reference(cfg, state, pool, samples, device, precision.to_fp8)
        extra["fp8"] = check.render_readings(list(zip(low, ref, yard)))
    return {"obs": obs, "readings": readings, "controls": extra, "attempted": win["n"],
            "failed": win["n"] - n, "memory_peak": memory_peak, "traced_units": traced_units}
