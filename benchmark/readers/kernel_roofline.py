"""A hand-written kernel's share of its roofline, %: the least time its
traced calls could take (the larger of bytes over the memory rate and
operations over the peak, ``work/peaks.py``) over the device time the trace
gives those calls.  The calls' shape comes from the run (``calls``), the
kernel's names from the metric's file.  Nothing where no call was traced."""

import importlib

from benchmark.work import peaks


def read(obs, kernels, work):
    t, call = obs.get("trace"), obs.get("calls", {}).get(work)
    if not t or not call:
        return None
    count, seconds = 0, 0.0
    for name, (n, s) in t["kernels"].items():
        if any(k in name for k in kernels):
            count, seconds = count + n, seconds + s
    if not count or seconds <= 0:
        return None
    n_bytes, ops = importlib.import_module(f"benchmark.work.{work}").work(
        call["n"], call["views"], call["dtype"])
    return 100.0 * count * peaks.bound_s(n_bytes, ops, call["dtype"]) / seconds
