"""The trace reduction on made-up events: busy time as a union, gaps charged
to the host label over their middle, kernels summed by name."""

from benchmark import trace


def test_union_and_gaps():
    ms = 1_000_000
    device = [("k1", 0, 2 * ms), ("k2", 1 * ms, 3 * ms), ("k1", 6 * ms, 7 * ms),
              ("copy", 9 * ms, 12 * ms)]
    host = [("bench.render", 2 * ms, 5 * ms), ("bench.wait", 7 * ms, 10 * ms)]
    out = trace.reduce_events(device, host, (0, 10 * ms))
    assert abs(out["window_s"] - 0.010) < 1e-12
    assert abs(out["busy_s"] - 0.005) < 1e-12  # [0,3] + [6,7] + [9,10]
    gaps = dict(out["idle_gaps"])
    assert abs(gaps["bench.render"] - 0.003) < 1e-12  # [3,6], middle 4.5
    assert abs(gaps["bench.wait"] - 0.002) < 1e-12  # [7,9], middle 8
    ops = dict(out["device_ops"])
    assert abs(ops["k1"] - 0.003) < 1e-12 and abs(ops["copy"] - 0.001) < 1e-12
    assert out["kernels"]["k1"][0] == 2


def test_gap_without_a_label_is_the_hosts():
    out = trace.reduce_events([("k", 5, 10)], [], (0, 20))
    gaps = dict(out["idle_gaps"])
    assert list(gaps) == ["host"] and abs(gaps["host"] - 15e-9) < 1e-18
