"""The device's idle share of the traced segment, %: 1 - the union of its
kernel, copy and memset intervals over the segment's length.  Nothing where
the trace saw no device activity."""


def read(obs):
    t = obs.get("trace")
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
