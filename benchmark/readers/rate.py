"""Units completed in the measured window over the window's length: frames
whose rgb reached host memory, or images trained on."""


def read(obs, count):
    n = obs["count"].get(count, 0)
    return n / obs["window_s"] if n and obs["window_s"] > 0 else None
