"""Device memory at its peak in the measured window, GiB
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at the
window's start); nothing off the card."""


def read(obs):
    b = obs.get("window_peak_bytes")
    return b / 2**30 if b else None
