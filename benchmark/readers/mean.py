"""The mean of a series taken over the whole measured window; nothing for an
empty series."""

import numpy as np


def read(obs, series):
    values = obs["series"].get(series, [])
    return float(np.mean(values)) if len(values) else None
