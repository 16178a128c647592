"""A number the run observed directly (``setup_s``)."""


def read(obs, key):
    return obs.get(key)
