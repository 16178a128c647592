"""The whole step's share of the card's peak, %: the frozen model FLOPs of
every unit completed in the measured window (``work/model.py``) over the
window's length times the published peak for the type the products run in
(``work/peaks.py``)."""

from benchmark.work import peaks


def read(obs, peak):
    flops = obs.get("flops")
    if not flops or obs["window_s"] <= 0 or obs.get("platform") != "gpu":
        return None
    return 100.0 * flops / (obs["window_s"] * peaks.FLOPS[peak])
