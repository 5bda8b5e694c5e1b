"""Share of the profiled slice in which no device operation ran:
1 - (union of device operation intervals / the slice)."""


def read(obs):
    t = obs.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
