"""Device operations (kernels, copies, sets) launched inside one flush,
averaged over the flushes the profiled slice holds whole."""


def read(obs):
    t = obs.get("trace")
    if not t or not t["flushes"]:
        return None
    return sum(f["ops"] for f in t["flushes"]) / len(t["flushes"])
