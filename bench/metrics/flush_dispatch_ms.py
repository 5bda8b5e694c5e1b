"""Mean milliseconds of a flush's ``dispatch`` span (the host issuing
every bucket's operations), over the flushes that served queries due in
the window."""
from bench.harness.stats import flushes_of


def read(obs):
    fl = flushes_of(obs.get("spans") or [])
    if not fl:
        return None
    return 1e3 * sum(s.dispatch_s for s in fl) / len(fl)
