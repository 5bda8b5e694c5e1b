"""Mean milliseconds a flush spent on the CPU-side models: its
``flush.side`` span (the vitals gather and its readback) plus its
``flush.combine`` span (forest, regression, Eq. 5), over the flushes
that served queries due in the window."""
from bench.harness.program_spans import window_flushes


def read(obs):
    fl = window_flushes(obs)
    if not fl:
        return None
    side = sum(s.wall_s for tree in fl
               for name in ("flush.side", "flush.combine")
               for s in tree.named(name))
    return 1e3 * side / len(fl)
