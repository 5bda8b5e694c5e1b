"""Share, in %, of the flushes that served queries due in the window
whose span tree holds a ``flush.replay`` span: the flushes that replayed
a captured CUDA graph rather than issuing the eager loop.  A program
whose flushes open no such span reads 0."""
from bench.harness.program_spans import window_flushes


def read(obs):
    fl = window_flushes(obs)
    if fl is None:
        return None
    return 100.0 * sum(1 for tree in fl if tree.named("flush.replay")) \
        / len(fl)
