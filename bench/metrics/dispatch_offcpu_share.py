"""Share of the flushes' ``dispatch`` time in which the issuing worker
was off the CPU: sum of (wall - thread CPU) over sum of wall, over the
``flush.dispatch`` spans of the flushes that served queries due in the
window.  Off the CPU is every cause at once: waiting for the GIL or for
a lock, a CUDA driver call that sleeps, the thread descheduled."""
from bench.harness.program_spans import window_flushes


def read(obs):
    fl = window_flushes(obs)
    if not fl:
        return None
    spans = [s for tree in fl for s in tree.named("flush.dispatch")]
    wall = sum(s.wall_s for s in spans)
    if wall <= 0:
        return None
    return 100.0 * sum(s.wall_s - s.cpu_s for s in spans) / wall
