"""Mean wall time of the ``holmes.lm.step`` span (``launch.serve.
greedy_step``: one decode step of every session and its greedy tokens,
host issue and the device work it waits for) over the window's steps
that ran while no profiler recorded."""


def read(obs):
    steps = obs.get("steps")
    if not steps:
        return None
    return 1e3 * sum(t.root.wall_s for t in steps) / len(steps)
