"""Share, in %, of the window's unprofiled decode steps whose
``holmes.lm.step`` tree counts ``graph_replays`` above 0: the steps that
replayed captured CUDA graphs rather than issuing every op from Python.
Nothing where a step's tree lacks the counter (a program that does not
count it)."""


def read(obs):
    steps = obs.get("steps")
    if not steps:
        return None
    n = [s.counts.get("graph_replays") for s in steps]
    if None in n:
        return None
    return 100.0 * sum(1 for k in n if k > 0) / len(n)
