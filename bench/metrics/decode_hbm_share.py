"""Share of the card's memory bandwidth a decode step reaches: the bytes
a step must move (every weight once, the shared blocks once an
invocation, the attended K/V rows from the step's ``kv_positions``
counter, the states read and written; ``bench/counts/lm.py``) summed
over the window's unprofiled steps, over their summed ``holmes.lm.step``
wall time, over 3.35 TB/s."""
from bench.counts.lm import step_bytes


def read(obs):
    steps = obs.get("steps")
    if not steps:
        return None
    kv = [s.counts.get("kv_positions") for s in steps]
    wall = sum(s.root.wall_s for s in steps)
    if None in kv or wall <= 0:
        return None
    moved = sum(step_bytes(obs["config"], obs["sessions"], k) for k in kv)
    return 100.0 * moved / wall / obs["hbm_bytes_s"]
