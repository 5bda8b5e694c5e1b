"""Whole decode step's share of the card's peak: model flops of the
window's unprofiled steps (2 a weight a session, the attention products
over the step's ``kv_positions``, the SSM's state update;
``bench/counts/lm.py``) over their summed ``holmes.lm.step`` wall time,
over the TF32 peak."""
from bench.counts.lm import step_flops


def read(obs):
    steps = obs.get("steps")
    if not steps:
        return None
    kv = [s.counts.get("kv_positions") for s in steps]
    wall = sum(s.root.wall_s for s in steps)
    if None in kv or wall <= 0:
        return None
    flops = sum(step_flops(obs["config"], obs["sessions"], k) for k in kv)
    return 100.0 * flops / wall / obs["peak_flop_s"]
