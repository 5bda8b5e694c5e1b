"""Share of the roofline reached by the ``decode_attention`` calls of
the decode steps the profiled slice holds whole: the least time of those
calls from their shapes (each session's attended K and V rows read once,
over 3.35 TB/s; ``bench/counts/lm.py``) over the device time of the
kernels.  Each call's attended rows are the mean a session and an
invocation over the profiled steps' ``kv_positions`` counters (they
differ by one position from step to step)."""
from bench.counts.lm import decode_attention_bound_s, dims


def read(obs):
    t = obs.get("step_trace")
    steps = obs.get("traced_steps")
    if not t or not steps or t["decode_calls"] == 0 or t["decode_s"] <= 0:
        return None
    m = dims(obs["config"])
    B = obs["sessions"]
    kv = [s.counts.get("kv_positions") for s in steps]
    if None in kv:
        return None
    keys = sum(kv) / len(kv) / (B * m["J"])
    bound = decode_attention_bound_s(B, m["Hq"], m["Hkv"], m["hd"], m["hd"],
                                     keys)
    return 100.0 * bound * t["decode_calls"] / t["decode_s"]
