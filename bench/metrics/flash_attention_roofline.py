"""Share of the roofline reached by the ``flash_attention`` calls at the
model's head dims in the profiled prefill group (the last of set-up):
the least time of those causal calls from their shapes (3xTF32 flops of
the visible pairs over the TF32 peak, or their bytes over 3.35 TB/s, the
larger; ``bench/counts/lm.py``) over the kernels' device time."""
from bench.counts.lm import dims, flash_attention_bound_s


def read(obs):
    t = obs.get("prefill_trace")
    if not t or t["calls"] == 0 or t["device_s"] <= 0:
        return None
    m = dims(obs["config"])
    bound = flash_attention_bound_s(t["batch"], t["S"], m["Hq"], m["Hkv"],
                                    m["hd"], m["hd"])
    return 100.0 * bound * t["calls"] / t["device_s"]
