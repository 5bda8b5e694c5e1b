"""Whole flush's share of the card's peak: model flops of the windows
scored (pad rows left out; convs and heads from shapes) over the summed
service seconds of the flushes that served queries due in the window,
over the TF32 peak."""
from bench.counts.convs import window_flops
from bench.harness.stats import flushes_of


def read(obs):
    fl = flushes_of(obs.get("spans") or [])
    busy = sum(s.service_s for s in fl)
    if not fl or busy <= 0:
        return None
    flops = window_flops(obs["members"]) * sum(s.batch_n for s in fl)
    return 100.0 * flops / busy / obs["peak_flop_s"]
