"""Median of due -> score retired over every query due in the window; a
failed query counts at the drain limit."""
from bench.harness.stats import percentile


def read(obs):
    return 1e3 * percentile(obs["latency_s"], 50)
