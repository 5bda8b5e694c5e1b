"""The harness: cells from ``BENCHMARK.json``, traffic, weights, one run,
the trace's reduction and the check of the served scores."""
