"""``flush_side_ms``, read the same way, in a cell whose end-to-end metrics are
``scores_per_s`` and ``setup_s`` alone (the cell's latency spreads
too widely between runs to hold a bound)."""
from bench.harness.cells import reader

read = reader("flush_side_ms")
