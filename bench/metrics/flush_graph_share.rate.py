"""``flush_graph_share``, read the same way, in a cell whose end-to-end
metrics are ``scores_per_s`` and ``setup_s`` alone."""
from bench.harness.cells import reader

read = reader("flush_graph_share")
