"""The benchmarks' shared substrate (the port of ``benchmarks/``)."""
