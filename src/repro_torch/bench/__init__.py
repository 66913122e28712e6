"""Microbenchmarks of the port (the counterparts of ``benchmarks/``)."""
