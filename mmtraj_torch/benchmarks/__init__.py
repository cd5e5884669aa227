"""Benchmarks of the port (counterparts of ``mmtraj/benchmarks``)."""
