"""Workload generators of the port (numpy copies of `repro/data`)."""
