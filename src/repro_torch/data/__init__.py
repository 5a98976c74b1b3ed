"""Workload generators of the port (numpy copies of `repro/data`): YCSB
keys (`ycsb.py`) and the LM token pipeline (`lm.py`)."""
