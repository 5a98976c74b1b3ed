"""Optimizers of the port: AdamW (`adamw.py`) and the int8 gradient
compression of the cross-pod all-reduce (`compression.py`)."""
