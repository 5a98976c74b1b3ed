"""Launchers of the port: `serve`, the serving CLI, and `train`, the
training CLI."""
