"""Launchers of the port: `serve`, the serving CLI."""
