"""Serving runtime of the port: in-window sampling and the decode server."""
