"""Runtimes of the port: in-window sampling, the decode server and the
fault-tolerant trainer."""
