"""HADES core of the port: object table, pool with its free rings, MIAD,
backends, collector and the window protocol."""
