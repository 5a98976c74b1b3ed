"""Device kernels a model step in the profiled windows (model, pool
bookkeeping, collector and the window's own copies excluded)."""


def read(rec):
    prof = rec["profile"]
    if prof is None:
        return None
    return prof["kernels"] / (len(prof["windows"]) * rec["window"])
