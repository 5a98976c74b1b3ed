"""Device kernels a window in the profiled windows."""


def read(rec):
    prof = rec["profile"]
    if prof is None:
        return None
    return prof["kernels"] / len(prof["windows"])
