"""Device busy time a window in the profiled windows (the union of the
device's operations, the harness's few per-window kernels included)."""


def read(rec):
    prof = rec["profile"]
    if prof is None:
        return None
    return 1e3 * prof["busy_s"] / len(prof["windows"])
