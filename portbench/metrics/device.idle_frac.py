"""The share of the profiled stretch in which no operation ran on the
device: 1 - busy / window, both read from the one stretch (the union of
the device's operations between the closing device-to-host copies that
bound it, over that span). The profiler lengthens the stretch, so this
reads the device's idle share under tracing."""


def read(rec):
    prof = rec["profile"]
    if prof is None:
        return None
    return 1.0 - prof["busy_s"] / prof["window_s"]
