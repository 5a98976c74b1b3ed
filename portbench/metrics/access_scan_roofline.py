"""access_scan's share of its bound in the profiled windows: the table
words read and written and the two verdict masks at 3.35 TB/s, over the
kernel's device time."""
from portbench import peaks, rooflines


def read(rec):
    prof = rec["profile"]
    if prof is None:
        return None
    n, t = rooflines.device_time(prof, "access_scan")
    if not n:
        return None
    return peaks.share_pct(
        n * peaks.bound_s(rooflines.access_scan_bytes(rec["n_objects"])), t)
