"""migrate's share of its bound in the profiled windows: the rows those
windows' collects moved (their reports), each read and written, and the
move lists at 3.35 TB/s, over the kernel's device time."""
from portbench import peaks, rooflines


def read(rec):
    prof = rec["profile"]
    if prof is None:
        return None
    n, t = rooflines.device_time(prof, "migrate")
    if not n:
        return None
    b = rooflines.migrate_bytes(sum(prof["moved"]), rec["slot_bytes"],
                                n * 2 * rec["move_budget"])
    return peaks.share_pct(peaks.bound_s(b), t)
