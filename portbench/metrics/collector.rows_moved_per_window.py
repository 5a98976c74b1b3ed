"""Rows the collector moved a window (the collect reports' moved_to_hot +
moved_to_cold) over the measured windows."""


def read(rec):
    reps = rec["reports"]
    if not reps:
        return None
    return sum(r["moved_to_hot"] + r["moved_to_cold"] for r in reps) / \
        len(reps)
