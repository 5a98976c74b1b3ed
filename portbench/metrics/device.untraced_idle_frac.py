"""The share of the host's window cycle (a window's start to the next
one's) outside the window program's stamped span (its first stamp to its
last), untraced, over the measured windows that have a next one
(`spans.idle`). Gaps between the graph's nodes lie inside the stamped
span and count as busy: this reads the host's time around the window
program, not the device's idle time within it (PERF.md compares the
stamped span with the profiler's busy time for that)."""
from portbench import program_spans


def read(rec):
    wins = program_spans.measured(rec)
    return None if wins is None else program_spans.recorder().idle(wins)
