"""Host time of a model step: each window's span (from the server's
upload of its inputs to the next window's) over its steps, in the
measured calls."""
from portbench import tracing


def read(rec):
    walls = [w for c in rec["calls"]
             for _, w in tracing.window_walls(c["stamps"])]
    return 1e3 * sum(walls) / (len(walls) * rec["window"]) if walls else None
