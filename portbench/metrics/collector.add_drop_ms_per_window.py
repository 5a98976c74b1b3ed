"""Device ms of the move plan's occupancy updates a window: the
"collect.add_drop" stamp segments (the two `ot.add_drop` calls of each
direction's plan) of each measured window, mean over the windows."""
from portbench import program_spans


def read(rec):
    return program_spans.mean_segments(rec, lambda k: k == "collect.add_drop")
