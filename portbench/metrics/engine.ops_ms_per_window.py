"""Device ms of the pool ops a window: the "ops.<kind>" stamp segments
(each run of reads or writes) of each measured engine window, mean over
the windows."""
from portbench import program_spans


def read(rec):
    return program_spans.mean_segments(rec, lambda k: k.startswith("ops."))
