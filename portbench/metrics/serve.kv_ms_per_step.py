"""Device ms of the KV cache's bookkeeping in a model step: the "kv.append"
(the paged append and the table lookup) and "kv.record" (the access
accounting) stamp segments of each measured serve window's first step,
which the program stamps layer by layer, mean over the windows."""
from portbench import program_spans


def read(rec):
    return program_spans.mean_segments(
        rec, lambda k: k in ("kv.append", "kv.record"))
