"""Device ms of the model in a step: the "model" stamp segments (the
embedding, projections, FFN, head and sampling) of each measured serve
window's first step, mean over the windows."""
from portbench import program_spans


def read(rec):
    return program_spans.mean_segments(rec, lambda k: k == "model")
