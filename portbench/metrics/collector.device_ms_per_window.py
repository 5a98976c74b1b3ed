"""Device ms of the collector and the backend a window: the "collect.*"
and "backend" stamp segments of each measured window (serve or engine),
mean over the windows."""
from portbench import program_spans


def read(rec):
    return program_spans.mean_segments(
        rec, lambda k: k.startswith("collect.") or k == "backend")
