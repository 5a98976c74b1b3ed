"""Host ms an engine window outside its wait for the reports' copy: the
program's "engine.window" span minus its "engine.wait" child, mean over
the measured windows."""
from portbench import program_spans


def read(rec):
    return program_spans.host_ms(rec, "engine.wait")
