"""Host ms a serve window outside its wait for the window's copy: the
program's "serve.window" span minus its "serve.wait" child, mean over the
measured windows."""
from portbench import program_spans


def read(rec):
    return program_spans.host_ms(rec, "serve.wait")
