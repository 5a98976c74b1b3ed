"""How long a request waits in the queue: from its serve call's start
(the program's "serve.call" span) to the start of the "serve.launch" span
of the window that admits it (its "admit" event), mean over the requests
of the measured calls."""
from portbench import program_spans


def read(rec):
    entries = program_spans.entries(rec)
    if entries is None:
        return None
    bounds = program_spans.ranges(rec)
    calls = {e["id"]: e["t0"] for e in entries
             if e["kind"] == "span" and e["name"] == "serve.call"
             and any(lo <= e["t0"] <= hi for lo, hi in bounds)}
    wins = {e["id"]: (e["call"], e["window"]) for e in entries
            if e["kind"] == "span" and e["name"] == "serve.window"
            and e["call"] in calls}
    launch = {wins[e["parent"]]: e["t0"] for e in entries
              if e["kind"] == "span" and e["name"] == "serve.launch"
              and e["parent"] in wins}
    waits = [launch[(e["call"], e["window"])] - calls[e["call"]]
             for e in entries if e["kind"] == "event"
             and e["name"] == "admit" and e["call"] in calls
             and (e["call"], e["window"]) in launch]
    return sum(waits) / len(waits) / 1e6 if waits else None
