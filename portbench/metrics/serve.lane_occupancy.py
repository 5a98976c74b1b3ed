"""Lanes in use at each window of the measured calls over all lanes
(`Server.serve_log` "active"): how full the continuous batch is."""


def read(rec):
    logs = [e for c in rec["calls"] for e in c["serve_log"]]
    if not logs:
        return None
    return sum(e["active"] for e in logs) / (len(logs) * rec["lanes"])
