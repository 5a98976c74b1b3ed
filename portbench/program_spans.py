"""The program's own record of where its windows' time goes (the span
recorder `repro_torch.spans`: host spans, device stamps), read over a
run's measured window for the per-layer readers that use it. A program
without the recorder gives nothing, and those readers return None.

The measured window of a serve cell is its calls (each call's [t0, t1]);
of an engine cell, its host stamps' first to last. Both are on the host
clock the spans use (`time.perf_counter`)."""
from __future__ import annotations

from typing import Dict, List, Optional


def recorder():
    """The program's span recorder module, or None."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans


def ranges(rec) -> List[tuple]:
    """[lo, hi] ns of the measured window's parts."""
    if "calls" in rec:
        parts = [(c["t0"], c["t1"]) for c in rec["calls"]]
    else:
        parts = [(rec["stamps"][0], rec["stamps"][-1])]
    return [(int(lo * 1e9), int(hi * 1e9)) for lo, hi in parts]


def entries(rec) -> Optional[List[Dict]]:
    """The recorder's entries, or None without the recorder, or when its
    ring dropped an entry of the measured window (a partial record)."""
    spans = recorder()
    if spans is None or spans.lost_since(ranges(rec)[0][0]):
        return None
    return spans.records()


def measured(rec) -> Optional[List[Dict]]:
    """The program's window spans (`spans.windows`: each with its
    children's ns by name, its stamps entry and its host cycle, None for
    a part's last window) that start in the measured window. None when
    the program recorded none, or not all of them."""
    recs = entries(rec)
    if recs is None:
        return None
    return recorder().windows(recs, ranges(rec)) or None


def segments_ms(rec) -> Optional[List[Dict[str, float]]]:
    """Device ms by stamp segment of each measured window that brought
    its stamps back, or None."""
    wins = measured(rec)
    if wins is None:
        return None
    spans = recorder()
    out = [{k: v / 1e6 for k, v in spans.segments(w["stamps"]).items()}
           for w in wins if w["stamps"] is not None]
    return out or None


def mean_segments(rec, pick) -> Optional[float]:
    """Mean over the measured windows of the ms of the segments whose
    names `pick` accepts."""
    segs = segments_ms(rec)
    if segs is None:
        return None
    return sum(sum(v for k, v in s.items() if pick(k)) for s in segs) / \
        len(segs)


def host_ms(rec, wait: str) -> Optional[float]:
    """Mean host ms a measured window outside its `wait` child."""
    wins = measured(rec)
    if wins is None:
        return None
    return sum(w["t1"] - w["t0"] - w["children"].get(wait, 0)
               for w in wins) / len(wins) / 1e6
