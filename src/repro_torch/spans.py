"""The port's span recorder: host spans, device stamps and counters, kept
in memory (nothing is exported).

  * Host spans (`span`): a name, start and end (`time.perf_counter_ns`),
    the id of the span open around it (its parent) and the attributes the
    caller gives (a call, window or request id). A span is recorded when
    it closes, on an exception too. `event` records one instant.
  * Device stamps: a window program (`program`, opened inside the body that
    `core/graphs.py` runs and captures) owns a float64 stamp area; each
    `stamp(name)` writes the device clock into the area's next slot (the
    `stamp` kernel on CUDA, one node of a captured graph; on the CPU, whose
    eager execution is synchronous, the host clock). The segment from one
    stamp to the next is named by the later one; the first stamp is
    "start". The area rides in the window's one device-to-host copy
    (`fetch`), which records one "stamps" entry a window: the names, the
    absolute readings, and the host time at which the copy returned (their
    difference to the last reading bounds the host-device clock offset
    from above).
  * Counters (`counters`): entries the ring dropped, stamp areas lost
    before a copy took them, stamps past an area's end, and graph captures
    by program ("captures.<program>").

Entries live in one ring of RING entries; when it is full the oldest go
and are counted. `ENABLED` is the switch: off, a span costs one attribute
check, no program opens, and no stamp enters a newly captured graph.
Stamps outside a window program are no-ops, so the collector's callers
outside a window (`Engine.step`, training) pay one check.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import ops as kops

ENABLED = True
RING = 1 << 16          # entries kept
STAMPS = 1024           # stamps a window program holds
PENDING = 64            # stamp areas waiting for their copy

_ring: collections.deque = collections.deque(maxlen=RING)
counters: Dict[str, int] = {"dropped": 0, "stamps_lost": 0,
                            "stamps_over": 0}
_stack: List[int] = []                  # ids of the open spans
_last_id = 0
_prog: Optional["_Program"] = None      # the window program open now
_pending: List["_Program"] = []         # programs run, areas not copied
_captured: List["_Program"] = []        # programs captured, not yet taken


_CLOSE = {"span": "t1", "event": "t", "stamps": "host_return"}
_dropped_t: Optional[int] = None        # when the newest dropped closed


def _add(entry: Dict) -> None:
    global _dropped_t
    if len(_ring) == RING:
        counters["dropped"] += 1
        _dropped_t = _ring[0][_CLOSE[_ring[0]["kind"]]]
    _ring.append(entry)


def _parent() -> Optional[int]:
    return _stack[-1] if _stack else None


def now() -> int:
    """The host clock of the spans (`time.perf_counter_ns`)."""
    return time.perf_counter_ns()


def records() -> List[Dict]:
    """The entries the ring holds, oldest first (in the order they
    closed)."""
    return list(_ring)


def lost_since(t: int) -> bool:
    """Whether the ring dropped an entry that closed at or after host time
    `t` (ns): a record read from `t` on would then be partial."""
    return _dropped_t is not None and _dropped_t >= t


def reset() -> None:
    """Forget every entry, pending area and count (open spans stay)."""
    global _dropped_t
    _dropped_t = None
    _ring.clear()
    _pending.clear()
    _captured.clear()
    for k in list(counters):
        if k.startswith("captures."):
            del counters[k]
        else:
            counters[k] = 0


# -- host spans -----------------------------------------------------------
class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "t0")

    def __init__(self, name: str, start: Optional[int], attrs: Dict):
        self.name, self.t0, self.attrs = name, start, attrs

    def __enter__(self) -> "_Span":
        global _last_id
        _last_id += 1
        self.id, self.parent = _last_id, _parent()
        if self.t0 is None:
            self.t0 = time.perf_counter_ns()
        _stack.append(self.id)
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        while _stack and _stack.pop() != self.id:
            pass
        _add(dict(self.attrs, kind="span", name=self.name, id=self.id,
                  parent=self.parent, t0=self.t0, t1=t1))
        return False


_OFF = contextlib.nullcontext()


def span(name: str, start: Optional[int] = None, **attrs):
    """A host span as a context manager (yields the span, whose `id` names
    it, or None when the recorder is off); `start` (`now()`) backdates
    it."""
    if not ENABLED:
        return _OFF
    return _Span(name, start, attrs)


def event(name: str, **attrs) -> None:
    """One instant, under the span open now."""
    if ENABLED:
        _add(dict(attrs, kind="event", name=name, t=time.perf_counter_ns(),
                  parent=_parent()))


# -- device stamps --------------------------------------------------------
class _Program:
    """One run or capture of a window program: `head` float64 slots of the
    program's own payload, then its stamp area, in one buffer `wire`."""
    __slots__ = ("name", "head", "wire", "names", "quiet", "steps", "t0",
                 "area")

    def __init__(self, name: str, device, head: int):
        self.name, self.head = name, head
        self.wire = torch.empty(head + STAMPS, dtype=torch.float64,
                                device=device)
        self.names: List[str] = []
        self.quiet = False
        self.steps = 0
        self.t0 = 0                     # the first reading, on the CPU
        self.area = None                # the written slots, once closed

    @property
    def payload(self) -> torch.Tensor:
        return self.wire[:self.head]


@contextlib.contextmanager
def program(name: str, device, head: int = 0):
    """A window program's run or capture: stamps inside write into its
    area, after a "start" stamp. Yields the program, whose `payload` holds
    `head` float64 slots just before the area (outputs written there share
    the window's copy with the stamps), or None when the recorder is off.
    A program that returns is pending until `fetch` copies its area; one
    that was captured goes to its graph (`take_captured`), whose replays
    set it pending again (`ran`)."""
    global _prog
    if not ENABLED:
        yield None
        return
    p = _Program(name, device, head)
    outer, _prog = _prog, p
    try:
        stamp("start")
        yield p
    finally:
        _prog = outer
    p.names = tuple(p.names)
    p.area = p.wire[p.head:p.head + len(p.names)]
    if p.wire.is_cuda and torch.cuda.is_current_stream_capturing():
        key = "captures." + name
        counters[key] = counters.get(key, 0) + 1
        _captured.append(p)
    else:
        ran(p)


def stamp(name: str) -> None:
    """Close the open program's current segment, naming it `name`: the
    device clock goes into the area's next slot. A no-op outside a program
    and inside `quiet`."""
    p = _prog
    if p is None or p.quiet:
        return
    k = len(p.names)
    if k == STAMPS:
        counters["stamps_over"] += 1
        return
    p.names.append(name)
    area = p.wire[p.head:]
    if p.wire.is_cuda:
        kops.stamp(area, k)
        return
    t = time.perf_counter_ns()
    if k == 0:
        p.t0 = t
        area[:1].view(torch.int64).fill_(t)
    else:
        area[k] = float(t - p.t0)


def first_step() -> bool:
    """True at the open program's first step, which is stamped layer by
    layer; False at its later steps (the same kernels over one more token)
    and outside a program."""
    p = _prog
    if p is None:
        return False
    p.steps += 1
    return p.steps == 1


@contextlib.contextmanager
def quiet(on: bool = True):
    """Inside (when `on`), the open program's stamps are skipped."""
    p = _prog
    if p is None or not on:
        yield
        return
    p.quiet = True
    try:
        yield
    finally:
        p.quiet = False


def take_captured():
    """The program captured since the last call, for its graph to keep
    (None when the recorder was off)."""
    p = _captured[-1] if _captured else None
    _captured.clear()
    return p


def ran(p: "_Program") -> None:
    """Program `p` ran, eagerly or as a replay of its graph: its area waits
    for the next `fetch`. A replay overwrites the area of the one before
    it, and at most PENDING areas wait: what is overwritten or pushed out
    is counted as lost."""
    if not ENABLED:
        return
    ptr = p.wire.data_ptr()
    for i, q in enumerate(_pending):
        if q.wire.data_ptr() == ptr:
            del _pending[i]
            counters["stamps_lost"] += 1
            break
    if len(_pending) == PENDING:
        del _pending[0]
        counters["stamps_lost"] += 1
    _pending.append(p)


def fetch(rows: List[torch.Tensor]) -> np.ndarray:
    """A window's one device-to-host copy: the float64 1-d tensors `rows`,
    joined, with the stamp areas pending since the last fetch (a program's
    own payload, when it is the one row, goes with its area as it lies).
    Records one "stamps" entry per area. Returns the rows' values."""
    progs = list(_pending)
    _pending.clear()
    if not progs:
        return (rows[0] if len(rows) == 1 else torch.cat(rows)).cpu().numpy()
    p = progs[0]
    if len(progs) == 1 and len(rows) == 1 and p.head and \
            p.head == rows[0].numel() and \
            rows[0].data_ptr() == p.wire.data_ptr():
        host = p.wire[:p.head + len(p.names)].cpu().numpy()
    else:
        host = torch.cat(list(rows) + [p.area for p in progs]).cpu().numpy()
    t_ret = time.perf_counter_ns()
    n = at = len(host) - sum(len(p.names) for p in progs)
    for p in progs:
        area = host[at:at + len(p.names)]
        at += len(p.names)
        t = np.rint(area).astype(np.int64)
        t[0] = area[:1].view(np.int64)[0]
        t[1:] += t[0]
        _add(dict(kind="stamps", program=p.name, names=p.names, t=t,
                  host_return=t_ret, parent=_parent()))
    return host[:n]


# -- reading the record ---------------------------------------------------
def segments(entry: Dict) -> Dict[str, int]:
    """A "stamps" entry's device nanoseconds by segment name: the segments
    tile the window's stamped span (their sum is the last reading minus the
    first)."""
    t, out = entry["t"], {}
    for i in range(1, len(t)):
        name = entry["names"][i]
        out[name] = out.get(name, 0) + int(t[i] - t[i - 1])
    return out


def windows(entries: List[Dict], parts: Optional[List[tuple]] = None
            ) -> List[Dict]:
    """The host window spans ("<x>.window") among `entries`, oldest first,
    each with "children" {name: ns} (its direct children's time by name),
    "stamps" (the stamps entry its copy brought back, or None) and "cycle"
    (its host cycle: ns from its start to the next window's start under
    the same parent, or None for the last). With `parts` ([(lo, hi)] ns),
    only windows that start in a part are kept, and no cycle crosses
    from one part into another."""
    by_id = {e["id"]: e for e in entries if e["kind"] == "span"}
    wins = {e["id"]: dict(e, children={}, stamps=None, cycle=None)
            for e in by_id.values() if e["name"].endswith(".window")}
    for e in by_id.values():
        w = wins.get(e["parent"])
        if w is not None:
            w["children"][e["name"]] = w["children"].get(e["name"], 0) + \
                e["t1"] - e["t0"]
    for e in entries:
        if e["kind"] == "stamps" and e["parent"] in by_id:
            w = wins.get(by_id[e["parent"]]["parent"])
            if w is not None:
                w["stamps"] = e
    ordered = sorted(wins.values(), key=lambda w: w["t0"])
    groups = [ordered] if parts is None else \
        [[w for w in ordered if lo <= w["t0"] <= hi] for lo, hi in parts]
    out = []
    for group in groups:
        for a, b in zip(group, group[1:]):
            if a["parent"] == b["parent"]:
                a["cycle"] = b["t0"] - a["t0"]
        out += group
    return out


def stamped(win: Dict) -> int:
    """A window's stamped device ns: its last reading minus its first
    (everything the device did between them counts, gaps between the
    graph's nodes too)."""
    t = win["stamps"]["t"]
    return int(t[-1] - t[0])


def idle(wins: List[Dict]) -> Optional[float]:
    """The share of the windows' host cycles outside their stamped spans
    (`windows` with a cycle and stamps): the time the device ran none of
    the window program, or None without such a window."""
    pairs = [(stamped(w), w["cycle"]) for w in wins
             if w["cycle"] is not None and w["stamps"] is not None]
    cycle = sum(c for _, c in pairs)
    return 1.0 - sum(s for s, _ in pairs) / cycle if cycle else None


def requests(entries: List[Dict]) -> Dict[str, List[int]]:
    """Each served request's host ns from its serve call's start (the
    "serve.call" span; every request is queued at it) to its
    "first_token" event (its time to first token, "ttft") and to its
    "finish" event ("latency")."""
    calls = {e["id"]: e["t0"] for e in entries
             if e["kind"] == "span" and e["name"] == "serve.call"}
    keys = {"first_token": "ttft", "finish": "latency"}
    out: Dict[str, List[int]] = {"ttft": [], "latency": []}
    for e in entries:
        if e["kind"] == "event" and e["name"] in keys and \
                e.get("call") in calls:
            out[keys[e["name"]]].append(e["t"] - calls[e["call"]])
    return out


def summary(entries: Optional[List[Dict]] = None) -> Dict:
    """The recorder's view for an operator, over `entries` (by default the
    ring): host ms a window by span (each window span and its children)
    and its host cycle, device ms a window by segment (by program), the
    device's idle share (`idle`), the served requests' time to first
    token and latency from their call's start (mean and p95 ms), the
    captures and the counters."""
    entries = records() if entries is None else entries
    wins = windows(entries)
    host: Dict[str, List[int]] = {}
    for w in wins:
        for name, ns in [(w["name"], w["t1"] - w["t0"])] + \
                list(w["children"].items()):
            host.setdefault(name, []).append(ns)
    cycles = [w["cycle"] for w in wins if w["cycle"] is not None]
    if cycles:
        host["cycle"] = cycles
    device: Dict[str, Dict[str, int]] = {}
    n_prog: Dict[str, int] = {}
    for e in entries:
        if e["kind"] == "stamps":
            n_prog[e["program"]] = n_prog.get(e["program"], 0) + 1
            seg = device.setdefault(e["program"], {})
            for name, ns in segments(e).items():
                seg[name] = seg.get(name, 0) + ns
    share = idle(wins)
    reqs = {k: [round(1e-6 * float(np.mean(v)), 4),
                round(1e-6 * float(np.percentile(v, 95)), 4)]
            for k, v in requests(entries).items() if v}
    return {
        "host_ms": {k: round(1e-6 * sum(v) / len(v), 4)
                    for k, v in host.items()},
        "device_ms": {p: {k: round(1e-6 * v / n_prog[p], 4)
                          for k, v in seg.items()}
                      for p, seg in device.items()},
        "idle": None if share is None else round(share, 4),
        "requests_ms": reqs,
        "windows": len(wins), "counters": dict(counters)}
