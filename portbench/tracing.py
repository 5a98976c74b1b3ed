"""Whole device traces from torch.profiler, read in memory (nothing is
exported). A frozen copy of `chip_smoke.py`'s `open_trace`, `close_trace`,
`trace_events` and `flush_device_records`: on the H100 torch.profiler loses
the first records of some traces, so a profiled stretch opens with short
spin kernels and a long mark, and closes with a second mark; a trace is
whole only when both marks are in it, and a stretch that is not whole is
taken again."""
from __future__ import annotations

import ctypes
import time

import torch

SENTINEL = "spin_kernel"
OPEN_PAD, PAD_CYCLES, MARK_CYCLES = 256, 1000, 200000
MARK_US = 20.0          # a spin this long is a mark (~100 us on an H100)
_CUPTI = []


def profiler():
    """A profiler of the device's activity only: what a stretch reads is
    on the device's clock, and host events would only slow the host."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def open_trace() -> None:
    """The spins that open a profiled stretch: call just after start."""
    for _ in range(OPEN_PAD):
        torch.cuda._sleep(PAD_CYCLES)
    time.sleep(0.002)
    torch.cuda._sleep(MARK_CYCLES)


def close_trace() -> None:
    """The mark that closes a stretch, then a forced CUPTI flush."""
    torch.cuda._sleep(MARK_CYCLES)
    flush_device_records()


def flush_device_records() -> None:
    """Synchronise, then have CUPTI hand every record it holds to the
    profiler (cuptiActivityFlushAll, forced). The library is the one torch
    loaded, found in /proc/self/maps."""
    torch.cuda.synchronize()
    if not _CUPTI:
        with open("/proc/self/maps") as f:
            paths = {line.split(None, 5)[5].strip() for line in f
                     if "libcupti" in line and len(line.split(None, 5)) == 6}
        if len(paths) != 1:
            raise RuntimeError(f"want one loaded libcupti, found {paths}")
        _CUPTI.append(ctypes.CDLL(paths.pop()))
    rc = _CUPTI[0].cuptiActivityFlushAll(1)
    if rc != 0:
        raise RuntimeError(f"cuptiActivityFlushAll returned {rc}")


def trace_events(prof):
    """(the events without the spins, whether the trace is whole)."""
    events = prof.events()
    marks = sum(SENTINEL in e.name and e.time_range.elapsed_us() > MARK_US
                for e in events)
    return [e for e in events if SENTINEL not in e.name], marks == 2


def device_events(events):
    """The device's own operations (kernels, copies, memsets): no CPU
    events and no record_function annotation spans."""
    cpu = torch.autograd.DeviceType.CPU
    return [e for e in events if e.device_type != cpu
            and not getattr(e, "is_user_annotation", False)]


def is_kernel(e) -> bool:
    return not e.name.startswith(("Memcpy", "Memset"))


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summary(dev, lo_us: float, hi_us: float, top: int = 10) -> dict:
    """Device operations starting in [lo_us, hi_us) of the device clock:
    busy and window seconds, kernels, seconds by name (the `top` longest)
    and the longest idle gaps, each named by the operation that ends it."""
    ev = sorted((e for e in dev if lo_us <= e.time_range.start < hi_us),
                key=lambda e: e.time_range.start)
    spans = [(e.time_range.start, e.time_range.end) for e in ev]
    by_name = {}
    for e in ev:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e6
    gaps, reach = [], lo_us
    for e in ev:
        if e.time_range.start > reach:
            gaps.append((f"before {e.name[:80]}",
                         (e.time_range.start - reach) / 1e6))
        reach = max(reach, e.time_range.end)
    gaps.sort(key=lambda g: -g[1])
    return {"events": ev, "busy_s": busy_us(spans) / 1e6,
            "window_s": (hi_us - lo_us) / 1e6,
            "kernels": sum(is_kernel(e) for e in ev),
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
            "idle_gaps": gaps[:top]}


def window_walls(stamps):
    """(index, host seconds) of each window from the stamps of their
    starts; the last stamp ends the last window."""
    return [(i, stamps[i + 1] - stamps[i]) for i in range(len(stamps) - 1)]


def read_stretch(prof, k: int):
    """Windows k and k + 1 of a profiled stretch of windows k - 1 .. k + 2:
    the device's operations between the closing device-to-host copies of
    windows k - 1 and k + 1 (each window closes with one), summed by
    kernel name; None when the trace is not whole, lacks a copy or holds
    no kernel."""
    events, whole = trace_events(prof)
    dev = device_events(events)
    closes = sorted((e.time_range for e in dev
                     if e.name.startswith("Memcpy DtoH")),
                    key=lambda r: r.start)
    if not whole or len(closes) != 4:
        return None
    s = summary(dev, closes[0].end, closes[2].end)
    if not s["kernels"]:
        return None
    kern = {}
    for e in s.pop("events"):
        if is_kernel(e):
            n, t = kern.get(e.name, (0, 0.0))
            kern[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e6)
    return dict(s, windows=[k, k + 1], kernels_by_name=kern)
