"""The serving-window protocol (port of `zero_report`,
`collect_and_backend`, `window_reports` and `window_program` in
`repro/core/engine.py`; `Engine`, `Hades` and `make_trace` are not ported
yet).

The JAX package compiles a window into one `lax.scan` in two shapes
(window-aligned and generic), because a scan needs a static structure.
PyTorch runs the window as Python, and the host knows the window clock, so
both shapes are ONE loop, `run_window`, with the same semantics: the clock
ticks once per step; with `overlap`, the ATC window is armed after the
step that leaves clock % every == every - 1; collect + backend runs after
the step that leaves clock % every == 0. From an aligned clock over whole
windows this is the aligned shape, and the op sequence it records is
static: it is what the server captures as one CUDA graph per window
(`runtime/server.py`). Nothing in the loop reads a device value on the
host. Lane events (the JAX `pre_fn`) resolve at a window entry; the
server applies them before the loop, which is what the JAX program does at
the entry of the call's first window (its later entries carry no events).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.core import backend as be
from repro_torch.core import collector as col
from repro_torch.core import pool as pl

_I32 = torch.int32

REPORT_KEYS = ("moved_to_hot", "moved_to_cold", "skipped_atc",
               "promotion_rate", "proactive_ok", "ciw_threshold",
               "win_accesses", "win_faults", "rss_bytes", "host_bytes",
               "did_collect") + be.TELEMETRY_KEYS


def zero_report(device=None) -> Dict[str, torch.Tensor]:
    """The no-collect report: the keys and dtypes of a real one."""
    f32 = {"promotion_rate", "ciw_threshold", "rss_bytes", "host_bytes"}
    b = {"proactive_ok", "did_collect"}
    return {k: torch.zeros((), device=device,
                           dtype=torch.float32 if k in f32
                           else torch.bool if k in b else _I32)
            for k in REPORT_KEYS}


def collect_and_backend(pool_cfg: pl.PoolConfig, col_cfg: col.CollectorConfig,
                        backend: be.Backend, state: Dict
                        ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """Collector pass + backend step as one transition. The backend sees the
    closing window's superblock stats (pre-clear) and its own carried state
    (`state["bstate"]`); RSS/host gauges are computed on the device."""
    state, report = col.collect(pool_cfg, col_cfg, state)
    stats = report.pop("sb_stats")
    signals = {"proactive_ok": report["proactive_ok"],
               "epoch": state["epoch"]}
    bstate, tier, evict, telemetry = backend.step(
        pool_cfg, state["bstate"], stats, state["sb_tier"],
        state["sb_evict"], signals)
    state = dict(state, bstate=bstate, sb_tier=tier, sb_evict=evict)
    report.update(telemetry)
    occupied = stats["occupancy"] > 0
    sb_bytes = float(pool_cfg.sb_bytes)
    report["rss_bytes"] = (occupied & (tier == pl.HBM)).sum().to(
        torch.float32) * sb_bytes
    report["host_bytes"] = (occupied & (tier == pl.HOST)).sum().to(
        torch.float32) * sb_bytes
    report["did_collect"] = torch.ones((), dtype=torch.bool,
                                       device=tier.device)
    return state, report


def run_window(step_fn: Callable, collect_fn: Callable, arm_fn: Callable,
               state, xs: Sequence, clock: int, *, every: int,
               enabled: bool = True, overlap: bool = False):
    """Run len(xs) steps of the window protocol from op clock `clock`.

        step_fn(state, x)   -> (state, out)      one window step
        collect_fn(state)   -> (state, report)   fused collect + backend
        arm_fn(state)       -> state             ATC arming

    Returns (state, outs [one per step], reports [one per collect])."""
    every = int(every)
    outs: List = []
    reports: List[Dict[str, torch.Tensor]] = []
    for x in xs:
        state, out = step_fn(state, x)
        outs.append(out)
        clock += 1
        if enabled:
            if overlap and clock % every == every - 1:
                state = arm_fn(state)
            if clock % every == 0:
                state, report = collect_fn(state)
                reports.append(report)
    return state, outs, reports


def window_reports(reports: Sequence[Dict[str, torch.Tensor]]
                   ) -> List[Dict[str, float]]:
    """Host-side floats of a window's collect reports — the one sync a
    window pays for them (a single device-to-host copy)."""
    if not reports:
        return []
    keys = list(reports[0])
    host = torch.stack([torch.stack([r[k].to(torch.float64) for k in keys])
                        for r in reports]).cpu().tolist()
    return [dict(zip(keys, row)) for row in host]
