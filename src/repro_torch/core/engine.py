"""The object engine and the window protocol (port of `repro/core/
engine.py`): `EngineOptions`, `apply_step`, `make_run_window`,
`make_trace`, `window_reports` and `Engine`, over the protocol pieces the
server runs too (`zero_report`, `collect_and_backend`, `run_window`).

The JAX package compiles a window into one `lax.scan` in two shapes
(window-aligned and generic), because a scan needs a static structure.
PyTorch runs the window as Python, and the host knows the window clock, so
both shapes are ONE loop, `run_window`, with the same semantics: the clock
ticks once per step; with `overlap`, the ATC window is armed after the
step that leaves clock % every == every - 1; collect + backend runs after
the step that leaves clock % every == 0. From an aligned clock over whole
windows this is the aligned shape, and the op sequence it records is
static: it is what the server and the engine capture as one CUDA graph per
window (`core/graphs.py`). Nothing in the loop reads a device value on the
host. Lane events (the JAX `pre_fn`) resolve at a window entry; the server
applies them before the loop, which is what the JAX program does at the
entry of the call's first window (its later entries carry no events).

The engine runs op traces:

    trace   {"op": [T] int32 ON THE HOST, "ids": [T, K] int32,
             "values": [T, K, W]}      (K ops per step, ids < 0 are padding)
    run(state, trace, step0) -> (state, outs [T, K, W],
                                 reports {key: [T]})

Reports come back per STEP, as in JAX: zeros off the collect steps,
`did_collect` marking the window closers. On a CUDA device every call
whose `step0` and T are multiples of `collect_every` (the JAX aligned
shape) runs ONE CUDA graph replay per window, keyed by the window's op
codes and the shapes and dtype of its ids and values; the op codes stay on
the host, so choosing a graph never syncs. Every other call, and every
call on the CPU, runs op by op (the JAX generic shape).

Every op in a trace advances the window clock, `free` included.

Each aligned window is a span recorder program ("engine",
`repro_torch/spans.py`), on the CPU too: its stamps close "ops.<kind>"
(each run of one op kind), the collector's segments, "backend" and "pack"
(the per-step report layout), and come back in `serve_steps`' one copy of
the window's reports, under the host spans "engine.window" ("prepare",
"launch", "wait", "unpack").
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import spans
from repro_torch.core import backend as be
from repro_torch.core import collector as col
from repro_torch.core import graphs
from repro_torch.core import pool as pl
from repro_torch.device import resolve_device, upload

_I32 = torch.int32

# op codes of batched traces (the pool's op codes)
READ, WRITE = pl.OP_READ, pl.OP_WRITE
ALLOC, FREE = pl.OP_ALLOC, pl.OP_FREE
OP_CODES = {"read": READ, "write": WRITE, "alloc": ALLOC, "free": FREE}
_OP_SEGMENTS = {code: "ops." + op for op, code in OP_CODES.items()}

REPORT_KEYS = ("moved_to_hot", "moved_to_cold", "skipped_atc",
               "promotion_rate", "proactive_ok", "ciw_threshold",
               "win_accesses", "win_faults", "rss_bytes", "host_bytes",
               "did_collect") + be.TELEMETRY_KEYS


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Static window / collector / backend configuration (`HadesOptions`
    in core/frontend.py is the same class)."""
    collect_every: int = 8
    # a backend.Backend (from backend.make), a deprecated BackendConfig,
    # or a registered name — normalized via backend.as_backend
    backend: Union[be.Backend, be.BackendConfig, str] = dataclasses.field(
        default_factory=lambda: be.make("reactive"))
    collector: col.CollectorConfig = dataclasses.field(
        default_factory=col.CollectorConfig)
    enabled: bool = True           # False = allocator only (no tidying)
    # arm ATC tracking for the window before each collect: set it when the
    # runtime overlaps step dispatch with collection, so that ATC > 0
    # marks objects a concurrent step may still dereference
    overlap_collect: bool = False


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
    spans.stamp("backend")
    return state, report


def apply_step(pool_cfg: pl.PoolConfig, col_cfg: col.CollectorConfig,
               backend: be.Backend, state: Dict, ids: torch.Tensor,
               values: Optional[torch.Tensor], *, op: str,
               do_arm: bool = False, do_collect: bool = False
               ) -> Tuple[Dict, Optional[torch.Tensor], Dict]:
    """One op and its share of the window protocol: apply `op`, then arm
    and / or run collect + backend. Returns (state, read values or None,
    report)."""
    out = None
    if op == "read":
        out, state = pl.read(pool_cfg, state, ids)
    elif op == "write":
        state = pl.write(pool_cfg, state, ids, values)
    elif op == "alloc":
        state = pl.alloc(pool_cfg, state, ids, values)
    elif op == "free":
        state = pl.free(pool_cfg, state, ids)
    else:
        raise ValueError(op)
    if do_arm:
        state = col.arm(state)
    if do_collect:
        state, report = collect_and_backend(pool_cfg, col_cfg, backend,
                                            state)
    else:
        report = zero_report(state["table"].device)
    return state, out, report


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


def _op_step(pool_cfg: pl.PoolConfig, state: Dict, xs: Dict
             ) -> Tuple[Dict, torch.Tensor]:
    """One traced op batch: xs = {"op": a Python int, "ids" [K], "values"
    [K, W], "last": whether it ends a run of its op kind}. Returns (state,
    read values [K, W] in the values' dtype)."""
    state, vals = pl.apply_op(pool_cfg, state, xs["op"], xs["ids"],
                              xs["values"])
    vals = vals.to(xs["values"].dtype)
    if xs["last"]:
        spans.stamp(_OP_SEGMENTS[xs["op"]])
    return state, vals


def _host_ops(op) -> List[int]:
    """A trace's op codes as Python ints. They must lie on the host: a read
    from the device would sync."""
    if isinstance(op, torch.Tensor):
        if op.device.type != "cpu":
            raise ValueError("trace['op'] must lie on the host (a CPU "
                             "tensor or a list), not on the device")
        op = op.tolist()
    return [int(v) for v in op]


def _per_step(reports: List[Dict[str, torch.Tensor]], closers: List[int],
              t: int, device) -> Dict[str, torch.Tensor]:
    """The per-step report layout {key: [t]}: the collect reports at the
    window closers `closers`, zeros elsewhere."""
    zero = zero_report(device)
    at = dict(zip(closers, reports))
    if t == 0:
        return {k: zero[k].new_zeros((0,)) for k in REPORT_KEYS}
    return {k: torch.stack([at[i][k] if i in at else zero[k]
                            for i in range(t)]) for k in REPORT_KEYS}


def _pool_data(state: Dict) -> torch.Tensor:
    return state["data"]


class _WindowRunner:
    """`run(state, trace, step0)` of `make_run_window`. `eager = True`
    runs every call op by op on CUDA too (the tests and `chip_smoke.py`
    compare the modes that way); `replays` counts graph replays."""

    def __init__(self, pool_cfg: pl.PoolConfig, opts: EngineOptions):
        self.opts = opts
        self.every = int(opts.collect_every)
        self.eager = False
        self.replays = 0
        self._step = functools.partial(_op_step, pool_cfg)
        self._collect = functools.partial(
            collect_and_backend, pool_cfg, opts.collector,
            be.as_backend(opts.backend))
        self._g: Optional[graphs.WindowGraphs] = None

    def _steps(self, state, ops, ids, values, clock: int):
        """The window protocol op by op over ops[i], ids[i], values[i]."""
        xs = [{"op": op, "ids": ids[i], "values": values[i],
               "last": i + 1 == len(ops) or ops[i + 1] != op}
              for i, op in enumerate(ops)]
        state, outs, reports = run_window(
            self._step, self._collect, col.arm, state, xs, clock,
            every=self.every, enabled=self.opts.enabled,
            overlap=self.opts.overlap_collect)
        closers = [i for i in range(len(ops)) if self.opts.enabled
                   and (clock + i + 1) % self.every == 0]
        out = torch.stack(outs) if outs else torch.zeros_like(values)
        return state, out, _per_step(reports, closers, len(ops), ids.device)

    def __call__(self, state: Dict, trace: Dict, step0=0):
        ops = _host_ops(trace["op"])
        ids, values = trace["ids"], trace["values"]
        t, every = len(ops), self.every
        aligned = (isinstance(step0, int) and step0 % every == 0
                   and t % every == 0 and t > 0)
        if not aligned:
            return self._steps(state, ops, ids, values, int(step0))
        graph = ids.device.type == "cuda" and not self.eager
        outs, reps = [], []
        for lo in range(0, t, every):
            state, out, rep = self._window(state, ops[lo:lo + every],
                                           ids[lo:lo + every],
                                           values[lo:lo + every], graph)
            outs.append(out)
            reps.append(rep)
        if len(outs) == 1:
            return state, outs[0], reps[0]
        return (state, torch.cat(outs),
                {k: torch.cat([r[k] for r in reps]) for k in REPORT_KEYS})

    def _window(self, state, ops, ids, values, graph: bool):
        """One aligned window: with `graph`, one graph replay (a key's
        first window runs for real, then is captured), else op by op."""
        def body(carry, x):
            with spans.program("engine", x[0].device):
                carry, out, rep = self._steps(carry, ops, x[0], x[1], 0)
                spans.stamp("pack")
            return carry, {"out": out, "report": rep}
        if not graph:
            state, outs = body(state, (ids, values))
            return state, outs["out"], outs["report"]
        key = (tuple(ops), tuple(ids.shape), tuple(values.shape),
               values.dtype)
        if self._g is None:
            self._g = graphs.WindowGraphs(ids.device)
        g = self._g.graphs.get(key)
        if g is None:
            state, outs = self._g.first_window(key, body, state,
                                               (ids, values), _pool_data)
        else:
            state = self._g.bind(state, _pool_data)
            outs = pytree.tree_map(torch.clone,
                                   self._g.replay(g, (ids, values)))
            self.replays += 1
        return state, outs["out"], outs["report"]


def make_run_window(pool_cfg: pl.PoolConfig, opts: EngineOptions):
    """The window program: run(state, trace, step0) -> (state, outs
    [T, K, W], reports {key: [T]}), one CUDA graph replay per aligned
    window on the card, op by op otherwise (see the module docstring).
    `step0` is the op clock before the trace, which keeps the cadence
    aligned across successive calls; an int (anything else takes the
    generic shape, as in JAX)."""
    return _WindowRunner(pool_cfg, opts)


def make_trace(pool_cfg: pl.PoolConfig,
               steps: Sequence[Tuple[str, object, object]], *,
               k: Optional[int] = None, device=None) -> Dict:
    """Pack a list of (op, ids, values or None) into the fixed-shape trace
    `run_window` runs: each step's ids padded to `k` with -1, values padded
    with zeros and cast to the pool dtype. ids are host arrays (numpy,
    lists); values are host arrays or tensors. "op" stays a CPU int32
    tensor; "ids" and "values" go to `device` (the card unless "cpu" is
    asked for) without a sync."""
    device = resolve_device(device)
    if k is None:
        k = max([1] + [len(np.atleast_1d(ids)) for _, ids, _ in steps])
    w = pool_cfg.slot_words
    dtype = pl.torch_dtype(pool_cfg.dtype)
    t = len(steps)
    op_a = np.zeros((t,), np.int32)
    ids_a = np.full((t, k), -1, np.int32)
    vals = torch.zeros((t, k, w), dtype=dtype, device=device)
    for i, (op, ids, values) in enumerate(steps):
        op_a[i] = OP_CODES[op]
        ids = np.atleast_1d(np.asarray(ids, np.int32))
        assert len(ids) <= k, f"step {i}: {len(ids)} ops > k={k}"
        ids_a[i, :len(ids)] = ids
        if values is not None:
            if not isinstance(values, torch.Tensor):
                values = upload(np.asarray(values, np.float32), device)
            vals[i, :len(ids)] = values.reshape(-1, w).to(device, dtype)
    return {"op": torch.from_numpy(op_a), "ids": upload(ids_a, device),
            "values": vals}


def _copy_reports(reports) -> Tuple[List[str], List[List[float]]]:
    """The one device-to-host copy of `window_reports`, which also brings
    back the span recorder's pending stamp areas (`spans.fetch`): (keys,
    host floats [K][T] of the per-step layout, or [R][K] of a list)."""
    if isinstance(reports, dict):
        keys = list(reports)
        t = reports[keys[0]].numel()
        host = spans.fetch([reports[k].to(torch.float64) for k in keys])
        return keys, host.reshape(len(keys), t).tolist()
    keys = list(reports[0])
    host = spans.fetch([r[k].to(torch.float64).reshape(1)
                        for r in reports for k in keys])
    return keys, host.reshape(len(reports), len(keys)).tolist()


def _report_dicts(reports, keys: List[str], host: List[List[float]]
                  ) -> List[Dict[str, float]]:
    """The real collect reports as dicts, from `_copy_reports`' floats."""
    if isinstance(reports, dict):
        did = host[keys.index("did_collect")]
        return [{k: host[j][i] for j, k in enumerate(keys)}
                for i in range(len(did)) if did[i]]
    return [dict(zip(keys, row)) for row in host]


def window_reports(reports) -> List[Dict[str, float]]:
    """Host-side floats of the real collect reports, from the per-step
    layout {key: [T]} (`did_collect` marks them) or from a list of one
    report per collect (the server's): the one sync a window pays for
    them (a single device-to-host copy)."""
    if not isinstance(reports, dict) and not reports:
        return []
    return _report_dicts(reports, *_copy_reports(reports))


class Engine:
    """The window programs for one pool geometry and options.

    `run_window` / `serve_steps` are the production path (one graph replay
    per aligned window on the card); `step` is the per-op path the `Hades`
    wrapper uses (the collect fused into the op that closes a window).
    `device` follows the port's rule: the card unless "cpu" is asked for.

    The JAX engine donates the state it is given; here the pool's `data`
    is updated in place, so the state passed in shares it with the state
    returned: treat it as consumed, and keep the returned one. In graph
    mode the returned state is the engine's static carry, which the next
    aligned window overwrites. To run one loaded pool twice, clone every
    leaf first."""

    def __init__(self, pool_cfg: pl.PoolConfig,
                 opts: Optional[EngineOptions] = None, device=None):
        self.cfg = pool_cfg
        self.opts = opts or EngineOptions()
        self.backend = be.as_backend(self.opts.backend)
        self.device = resolve_device(device)
        self._run = make_run_window(pool_cfg, self.opts)

    @property
    def replays(self) -> int:
        """Aligned windows run as a graph replay so far."""
        return self._run.replays

    def init(self) -> Dict:
        """Fresh pool state with the backend's carried state seeded in."""
        return dict(pl.init(self.cfg, self.device),
                    bstate=self.backend.init(self.cfg, self.device))

    # -- fused path ---------------------------------------------------------
    def run_window(self, state: Dict, trace: Dict, step0: int = 0):
        """Execute `trace` (any number of steps and windows)."""
        return self._run(state, trace, step0)

    def serve_steps(self, state: Dict, trace: Dict, *, step0: int = 0,
                    window: Optional[int] = None):
        """Stream `trace` window by window (`window` steps per call, by
        default `collect_every`), reading each window's reports on the
        host between calls. Returns (state, outs [T, K, W], reports
        list). Each window is a host span "engine.window" (its index in
        the op stream: `window`) over "engine.prepare", "engine.launch"
        (the programs enqueued), "engine.wait" (the reports' one copy)
        and "engine.unpack"."""
        t = len(trace["op"])
        window = window or self.opts.collect_every
        outs, reps = [], []
        for lo in range(0, t, window):
            with spans.span("engine.window", window=(step0 + lo) // window):
                with spans.span("engine.prepare"):
                    chunk = {kk: v[lo:lo + window] for kk, v in trace.items()}
                with spans.span("engine.launch"):
                    state, out, rep = self._run(state, chunk, step0 + lo)
                with spans.span("engine.wait"):
                    host = _copy_reports(rep)
                with spans.span("engine.unpack"):
                    outs.append(out)
                    reps.extend(_report_dicts(rep, *host))
        if not outs:               # empty trace: clean no-op
            return state, torch.zeros_like(trace["values"]), reps
        return state, torch.cat(outs, dim=0), reps

    # -- per-op path ----------------------------------------------------------
    def step(self, state: Dict, op: str, ids, values=None, *,
             do_arm: bool = False, do_collect: bool = False):
        """One op (and the arm / collect the caller's clock asks for).
        Returns (state, read values or None, report)."""
        ids = (ids.to(self.device, _I32) if isinstance(ids, torch.Tensor)
               else upload(np.asarray(ids, np.int32), self.device))
        if isinstance(values, torch.Tensor):
            values = values.to(self.device)
        elif values is not None:
            values = upload(np.asarray(values), self.device)
        return apply_step(self.cfg, self.opts.collector, self.backend, state,
                          ids, values, op=op, do_arm=do_arm,
                          do_collect=do_collect)

    def collect_now(self, state: Dict):
        return collect_and_backend(self.cfg, self.opts.collector,
                                   self.backend, state)
