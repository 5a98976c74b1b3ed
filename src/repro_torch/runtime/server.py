"""Batched decode server with the HADES-managed paged KV cache (port of
`repro/runtime/server.py`).

A decode window runs W model steps — embed, then for each layer qkv, the
paged append into the pool, attention through the object table (which
sets access bits), the FFN; then logits and the next token — and, at the
window's close, the collector sweep, the budgeted migration, MIAD and the
tiering backend. The JAX package compiles a window into one `lax.scan`;
here it is one Python loop over the steps with the layers as an inner
loop, the clock known on the host (`core.engine.run_window`). Nothing
inside a window reads a device value on the host: the server syncs once
per window, and `dispatches` counts one per window.

`overlap_collect=True` arms the ATC epoch one step before each window
closes, so objects dereferenced by the closing step carry ATC > 0 and do
not move. `Server.serve` is the continuous-batching driver: lanes go
admit -> decode -> finish (EOS / max_new / lane capacity) -> free ->
refill, with lane events resolved at window boundaries.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import backend as be
from repro_torch.core import collector as col
from repro_torch.core import engine as eng
from repro_torch.core import pool as pl
from repro_torch.models import kvcache as kvc
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.runtime import sampling

_I32 = torch.int32


@dataclasses.dataclass
class ServerConfig:
    batch: int = 8
    max_len: int = 256
    block_tokens: int = 16
    collect_every: int = 8
    # tiering backend: a registered name (backend.names()) + its params
    backend: str = "proactive"
    backend_params: Optional[Dict] = None
    eos_token: int = 2
    # decode-window length W of `generate`/`serve` (0 -> collect_every)
    window: int = 0
    # arm the ATC epoch one step before each window closes
    overlap_collect: bool = False
    # sampling defaults of `generate(greedy=False)`: temperature <= 0 is
    # greedy argmax, top_k <= 0 keeps the full vocab
    temperature: float = 1.0
    top_k: int = 0


@dataclasses.dataclass
class Request:
    """One generation request for `Server.serve`. temperature <= 0 decodes
    greedily; top_k <= 0 disables the top-k filter."""
    prompt: Sequence[int]
    max_new: int = 32
    temperature: float = 0.0
    top_k: int = 0


@dataclasses.dataclass
class Completion:
    """`Server.serve`'s per-request result: the generated tokens (EOS
    included when it fired), "eos" or "length", and the [admitted,
    finished] window-index span the request held a lane for."""
    rid: int
    tokens: List[int]
    finish_reason: str
    windows: Tuple[int, int]


@dataclasses.dataclass
class _Lane:
    rid: int
    req: Request
    admitted_at: int
    steps: int = 0
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    reason: str = ""


class Server:
    """Decode-only server for the dense attention decoder."""

    def __init__(self, model, cfg: ServerConfig):
        if model.cfg.block_pattern:
            raise ValueError("paged serving targets attention archs")
        self.model = model
        self.cfg = cfg
        self.device = model.device
        mc = model.cfg
        self.kv_cfg = kvc.KVCacheConfig(
            num_layers=mc.num_layers, batch=cfg.batch,
            max_blocks=-(-cfg.max_len // cfg.block_tokens),
            block_tokens=cfg.block_tokens, num_kv_heads=mc.num_kv_heads,
            head_dim=mc.resolved_head_dim, dtype=mc.dtype)
        self.col_cfg = col.CollectorConfig()
        self.backend = be.make(cfg.backend, **(cfg.backend_params or {}))
        self.reports: List[Dict] = []
        self.serve_log: List[Dict] = []
        self.reset()

    # -- the decode transition ------------------------------------------------
    def _model_step(self, params, state, tok):
        """tok [B] -> (state', logits [B, V]). Each layer derives qkv from
        the current residual stream, appends its k/v to the paged pool and
        attends through the object table; pos still points AT the new token
        during the layers, so the token attends to itself via pos + 1."""
        mc = self.model.cfg
        cfg = self.kv_cfg
        x = L.embed(params["embed"], tok)[:, None, :]        # [B,1,D]
        positions = state["pos"][:, None]
        for li, lp in enumerate(params["layers"]):
            def attend(q, k, v, st=state, li=li):
                st = kvc.append_layer(cfg, st, li, k[:, 0], v[:, 0])
                out, st = kvc.attend(cfg, st, li, q[:, 0],
                                     seq_lens=st["pos"] + 1)
                return out[:, None], st
            x, state = T.decode_layer_step(lp, x, mc, positions, attend)
        state = kvc.advance_pos(state)
        h = L.rms_norm(x, params["final_ln"], mc.norm_eps)
        out_t = params["embed"].T if mc.tie_embeddings else params["out"]
        return state, L.logits_head(out_t, h)[:, 0]

    def _step(self, params, do_sample, carry, forced):
        """One window step: forced token (>= 0) or self-feed the previous
        one; inactive lanes decode a pinned pad token."""
        tok = torch.where(forced >= 0, forced, carry["tok"])
        tok = torch.where(carry["kv"]["active"], tok, 0)
        kv, logits = self._model_step(params, carry["kv"], tok)
        if do_sample:
            nxt = sampling.sample(logits, carry["temp"], carry["topk"],
                                  generator=self._gen)
        else:
            nxt = torch.argmax(logits, -1).to(_I32)
        return dict(carry, kv=kv, tok=nxt), {"logits": logits, "tok": nxt}

    def _collect(self, carry):
        kv, report = kvc.collect_and_backend(self.kv_cfg, self.col_cfg,
                                             self.backend, carry["kv"])
        return dict(carry, kv=kv), report

    @staticmethod
    def _arm(carry):
        return dict(carry, kv=kvc.arm(carry["kv"]))

    def _run(self, params, toks: torch.Tensor):
        """toks [B, T] (>= 0 forced, < 0 self-feed) -> (logits [B,T,V],
        sampled [B,T], collect reports), the carry advanced by T steps."""
        carry = {"kv": self.state, "tok": self._last_tok, "temp": self._temp,
                 "topk": self._topk}
        do_sample = self._sample_in_scan
        carry, outs, reports = eng.run_window(
            lambda c, f: self._step(params, do_sample, c, f), self._collect,
            self._arm, carry, list(toks.T), self._steps,
            every=self.cfg.collect_every, overlap=self.cfg.overlap_collect)
        self.state, self._last_tok = carry["kv"], carry["tok"]
        self._temp, self._topk = carry["temp"], carry["topk"]
        self._steps += toks.shape[1]
        logits = torch.stack([o["logits"] for o in outs], dim=1)
        sampled = torch.stack([o["tok"] for o in outs], dim=1)
        return logits, sampled, reports

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        """A host array on the server's device. On CUDA the copy goes
        through pinned memory without blocking: a copy from pageable
        memory would wait for the device, a sync the window cannot
        afford."""
        t = torch.from_numpy(np.ascontiguousarray(host))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            return tokens.to(device=self.device, dtype=_I32)
        return self._upload(np.asarray(tokens, np.int32))

    # -- one decode step / one window -----------------------------------------
    def decode_step(self, params, tokens) -> Tuple[torch.Tensor, None]:
        """tokens: [B] -> (logits [B, V], None). One step of the window
        protocol (arm / collect when the clock says so); the per-step
        reference for `decode_window`."""
        logits, _, reports = self._run(params, self._tokens(tokens)[:, None])
        self.dispatches += 1
        self.reports.extend(eng.window_reports(reports))
        return logits[:, 0], None

    def decode_window(self, params, tokens, w: Optional[int] = None):
        """Run a whole decode window. tokens: [B, T] — entries >= 0 are
        teacher-forced, < 0 self-feed the previous token; or [B] (a seed
        token per lane) with `w`, running `w` steps. Returns (logits
        [B, T, V], sampled [B, T], collect reports of the window — feed to
        engine.window_reports)."""
        toks = self._tokens(tokens)
        if toks.dim() == 1:
            toks = torch.cat([toks[:, None], torch.full(
                (toks.shape[0], (w or 1) - 1), -1, dtype=_I32,
                device=self.device)], dim=1)
        logits, sampled, reports = self._run(params, toks)
        self.dispatches += 1
        return logits, sampled, reports

    # -- generate -------------------------------------------------------------
    def generate(self, params, prompts, max_new: int, *, greedy: bool = True,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """prompts: [B, P], teacher-forced through the decode windows, then
        `max_new` tokens, W = cfg.window or collect_every steps per window.
        `greedy=False` samples with cfg.temperature/cfg.top_k on every lane
        and REQUIRES a `generator` on the server's device."""
        if not greedy and generator is None:
            raise ValueError("generate(greedy=False) needs a torch.Generator")
        prompts = self._tokens(prompts)
        b, p = prompts.shape
        if generator is not None:
            self._gen = generator
        self._sample_in_scan = not greedy
        temp = 0.0 if greedy else self.cfg.temperature
        self._temp = torch.full((b,), temp, dtype=torch.float32,
                                device=self.device)
        self._topk = torch.full((b,), 0 if greedy else self.cfg.top_k,
                                dtype=_I32, device=self.device)
        if max_new <= 0:
            return torch.zeros((b, 0), dtype=_I32, device=self.device)
        total = p + max_new - 1
        forced = torch.cat([prompts, torch.full((b, max_new - 1), -1,
                                                dtype=_I32,
                                                device=self.device)], dim=1)
        w = self.cfg.window or self.cfg.collect_every
        sampled = []
        for lo in range(0, total, w):
            _, toks, reports = self.decode_window(params, forced[:, lo:lo + w])
            sampled.append(toks)
            self.reports.extend(eng.window_reports(reports))
        return torch.cat(sampled, dim=1)[:, p - 1:]

    # -- continuous batching --------------------------------------------------
    def serve(self, params, requests: Sequence[Request], *,
              generator: Optional[torch.Generator] = None,
              max_windows: Optional[int] = None) -> List[Completion]:
        """Continuous-batching queue driver. Each window: resolve lane events
        on the host (finished lanes free ALL their KV through the pool op
        stream, queued requests admit), build the window's forced tokens
        (prompt tokens per lane, -1 self-feeds), run the window, and sync
        once — the sampled tokens, the collect reports and the RSS gauges in
        one device-to-host copy — to schedule the lanes. A lane finishes on
        EOS, on its max_new, or at lane capacity (max_len). The final lanes
        drain through one all-inactive window so every request's KV leaves
        the pool. Returns one `Completion` per request, in order."""
        w = self.cfg.window or self.cfg.collect_every
        every = self.cfg.collect_every
        if w % every != 0:
            raise ValueError(f"serve needs window ({w}) aligned to "
                             f"collect_every ({every})")
        b = self.cfg.batch
        do_sample = any(r.temperature > 0 for r in requests)
        if generator is None and do_sample:
            raise ValueError("serve() got sampled requests (temperature > 0) "
                             "but no torch.Generator")
        for rid, r in enumerate(requests):
            if not 0 < len(r.prompt) < self.cfg.max_len:
                raise ValueError(
                    f"request {rid}: prompt length {len(r.prompt)} must be "
                    f"in [1, max_len={self.cfg.max_len})")
            if r.max_new < 1:
                raise ValueError(f"request {rid}: max_new={r.max_new} — a "
                                 "lane always emits at least one token")
        self.reset(active=False)
        self._sample_in_scan = do_sample
        if generator is not None:
            self._gen = generator
        queue = collections.deque(enumerate(requests))
        lanes: List[Optional[_Lane]] = [None] * b
        results: List[Optional[Completion]] = [None] * len(requests)
        if max_windows is None:
            max_windows = 2 + sum(
                -(-(len(r.prompt) + r.max_new) // w) + 1 for r in requests)
        window_idx = 0
        dev = self.device
        pcfg = self.kv_cfg.pool_config()
        while True:
            free = np.zeros((b,), bool)
            admit = np.zeros((b,), bool)
            temp = np.zeros((b,), np.float32)
            topk = np.zeros((b,), np.int32)
            for i in range(b):
                ln = lanes[i]
                if ln is not None and ln.done:
                    free[i] = True
                    results[ln.rid] = Completion(
                        ln.rid, ln.out, ln.reason,
                        (ln.admitted_at, window_idx))
                    lanes[i] = None
                if lanes[i] is None and queue:
                    rid, req = queue.popleft()
                    lanes[i] = _Lane(rid=rid, req=req, admitted_at=window_idx)
                    admit[i] = True
                    temp[i] = req.temperature
                    topk[i] = req.top_k
            if not any(lanes) and not free.any():
                break
            if window_idx >= max_windows:
                raise RuntimeError(f"serve exceeded max_windows={max_windows}")

            toks = np.zeros((b, w), np.int32)
            for i, ln in enumerate(lanes):
                if ln is None:
                    continue
                row = np.full((w,), -1, np.int32)
                prompt = ln.req.prompt
                n_force = min(max(len(prompt) - ln.steps, 0), w)
                row[:n_force] = prompt[ln.steps:ln.steps + n_force]
                toks[i] = row

            # lane events at the window entry, then W steps + collect; the
            # window's inputs go to the device in one copy
            host = np.concatenate([free, admit, topk, toks.ravel(),
                                   temp.view(np.int32)]).astype(np.int32)
            inp = self._upload(host)
            free_t, admit_t = inp[:b].bool(), inp[b:2 * b].bool()
            kv = kvc.free_lanes(self.kv_cfg, self.state, free_t)
            self.state = kvc.admit_lanes(kv, admit_t)
            self._temp = torch.where(
                admit_t, inp[3 * b + b * w:].view(torch.float32), self._temp)
            self._topk = torch.where(admit_t, inp[2 * b:3 * b], self._topk)
            _, sampled, reports = self._run(
                params, inp[3 * b:3 * b + b * w].view(b, w))
            self.dispatches += 1
            window_idx += 1

            # the window's one sync: tokens, reports and gauges together
            rss = pl.rss_bytes(pcfg, self.state["pool"])
            live = (self.state["block_tables"] >= 0).sum()
            gauges = torch.stack([rss.double(), live.double()])
            n_rep = len(reports)
            keys = list(reports[0]) if reports else []
            rep_vals = [r[k].double() for r in reports for k in keys]
            host = torch.cat([sampled.flatten().double(), gauges,
                              torch.stack(rep_vals) if rep_vals else
                              gauges[:0]]).cpu().tolist()
            sampled_h = np.asarray(host[:b * w], np.int64).reshape(b, w)
            rss_h, live_h = host[b * w], host[b * w + 1]
            vals = host[b * w + 2:]
            for j in range(n_rep):
                self.reports.append(dict(zip(
                    keys, vals[j * len(keys):(j + 1) * len(keys)])))

            for i, ln in enumerate(lanes):
                if ln is None:
                    continue
                p = len(ln.req.prompt)
                for t in range(w):
                    if ln.done:
                        break
                    s = ln.steps + t
                    if s < p - 1:
                        continue
                    ln.out.append(int(sampled_h[i, t]))
                    if ln.out[-1] == self.cfg.eos_token:
                        ln.done, ln.reason = True, "eos"
                    elif len(ln.out) >= ln.req.max_new:
                        ln.done, ln.reason = True, "length"
                    elif s + 1 >= self.cfg.max_len:
                        ln.done, ln.reason = True, "length"
                ln.steps += w
            self.serve_log.append({
                "window": window_idx,
                "active": sum(ln is not None for ln in lanes),
                "admitted": int(admit.sum()), "freed": int(free.sum()),
                "queued": len(queue),
                "rss_bytes": rss_h,
                "live_bytes": live_h * pcfg.slot_bytes,
            })
        assert all(r is not None for r in results)
        # hand the server back in the fixed-batch contract (all lanes live)
        self.state = dict(self.state, active=torch.ones(
            (b,), dtype=torch.bool, device=dev))
        self._sample_in_scan = False
        return results

    def reset(self, active: bool = True) -> None:
        """Fresh serving state (empty pool, zeroed clock, reports and
        sampling state). `active=False` starts every lane empty."""
        self.state = kvc.init(self.kv_cfg, backend=self.backend,
                              active=active, device=self.device)
        b = self.cfg.batch
        self._steps = 0
        self._last_tok = torch.zeros(b, dtype=_I32, device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self._temp = torch.zeros(b, dtype=torch.float32, device=self.device)
        self._topk = torch.zeros(b, dtype=_I32, device=self.device)
        self._sample_in_scan = False
        self.reports = []
        self.serve_log = []
        self.dispatches = 0

    # -- metrics --------------------------------------------------------------
    def kv_rss_bytes(self) -> float:
        return float(pl.rss_bytes(self.kv_cfg.pool_config(),
                                  self.state["pool"]))

    def kv_live_bytes(self) -> float:
        """Bytes of LIVE KV objects (allocated blocks x slot bytes)."""
        n = int((self.state["block_tables"] >= 0).sum())
        return float(n * self.kv_cfg.pool_config().slot_bytes)
