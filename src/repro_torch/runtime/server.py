"""Batched decode server with the HADES-managed paged KV cache (port of
`repro/runtime/server.py`).

A decode window runs W model steps — embed, then for each layer qkv, the
paged append into the pool, attention through the object table (which
sets access bits), the FFN; then logits and the next token — and, at the
window's close, the collector sweep, the budgeted migration, MIAD and the
tiering backend. Nothing inside a window reads a device value on the
host: the server syncs once per window, and `dispatches` counts one per
window.

The JAX package compiles each window into one jitted program with a
donated carry (`_win_serve` for `serve`, `_win_aligned` for aligned
`generate` / `decode_window` calls, `_win_generic` otherwise). The port
has one window body (`_run`, over `core.engine.run_window`: the host knows
the clock, so the arm and collect points are placed statically) and two
programs over it (`_window_body`: "window", and "serve", which applies the
lane events first). A window of whole collect periods from an aligned
clock runs, on a CUDA device, as ONE CUDA graph replay (the capture, the
static carry and the replay are `core/graphs.py`'s, which the object
engine shares):

  * the static carry: once a graph exists, every leaf of `self.state`
    plus the last tokens and the per-lane sampling parameters live in
    buffers the graphs read and write (`_to_static`); a captured body
    ends by copying each leaf the window replaced (the metadata is
    updated functionally) back into its buffer. The pool's `data` is
    updated in place and is never copied;
  * one static input per graph (`serve`'s int32 upload with the lane
    events, or the forced tokens) and its static outputs;
  * the graphs are cached by program, length, sampling and what they read
    of `params` (each leaf's address, shape, strides and dtype), keep only
    the graphs of the latest params, and share one memory pool. A shape's
    first window runs eagerly on the capture stream (it is real and
    counts), then is captured there; replays start from the next window.
    A sampled graph holds the server's own generator
    (`CUDAGraph.register_generator_state`). A capture that fails raises:
    nothing falls back to the eager path.

Every other window (`decode_step`, unaligned `decode_window`) runs op by
op, as JAX keeps `_win_generic`; so does every window on the CPU, and on
CUDA with the private `_eager` set (the tests and `chip_smoke.py` compare
the two modes that way).

Both programs are span recorder programs (`repro_torch/spans.py`): their
stamps close "lanes" (the serve program's lane events), in the window's
first step four segments a layer ("model" up to the KV append, then
"kv.append" with the table lookup, "attention" for `paged_attention`,
"kv.record" for the access accounting) and "model" for the rest of the
step with its sampling, then one "step" a later step, the collector's
segments, "backend", and "pack". `serve`'s packed output and the stamps
share one buffer and its one copy; `serve` records the host spans
"serve.call" > "serve.window" > "serve.schedule", "serve.upload",
"serve.launch", "serve.wait", "serve.unpack", and the request events
"admit", "first_token" and "finish".

`overlap_collect=True` arms the ATC epoch one step before each window
closes, so objects dereferenced by the closing step carry ATC > 0 and do
not move. `Server.serve` is the continuous-batching driver: lanes go
admit -> decode -> finish (EOS / max_new / lane capacity) -> free ->
refill, with lane events resolved at window boundaries.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import spans
from repro_torch.core import backend as be
from repro_torch.core import collector as col
from repro_torch.core import engine as eng
from repro_torch.core import graphs
from repro_torch.core import pool as pl
from repro_torch.device import upload
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
    """Decode-only server for the attention decoders: dense, MoE and the
    VLM backbone (text only: M-RoPE with t == h == w). An encoder-decoder
    is refused: the paged pool holds no encoder memory, and its decoder
    without cross attention would be another model (JAX's server runs it
    so, silently)."""

    def __init__(self, model, cfg: ServerConfig):
        if model.cfg.block_pattern:
            raise ValueError("paged serving targets attention archs")
        if model.cfg.is_encoder_decoder:
            raise ValueError(
                f"{model.cfg.name} is an encoder-decoder: paged serving "
                "has no encoder memory, and its decoder needs cross "
                "attention over one")
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
        # True runs every window op by op on CUDA too (tests, chip_smoke)
        self._eager = False
        self._g = graphs.WindowGraphs(self.device)
        self._gen = torch.Generator(device=self.device)
        self.reset()

    # -- the decode transition ------------------------------------------------
    def _model_step(self, params, state, tok):
        """tok [B] -> (state', logits [B, V]). Each layer derives qkv from
        the current residual stream, appends its k/v to the paged pool and
        attends through the object table, then runs its FFN or MoE (whose
        expert counts are dropped, as in JAX); pos still points AT the new
        token during the layers, so the token attends to itself via
        pos + 1."""
        mc = self.model.cfg
        cfg = self.kv_cfg
        x = L.embed(params["embed"], tok)[:, None, :]        # [B,1,D]
        positions = state["pos"][:, None]
        for li, lp in enumerate(params["layers"]):
            def attend(q, k, v, st=state, li=li):
                spans.stamp("model")
                st = kvc.append_layer(cfg, st, li, k[:, 0], v[:, 0])
                out, st = kvc.attend(cfg, st, li, q[:, 0],
                                     seq_lens=st["pos"] + 1)
                return out[:, None], st
            x, state, _ = T.decode_layer_step(lp, x, mc, positions, attend)
        state = kvc.advance_pos(state)
        h = L.rms_norm(x, params["final_ln"], mc.norm_eps)
        out_t = params["embed"].T if mc.tie_embeddings else params["out"]
        return state, L.logits_head(out_t, h)[:, 0]

    def _step(self, params, do_sample, carry, forced):
        """One window step: forced token (>= 0) or self-feed the previous
        one; inactive lanes decode a pinned pad token. A program's first
        step is stamped layer by layer, a later one as one "step"."""
        first = spans.first_step()
        with spans.quiet(not first):
            tok = torch.where(forced >= 0, forced, carry["tok"])
            tok = torch.where(carry["kv"]["active"], tok, 0)
            kv, logits = self._model_step(params, carry["kv"], tok)
            if do_sample:
                nxt = sampling.sample(logits, carry["temp"], carry["topk"],
                                      generator=self._gen)
            else:
                nxt = torch.argmax(logits, -1).to(_I32)
        spans.stamp("model" if first else "step")
        return dict(carry, kv=kv, tok=nxt), {"logits": logits, "tok": nxt}

    def _collect(self, carry):
        kv, report = kvc.collect_and_backend(self.kv_cfg, self.col_cfg,
                                             self.backend, carry["kv"])
        return dict(carry, kv=kv), report

    @staticmethod
    def _arm(carry):
        return dict(carry, kv=kvc.arm(carry["kv"]))

    def _run(self, params, do_sample: bool, carry: Dict, toks: torch.Tensor,
             clock: int):
        """The window body, pure: toks [B, T] (>= 0 forced, < 0 self-feed)
        from op clock `clock` -> (carry', per-step outputs, collect
        reports)."""
        return eng.run_window(
            lambda c, f: self._step(params, do_sample, c, f), self._collect,
            self._arm, carry, list(toks.T), clock,
            every=self.cfg.collect_every, overlap=self.cfg.overlap_collect)

    # -- the window programs --------------------------------------------------
    def _window_body(self, name: str, params, do_sample: bool,
                     clock: int) -> Callable:
        """Program `name` from op clock `clock` as (carry, x) ->
        (carry', outs), over `_run`:

          "window": x = forced tokens [B, T]; outs {"logits" [B, T, V],
                    "tok" [B, T], "reports" [one per collect]}
          "serve":  x = `serve`'s int32 upload [free B | admit B | top-k B
                    | tokens B*W | temperature B as int32 bits]; the lane
                    events run at the entry (finished lanes free their KV,
                    admitted lanes take their sampling parameters); outs
                    {"packed": float64 [sampled B*W, KV RSS bytes, live
                    blocks, each report's REPORT_KEYS]}, what the window's
                    close copies to the host in one go."""

        def window(carry, toks):
            with spans.program("window", toks.device):
                carry, outs, reports = self._run(params, do_sample, carry,
                                                 toks, clock)
                outs = {
                    "logits": torch.stack([o["logits"] for o in outs], dim=1),
                    "tok": torch.stack([o["tok"] for o in outs], dim=1),
                    "reports": reports}
                spans.stamp("pack")
            return carry, outs

        def serve(carry, inp):
            b, every = self.cfg.batch, self.cfg.collect_every
            w = inp.shape[0] // b - 4
            n_rep = (clock + w) // every - clock // every
            n_packed = b * w + 2 + n_rep * len(eng.REPORT_KEYS)
            with spans.program("serve", inp.device, n_packed) as prog:
                free, admit = inp[:b].bool(), inp[b:2 * b].bool()
                topk = inp[2 * b:3 * b]
                temp = inp[(3 + w) * b:].view(torch.float32)
                kv = kvc.free_lanes(self.kv_cfg, carry["kv"], free)
                carry = dict(carry, kv=kvc.admit_lanes(kv, admit),
                             temp=torch.where(admit, temp, carry["temp"]),
                             topk=torch.where(admit, topk, carry["topk"]))
                spans.stamp("lanes")
                carry, outs, reports = self._run(
                    params, do_sample, carry,
                    inp[3 * b:(3 + w) * b].view(b, w), clock)
                kv = carry["kv"]
                sampled = torch.stack([o["tok"] for o in outs], dim=1)
                gauges = [pl.rss_bytes(self.kv_cfg.pool_config(), kv["pool"]),
                          (kv["block_tables"] >= 0).sum()]
                vals = gauges + [r[k] for r in reports
                                 for k in eng.REPORT_KEYS]
                parts = [sampled.flatten().double(),
                         torch.stack([v.double() for v in vals])]
                # the packed output shares its buffer, and so its copy,
                # with the stamps
                packed = torch.cat(parts) if prog is None else \
                    torch.cat(parts, out=prog.payload)
                spans.stamp("pack")
            return carry, {"packed": packed}

        return {"window": window, "serve": serve}[name]

    def _carry(self) -> Dict:
        return {"kv": self.state, "tok": self._last_tok, "temp": self._temp,
                "topk": self._topk}

    def _uncarry(self, carry: Dict) -> None:
        self.state, self._last_tok = carry["kv"], carry["tok"]
        self._temp, self._topk = carry["temp"], carry["topk"]

    @staticmethod
    def _params_key(params) -> tuple:
        """What a graph reads of `params`: each leaf's address, shape,
        strides and dtype. A leaf replaced in the dict changes the key; a
        leaf updated in place does not, and the graph reads its new
        values."""
        return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                     for t in pytree.tree_leaves(params))

    def _dispatch(self, name: str, params, x: torch.Tensor, t: int) -> Dict:
        """Run program `name` for `t` steps on its device input `x`: one
        graph replay for whole collect periods from an aligned clock on
        CUDA, else op by op. The "window" program's outputs are the
        caller's; "serve"'s packed output is read before the next
        window."""
        do_sample = self._sample_in_scan
        body = self._window_body(name, params, do_sample, self._steps)
        every = self.cfg.collect_every
        graph = (self.device.type == "cuda" and not self._eager and t > 0
                 and t % every == 0 and self._steps % every == 0)
        self._steps += t
        self.dispatches += 1
        if not graph:
            carry, outs = body(self._carry(), x)
            self._uncarry(carry)
            return outs
        pkey = self._params_key(params)
        key = (name, tuple(x.shape), do_sample, pkey)
        g = self._g.graphs.get(key)
        if g is None:
            # graphs of earlier params would hold their pool memory for good
            self._g.graphs = {k: v for k, v in self._g.graphs.items()
                              if k[3] == pkey}
            carry, outs = self._g.first_window(
                key, body, self._carry(), x, self._adopt,
                self._gen if do_sample else None)
            self._uncarry(carry)
            return outs
        self._to_static()
        outs = self._g.replay(g, x)
        self.replays += 1
        if name == "window":
            return pytree.tree_map(torch.clone, outs)
        return outs

    @property
    def _graphs(self) -> Dict[tuple, graphs.Graph]:
        """The captured window programs, by (program, input shape,
        sampling, params key)."""
        return self._g.graphs

    @staticmethod
    def _adopt(carry: Dict) -> torch.Tensor:
        """The leaf the static carry adopts: the pool's `data`."""
        return carry["kv"]["pool"]["data"]

    def _to_static(self) -> None:
        """Bind the carry to the static carry the graphs read and write
        (`graphs.WindowGraphs.bind`): the first time, the current leaves
        are cloned into it, except the pool's `data`, which is adopted as
        it is; after that, each leaf rebound since (by `reset`, an eager
        window or `serve`'s hand-back) is copied into its buffer."""
        self._uncarry(self._g.bind(self._carry(), self._adopt))

    def _write_back(self, carry: Dict) -> None:
        """The end of a captured body (`graphs.WindowGraphs.write_back`)."""
        self._g.write_back(carry)

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        """A host array on the server's device, without a sync
        (`device.upload`)."""
        return upload(host, self.device)

    def _tokens(self, tokens) -> torch.Tensor:
        if isinstance(tokens, torch.Tensor):
            return tokens.to(device=self.device, dtype=_I32)
        return self._upload(np.asarray(tokens, np.int32))

    # -- one decode step / one window -----------------------------------------
    def decode_step(self, params, tokens) -> Tuple[torch.Tensor, None]:
        """tokens: [B] -> (logits [B, V], None). One step of the window
        protocol (arm / collect when the clock says so); the per-step
        reference for `decode_window`."""
        outs = self._dispatch("window", params,
                              self._tokens(tokens)[:, None], 1)
        self.reports.extend(eng.window_reports(outs["reports"]))
        return outs["logits"][:, 0], None

    def decode_window(self, params, tokens, w: Optional[int] = None):
        """Run a whole decode window. tokens: [B, T] — entries >= 0 are
        teacher-forced, < 0 self-feed the previous token; or [B] (a seed
        token per lane) with `w`, running `w` steps. Returns (logits
        [B, T, V], sampled [B, T], collect reports of the window — feed to
        engine.window_reports). T a multiple of collect_every from an
        aligned clock is a graph replay on CUDA."""
        toks = self._tokens(tokens)
        if toks.dim() == 1:
            toks = torch.cat([toks[:, None], torch.full(
                (toks.shape[0], (w or 1) - 1), -1, dtype=_I32,
                device=self.device)], dim=1)
        outs = self._dispatch("window", params, toks, toks.shape[1])
        return outs["logits"], outs["tok"], outs["reports"]

    # -- generate -------------------------------------------------------------
    def generate(self, params, prompts, max_new: int, *, greedy: bool = True,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """prompts: [B, P], teacher-forced through the decode windows, then
        `max_new` tokens, W = cfg.window or collect_every steps per window.
        `greedy=False` samples with cfg.temperature/cfg.top_k on every lane
        and REQUIRES a `generator` on the server's device; the server draws
        from its own generator, set to `generator`'s state (which does not
        advance)."""
        if not greedy and generator is None:
            raise ValueError("generate(greedy=False) needs a torch.Generator")
        prompts = self._tokens(prompts)
        b, p = prompts.shape
        if generator is not None:
            self._gen.set_state(generator.get_state())
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
        on the host, upload them with the window's forced tokens (prompt
        tokens per lane, -1 self-feeds) in one copy, run the "serve"
        program (finished lanes free ALL their KV through the pool op
        stream, queued requests admit, then W steps and the collects: one
        graph replay on CUDA), and sync once — the sampled tokens, the
        collect reports and the RSS gauges in one device-to-host copy — to
        schedule the lanes. Sampling draws from the server's generator, set
        to `generator`'s state. A lane finishes on EOS, on its max_new, or
        at lane capacity (max_len). The final lanes drain through one
        all-inactive window so every request's KV leaves the pool. Returns
        one `Completion` per request, in order."""
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
            self._gen.set_state(generator.get_state())
        queue = collections.deque(enumerate(requests))
        lanes: List[Optional[_Lane]] = [None] * b
        results: List[Optional[Completion]] = [None] * len(requests)
        if max_windows is None:
            max_windows = 2 + sum(
                -(-(len(r.prompt) + r.max_new) // w) + 1 for r in requests)
        window_idx = 0
        dev = self.device
        pcfg = self.kv_cfg.pool_config()
        with spans.span("serve.call") as call:
            cid = None if call is None else call.id
            while True:
                t_window = spans.now()
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
                        lanes[i] = _Lane(rid=rid, req=req,
                                         admitted_at=window_idx)
                        admit[i] = True
                        temp[i] = req.temperature
                        topk[i] = req.top_k
                        spans.event("admit", rid=rid, call=cid,
                                    window=window_idx)
                if not any(lanes) and not free.any():
                    break
                if window_idx >= max_windows:
                    raise RuntimeError(
                        f"serve exceeded max_windows={max_windows}")

                toks = np.zeros((b, w), np.int32)
                for i, ln in enumerate(lanes):
                    if ln is None:
                        continue
                    row = np.full((w,), -1, np.int32)
                    prompt = ln.req.prompt
                    n_force = min(max(len(prompt) - ln.steps, 0), w)
                    row[:n_force] = prompt[ln.steps:ln.steps + n_force]
                    toks[i] = row

                # lane events at the window entry, then W steps + collects:
                # the window's inputs go to the device in one copy
                host = np.concatenate([free, admit, topk, toks.ravel(),
                                       temp.view(np.int32)]).astype(np.int32)
                with spans.span("serve.window", start=t_window, call=cid,
                                window=window_idx):
                    # the lane events and the upload's host array, done
                    # before the window could be told from the final check
                    with spans.span("serve.schedule", start=t_window):
                        pass
                    with spans.span("serve.upload"):
                        x = self._upload(host)
                    with spans.span("serve.launch"):
                        outs = self._dispatch("serve", params, x, w)
                    window_idx += 1

                    # the window's one sync: tokens, gauges, reports and
                    # the program's stamps together
                    with spans.span("serve.wait"):
                        host = spans.fetch([outs["packed"]]).tolist()
                    with spans.span("serve.unpack"):
                        self._unpack(host, lanes, cid, window_idx - 1)
                        self.serve_log.append({
                            "window": window_idx,
                            "active": sum(ln is not None for ln in lanes),
                            "admitted": int(admit.sum()),
                            "freed": int(free.sum()),
                            "queued": len(queue),
                            "rss_bytes": host[b * w],
                            "live_bytes": host[b * w + 1] * pcfg.slot_bytes,
                        })
        assert all(r is not None for r in results)
        # hand the server back in the fixed-batch contract (all lanes live)
        self.state = dict(self.state, active=torch.ones(
            (b,), dtype=torch.bool, device=dev))
        self._sample_in_scan = False
        return results

    def _unpack(self, host: List[float], lanes: List[Optional[_Lane]],
                call: Optional[int], window: int) -> None:
        """A serve window's host part after its copy: the collect reports,
        then each lane's sampled tokens, which finish it on EOS, max_new or
        lane capacity."""
        b, w = self.cfg.batch, self.cfg.window or self.cfg.collect_every
        n_keys = len(eng.REPORT_KEYS)
        sampled = np.asarray(host[:b * w], np.int64).reshape(b, w)
        vals = host[b * w + 2:]
        for j in range(w // self.cfg.collect_every):
            self.reports.append(dict(zip(
                eng.REPORT_KEYS, vals[j * n_keys:(j + 1) * n_keys])))
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
                ln.out.append(int(sampled[i, t]))
                if len(ln.out) == 1:
                    spans.event("first_token", rid=ln.rid, call=call,
                                window=window)
                if ln.out[-1] == self.cfg.eos_token:
                    ln.done, ln.reason = True, "eos"
                elif len(ln.out) >= ln.req.max_new:
                    ln.done, ln.reason = True, "length"
                elif s + 1 >= self.cfg.max_len:
                    ln.done, ln.reason = True, "length"
            if ln.done:
                spans.event("finish", rid=ln.rid, call=call, window=window)
            ln.steps += w

    def reset(self, active: bool = True) -> None:
        """Fresh serving state (empty pool, zeroed clock, reports and
        sampling state). `active=False` starts every lane empty. Once a
        graph exists the fresh values are copied into the static carry,
        which the graphs go on reading; the captured graphs are kept."""
        self.state = kvc.init(self.kv_cfg, backend=self.backend,
                              active=active, device=self.device)
        b = self.cfg.batch
        self._steps = 0
        self._last_tok = torch.zeros(b, dtype=_I32, device=self.device)
        self._gen.manual_seed(0)
        self._temp = torch.zeros(b, dtype=torch.float32, device=self.device)
        self._topk = torch.zeros(b, dtype=_I32, device=self.device)
        if self._g.static is not None:
            # the graphs read the static carry: write the fresh state into it
            self._to_static()
        self._sample_in_scan = False
        self.reports = []
        self.serve_log = []
        self.dispatches = 0
        self.replays = 0                   # windows run as a graph replay

    # -- metrics --------------------------------------------------------------
    def kv_rss_bytes(self) -> float:
        return float(pl.rss_bytes(self.kv_cfg.pool_config(),
                                  self.state["pool"]))

    def kv_live_bytes(self) -> float:
        """Bytes of LIVE KV objects (allocated blocks x slot bytes)."""
        n = int((self.state["block_tables"] >= 0).sum())
        return float(n * self.kv_cfg.pool_config().slot_bytes)
