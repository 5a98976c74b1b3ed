"""A served model as a benchmark cell: `repro_torch.runtime.server.Server`
driven by a closed loop of `serve` calls, each call the mix's requests
queued at its start (`gen.serve_call`), greedy, with no stop token, so
every request runs to its max_new.

Set-up: the kernels (`kernels/build.py` `build_all`, cached in
`build/kernels/`), the weights drawn on the device from the seed in the
layout of `Model.param_specs()` in a few large calls, the server, and one
short warm-up call, which captures the serve window's CUDA graph.

The window: whole calls; another starts only while the time so far plus
the last call's length stays within the seconds. At each window's close
the harness recounts the pool's resident bytes on the device from the
slot owners and the superblock tiers (`resident_frac`, over the plain
lane model's live bytes). With `trace`, one more call follows the
window, and a stretch of its windows runs under torch.profiler
(`tracing`), taken again further on when the trace is not whole; that
call ends once the stretch has been read.

`correct` (`check`), once the window has closed: the widest gap by which
a served token's logit lies below the best of the plain fp32 reference's
(`reference/glm.py`), over a sample of finished requests drawn from the
seed, the longest among them; and the pool's accounting against the
plain lane model (`reference/schedule.py`): the live blocks at every
window's close, the server's resident-bytes gauge against the harness's
recount at every close, and at one window's entry the object table, the
slot owners and the superblock occupancy.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from portbench import gen, tracing
from portbench.reference import glm, schedule

# the profiled stretches of the traced call: windows k - 1 .. k + 2 run
# under the profiler and windows k, k + 1 are read; the next k is tried
# when a trace is not whole
TRACE_AT = (16, 24, 32, 40, 48)
SNAPSHOT_AT = 12        # the window whose entry the accounting check reads
                        # (the middle one, in a call of fewer than 24)
WORD_SLOT_MASK, WORD_HEAP_SHIFT, FREE_HEAP = (1 << 20) - 1, 20, 3


class _TraceRead(Exception):
    """Ends the traced call once its profiled stretch has been read."""


def draw_weights(specs: Dict, seed: int, device, scales: Dict) -> Dict:
    """Weights in the layout of `specs` (meta tensors), drawn from the seed
    with a generator on `device`: one normal draw per dtype (in chunks of
    at most 2^30 elements), each leaf a view of it, scaled by
    `scales["embed"]` (the embedding), `scales["norm"]` (1-d leaves, the
    norms' zero-centred scales) or its fan-in ** -0.5 (every [in, out]
    matrix, the head too)."""
    named, spec = pytree.tree_flatten_with_path(specs)
    g = torch.Generator(device=device).manual_seed(seed)
    leaves = [None] * len(named)
    for dtype in sorted({t.dtype for _, t in named}, key=str):
        idx = [i for i, (_, t) in enumerate(named) if t.dtype == dtype]
        total = sum(named[i][1].numel() for i in idx)
        buf = torch.empty(total, dtype=dtype, device=device)
        for lo in range(0, total, 1 << 30):
            hi = min(lo + (1 << 30), total)
            buf[lo:hi].normal_(generator=g)
        off = 0
        for i in idx:
            path, t = named[i]
            leaf = buf[off:off + t.numel()].view(t.shape)
            off += t.numel()
            name = pytree.keystr(path)
            if name == "['embed']":
                leaf.mul_(scales["embed"])
            elif t.dim() == 1:
                leaf.mul_(scales["norm"])
            else:
                leaf.mul_(t.shape[0] ** -0.5)
            leaves[i] = leaf
    return pytree.tree_unflatten(leaves, spec)


def reference_weights(params: Dict) -> Dict:
    """The same tensors under the plain reference's names."""
    layers = []
    for lp in params["layers"]:
        layers.append({"ln1": lp["ln1"], "ln2": lp["ln2"], "wq": lp["wq"],
                       "wk": lp["wk"], "wv": lp["wv"], "wo": lp["wo"],
                       "wi": lp["ffn"]["wi"], "wg": lp["ffn"]["wg"],
                       "wo_ff": lp["ffn"]["wo"]})
    return {"embed": params["embed"], "final_ln": params["final_ln"],
            "out": params["out"], "layers": layers}


def model_flops(sizes: Dict, positions: int) -> float:
    """Operations of one decode step of one sequence at 0-based position
    `positions`: 2 per weight of every matrix product (the layers' and
    the head's) and 4 * H * Dh per attended position a layer."""
    d, f, v = sizes["hidden_size"], sizes["ffn_hidden_size"], sizes["vocab"]
    h, kv, dh = sizes["num_heads"], sizes["num_kv_heads"], sizes["head_dim"]
    per_layer = d * h * dh * 2 + 2 * d * kv * dh + 3 * d * f
    return 2.0 * (sizes["num_layers"] * per_layer + d * v) + \
        4.0 * sizes["num_layers"] * h * dh * (positions + 1)


class ServeCell:
    def __init__(self, spec: Dict, mix: Dict, seed: int, device, *,
                 model_cfg, check: Dict):
        self.spec, self.mix, self.seed = spec, mix, seed
        self.device = torch.device(device)
        self.model_cfg = model_cfg
        self.check_spec = check
        c = model_cfg
        self.sizes = dict(num_layers=c.num_layers, hidden_size=c.d_model,
                          ffn_hidden_size=c.d_ff, vocab=c.vocab_size,
                          num_heads=c.num_heads, num_kv_heads=c.num_kv_heads,
                          head_dim=c.resolved_head_dim,
                          rope_theta=c.rope_theta, norm_eps=c.norm_eps)

    # -- set-up ---------------------------------------------------------
    def setup(self, seconds: float) -> None:
        from repro_torch.models.model import Model
        from repro_torch.runtime.server import Request, Server, ServerConfig
        if self.device.type == "cuda":
            from repro_torch.kernels import build
            build.build_all()
        model = Model(self.model_cfg, device=str(self.device))
        self.params = draw_weights(model.param_specs(), self.seed,
                                   self.device, self.spec["weights"])
        self.server_cfg = ServerConfig(**self.spec["server"])
        self.srv = Server(model, self.server_cfg)
        pcfg = self.srv.kv_cfg.pool_config()
        self.pool_info = {"slot_bytes": pcfg.slot_bytes,
                          "n_objects": pcfg.max_objects, "n_sbs": pcfg.n_sbs,
                          "sb_bytes": pcfg.sb_bytes,
                          "move_budget": self.srv.col_cfg.move_budget}
        self._Request = Request
        self.srv.serve(self.params, [Request(prompt=[1, 2, 3], max_new=2)])
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def requests(self, call: int):
        return [self._Request(prompt=p.tolist(), max_new=n)
                for p, n in gen.serve_call(self.mix, self.seed, call,
                                           self.sizes["vocab"])]

    # -- the window -----------------------------------------------------
    def run(self, seconds: float, trace: bool) -> None:
        self.calls: List[Dict] = []
        self.profile: Optional[Dict] = None
        self.snapshot: Optional[Dict] = None
        cfg = self.server_cfg
        first = schedule.windows([(len(r.prompt), r.max_new)
                                  for r in self.requests(0)], cfg.batch,
                                 cfg.window or cfg.collect_every, cfg.max_len)
        self.snapshot_at = min(SNAPSHOT_AT, len(first) // 2)
        start = time.perf_counter()
        while True:
            c = self._call(len(self.calls), trace=False,
                           snapshot=not self.calls)
            self.calls.append(c)
            if (c["t1"] - start) + (c["t1"] - c["t0"]) > seconds:
                break
        self.live_left = int((self.srv.state["block_tables"] >= 0).sum())
        if trace:
            self._trace_call()

    def _call(self, i: int, trace: bool, snapshot: bool) -> Dict:
        """Serve call `i` of the mix, each window's upload hooked; with
        `trace`, only as far as its profiled stretch."""
        reqs = self.requests(i)
        stamps: List[float] = []
        sizes = [(len(r.prompt), r.max_new) for r in reqs]
        cfg = self.server_cfg
        n_win = len(schedule.windows(sizes, cfg.batch,
                                     cfg.window or cfg.collect_every,
                                     cfg.max_len))
        resident = torch.zeros(n_win + 1, dtype=torch.int64,
                               device=self.device)
        self.srv._upload = self._hook(stamps, trace, snapshot, resident)
        t0 = time.perf_counter()
        results = None
        try:
            results = self.srv.serve(self.params, reqs)
        except _TraceRead:
            pass
        finally:
            del self.srv._upload
        t1 = time.perf_counter()
        if results is not None:
            resident[min(len(stamps), n_win) - 1] = self._resident_sbs()
        return dict(
            t0=t0, t1=t1, stamps=stamps + [t1], sizes=sizes,
            prompts=[r.prompt for r in reqs],
            tokens=None if results is None else [c.tokens for c in results],
            resident=resident[:len(stamps)].tolist(),
            serve_log=list(self.srv.serve_log),
            reports=list(self.srv.reports))

    def _resident_sbs(self) -> torch.Tensor:
        """Superblocks of the KV pool that hold an object and sit in the
        hot tier, counted on the device from the slot owners and the
        tiers."""
        pool = self.srv.state["pool"]
        tier = pool["sb_tier"]
        occ = (pool["slot_owner"] >= 0).view(tier.numel(), -1).sum(1)
        return ((occ > 0) & (tier == 0)).sum()

    def _trace_call(self) -> None:
        """One more call of the mix after the window has closed, a stretch
        of it profiled (a profiled stretch slows the windows after it
        too); the profile keeps its windows' lanes and moved rows."""
        c = self._call(len(self.calls), trace=True, snapshot=False)
        if self.profile is None:
            return
        cfg = self.server_cfg
        sched = schedule.windows(c["sizes"], cfg.batch,
                                 cfg.window or cfg.collect_every, cfg.max_len)
        w = self.profile["windows"]
        self.profile.update(
            running=[sched[i]["running"] for i in w],
            moved=[c["reports"][i]["moved_to_hot"]
                   + c["reports"][i]["moved_to_cold"] for i in w])

    def _hook(self, stamps: List[float], trace: bool, snapshot: bool,
              resident: torch.Tensor):
        """The server's upload of each window's inputs, wrapped: recounts
        the resident superblocks at the previous window's close, stamps
        the window's start, snapshots the pool at SNAPSHOT_AT's entry and
        drives the profiled stretches."""
        upload = self.srv._upload
        tries = list(TRACE_AT) if trace else []
        state = {"prof": None}

        def hook(host):
            i = len(stamps)
            if trace and not tries:
                raise _TraceRead
            if 0 < i < resident.numel():
                resident[i - 1] = self._resident_sbs()
            if snapshot and i == self.snapshot_at:
                self.snapshot = self._snapshot(i)
            if tries and state["prof"] is None and i == tries[0] - 1:
                state["prof"] = tracing.profiler()
                state["prof"].start()
                tracing.open_trace()
            elif state["prof"] is not None and i == tries[0] + 3:
                tracing.close_trace()
                state["prof"].stop()
                got = tracing.read_stretch(state["prof"], tries[0])
                state["prof"] = None
                k = tries.pop(0)
                if got is not None:
                    self.profile = dict(got, at=k)
                    tries.clear()
            stamps.append(time.perf_counter())
            return upload(host)
        return hook

    def _snapshot(self, i: int) -> Dict:
        st = self.srv.state
        pool = st["pool"]
        return {"window": i, "table": pool["table"].clone(),
                "owner": pool["slot_owner"].clone(),
                "sb_occ": pool["sb_occ"].clone(),
                "sb_tier": pool["sb_tier"].clone(),
                "block_tables": st["block_tables"].clone()}

    # -- numbers --------------------------------------------------------
    def seconds(self) -> float:
        return sum(c["t1"] - c["t0"] for c in self.calls)

    def live_blocks(self, c: Dict) -> List[int]:
        """The plain lane model's live blocks at each window's close of
        call `c`."""
        cfg = self.server_cfg
        window = cfg.window or cfg.collect_every
        max_blocks = -(-cfg.max_len // cfg.block_tokens)
        return [schedule.live_blocks(w, window, cfg.block_tokens, max_blocks,
                                     self.sizes["num_layers"])
                for w in schedule.windows(c["sizes"], cfg.batch, window,
                                          cfg.max_len)]

    def end_to_end(self) -> Dict[str, float]:
        tokens = sum(len(t) for c in self.calls for t in c["tokens"])
        resident = sum(sum(c["resident"]) for c in self.calls) * \
            self.pool_info["sb_bytes"]
        live = sum(sum(self.live_blocks(c)) for c in self.calls) * \
            self.pool_info["slot_bytes"]
        return {"gen_tok_s": tokens / self.seconds(),
                "resident_frac": resident / live}

    def attempted(self):
        n = sum(len(c["sizes"]) for c in self.calls)
        failed = sum(len(t) != m
                     for c in self.calls
                     for t, (_, m) in zip(c["tokens"], c["sizes"]))
        return n, failed

    def record(self) -> Dict:
        """What the per-layer readers read."""
        cfg = self.server_cfg
        window = cfg.window or cfg.collect_every
        return dict(
            self.pool_info, sizes=self.sizes,
            lanes=cfg.batch, window=window, block_tokens=cfg.block_tokens,
            max_len=cfg.max_len, seconds=self.seconds(), calls=self.calls,
            reports=[r for c in self.calls for r in c["reports"]],
            schedules=[schedule.windows(c["sizes"], cfg.batch, window,
                                        cfg.max_len) for c in self.calls],
            profile=self.profile, model_flops=model_flops)

    # -- correct --------------------------------------------------------
    def release(self) -> None:
        """Free the program's state (the server, its pool and graphs);
        the weights stay: they are the benchmark's inputs."""
        del self.srv
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _sample(self):
        """(call, request) pairs drawn from the seed: the longest finished
        request, then others, up to the check's token budget."""
        pool = [(ci, ri) for ci, c in enumerate(self.calls)
                for ri in range(len(c["tokens"]))]
        size = {(ci, ri): sum(self.calls[ci]["sizes"][ri])
                for ci, ri in pool}
        longest = max(pool, key=lambda x: (size[x], -x[0], -x[1]))
        rng = np.random.default_rng([self.seed, 7])
        order = [pool[i] for i in rng.permutation(len(pool))]
        out = [longest]
        served = len(self.calls[longest[0]]["tokens"][longest[1]])
        for x in order:
            if served >= self.check_spec["served_tokens"]:
                break
            if x != longest:
                out.append(x)
                served += len(self.calls[x[0]]["tokens"][x[1]])
        return out

    def gaps(self, fp8: bool = False) -> Dict[str, float]:
        """The widest gap of the sampled served tokens under the fp32
        reference; with `fp8`, also that of the tokens the fp8 reference
        puts first at the same positions (the control)."""
        picks = self._sample()
        seqs, meta = [], []
        for ci, ri in picks:
            c = self.calls[ci]
            served = c["tokens"][ri]
            seqs.append(torch.as_tensor(
                list(c["prompts"][ri]) + list(served[:-1]),
                dtype=torch.long, device=self.device))
            meta.append((len(c["prompts"][ri]), served))
        w = reference_weights(self.params)
        ref = glm.logits(w, self.sizes, seqs, device=self.device)
        out = {"served_tokens": float(sum(len(s) for _, s in meta)),
               "served_gap": max(float(glm.served_gaps(r, p, s).max())
                                 for r, (p, s) in zip(ref, meta))}
        if fp8:
            low = glm.logits(w, self.sizes, seqs, fp8=True,
                             device=self.device)
            widest = 0.0
            for r, q, (p, s) in zip(ref, low, meta):
                first = q[p - 1:p - 1 + len(s)].argmax(-1).tolist()
                widest = max(widest, float(glm.served_gaps(r, p, first).max()))
            out["control_gap"] = widest
        return out

    def accounting(self) -> int:
        """Mismatches of the pool's accounting against the plain lane model
        and a plain recount (0 when sound)."""
        cfg = self.server_cfg
        slot_bytes = self.pool_info["slot_bytes"]
        sb_bytes = self.pool_info["sb_bytes"]
        window = cfg.window or cfg.collect_every
        max_blocks = -(-cfg.max_len // cfg.block_tokens)
        layers = self.sizes["num_layers"]
        bad = 0
        for c in self.calls:
            sched = schedule.windows(c["sizes"], cfg.batch, window,
                                     cfg.max_len)
            log = c["serve_log"]
            bad += abs(len(sched) - len(log))
            bad += abs(len(c["resident"]) - len(log))
            for w, want, e, r in zip(sched, self.live_blocks(c), log,
                                     c["resident"]):
                bad += int(e["live_bytes"] != want * slot_bytes)
                bad += int(e["active"] != len(w["running"]))
                bad += int(e["rss_bytes"] != r * sb_bytes)
            bad += int(log[-1]["rss_bytes"] != 0)
            bad += sum(len(t) != m for t, (_, m) in zip(c["tokens"],
                                                        c["sizes"]))
        bad += int(self.live_left != 0)
        snap = self.snapshot
        if snap is None:
            return bad + 1
        sched = schedule.windows(self.calls[0]["sizes"], cfg.batch, window,
                                 cfg.max_len)
        i = snap["window"]
        want = schedule.live_blocks(sched[i - 1], window, cfg.block_tokens,
                                    max_blocks, layers)
        table, owner = snap["table"], snap["owner"]
        live = ((table >> WORD_HEAP_SHIFT) & 3) != FREE_HEAP
        bt = snap["block_tables"]
        ids = bt[bt >= 0].long()
        slots = (table[ids] & WORD_SLOT_MASK).long()
        bad += abs(int(live.sum()) - want) + abs(int(ids.numel()) - want)
        bad += int((((table[ids] >> WORD_HEAP_SHIFT) & 3) == FREE_HEAP).sum())
        bad += int((owner[slots] != ids).sum())
        n_sbs = snap["sb_occ"].numel()
        occ = (owner >= 0).view(n_sbs, -1).sum(1)
        bad += int((occ != snap["sb_occ"]).sum())
        return bad

    def check(self) -> List[Dict]:
        g = self.gaps()
        return [
            {"name": "served_gap", "value": g["served_gap"],
             "limit": self.check_spec["served_gap_limit"]},
            {"name": "pool_mismatches", "value": float(self.accounting()),
             "limit": 0.0},
        ]
