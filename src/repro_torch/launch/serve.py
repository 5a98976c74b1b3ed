"""Serving launcher of the port: `python -m repro_torch.launch.serve --arch
chatglm3-6b --reduced --requests 8` — batched decode over the
HADES-managed paged KV cache on the card (`--device cpu` for the CPU),
reporting KV RSS and collector activity.

`--mode generate` (default) teacher-forces one fixed batch through
`Server.generate`; `--mode serve` drives the continuous-batching queue
(`Server.serve`). `--temperature/--top-k` switch on sampling (the
generator is seeded from --seed). `main(argv)` returns what it ran: the
server, the params, and the generated tokens (generate) or the
completions (serve).

The last line, "spans: {...}", is the span recorder's view of the run
(`repro_torch.spans.summary`): host ms a window by span and its host
cycle, device ms a window by stamp segment (by program), the device's
untraced idle share, the served requests' time to first token and
latency (mean and p95 ms from their call's start), the windows seen, the
graph captures and the entries dropped.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.core import backend as be
from repro_torch.models.model import Model
from repro_torch.runtime.server import Request, Server, ServerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", default="generate",
                    choices=("generate", "serve"),
                    help="fixed-batch generate or continuous-batching "
                         "queue serving")
    ap.add_argument("--requests", type=int, default=4,
                    help="batch lanes (generate) / queued requests (serve)")
    ap.add_argument("--lanes", type=int, default=0,
                    help="serve mode: batch lanes (0 -> min(requests, 4))")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="> 0 samples (greedy otherwise)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k filter for sampled decode (0 = full vocab)")
    ap.add_argument("--backend", default="proactive", choices=be.names(),
                    help="tiering backend (backend registry)")
    ap.add_argument("--hbm-target-mb", type=int, default=0,
                    help="pressure target (MiB) of the backend, for those "
                         "that declare one (reactive, cap, mglru: "
                         "hbm_target_bytes; promote: hbm_high_bytes)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    be_params = be.pressure_params(args.backend, args.hbm_target_mb << 20)
    if args.hbm_target_mb and not be_params:
        ap.error(f"--hbm-target-mb is not applicable to {args.backend!r}"
                 " (it declares no pressure field)")

    spans.reset()
    cfg = get_config(args.arch, reduced=args.reduced)
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device)
                        .manual_seed(args.seed))
    lanes = args.requests if args.mode == "generate" else \
        (args.lanes or min(args.requests, 4))
    srv = Server(model, ServerConfig(
        batch=lanes, max_len=args.max_len,
        block_tokens=max(args.max_len // 16, 4), backend=args.backend,
        backend_params=be_params, temperature=args.temperature,
        top_k=args.top_k))
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=model.device).manual_seed(args.seed + 1)
    run = dict(server=srv, params=params, tokens=None, results=None)

    if args.mode == "generate":
        prompts = rng.integers(0, cfg.vocab_size,
                               (args.requests, args.prompt_len))
        greedy = args.temperature <= 0
        out = run["tokens"] = srv.generate(
            params, prompts, max_new=args.max_new, greedy=greedy,
            generator=None if greedy else gen)
        print(f"generated {tuple(out.shape)} tokens; "
              f"KV RSS {srv.kv_rss_bytes()/2**20:.2f} MiB")
    else:
        reqs = [Request(prompt=rng.integers(0, cfg.vocab_size,
                                            (args.prompt_len,)).tolist(),
                        max_new=args.max_new,
                        temperature=args.temperature, top_k=args.top_k)
                for _ in range(args.requests)]
        results = run["results"] = srv.serve(
            params, reqs, generator=gen if args.temperature > 0 else None)
        print(f"served {len(results)} requests on {lanes} lanes in "
              f"{len(srv.serve_log)} windows ({srv.dispatches} dispatches); "
              f"{sum(len(r.tokens) for r in results)} tokens")
        peak = max((e["rss_bytes"] for e in srv.serve_log), default=0.0)
        print(f"KV RSS peak {peak/2**20:.2f} MiB -> final "
              f"{srv.kv_rss_bytes()/2**20:.2f} MiB")
    for r in srv.reports[-3:]:
        print("  collector:", {k: round(v, 4) for k, v in r.items()})
    print("spans:", json.dumps(spans.summary()))
    return run


if __name__ == "__main__":
    main()
