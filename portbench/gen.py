"""The general traffic generators. A mix is a data file,
`traffic/<name>.json`, whose "kind" names the generator here that reads
it; everything a run draws comes from its `--seed`.

  serve  requests for `Server.serve`: each call a fixed sequence of
         (prompt length, output length) pairs, lognormal lengths on a
         quantile grid whose median is solved so that the grid's mean is
         the source's published mean, paired and queued in an order drawn
         from the mix's own `size_seed` (random, not sorted), so every
         seed serves the same sizes in the same arrival order; the seed
         draws the prompt ids (uniform over the vocabulary).
  ycsb   YCSB windows for `Engine.serve_steps`: a window of
         `steps_per_window` steps of `ops_per_step` keys, the read steps
         first and then the update steps (YCSB's mix), keys scrambled Zipf
         drawn on the device window by window; an update's payload is a
         hash of (seed, key, window, column), so a key written twice in
         one step carries the same bytes, and the reference recomputes it.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import zipf

HERE = Path(__file__).resolve().parent


def load_mix(name: str) -> Dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


# -- serve ------------------------------------------------------------------
def _lognormal_grid(n: int, median: float, spec: Dict) -> np.ndarray:
    """n lengths at the quantiles (i + 0.5) / n of a lognormal with this
    median and the spec's sigma, rounded and clipped to [min, max]."""
    z = np.asarray([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.exp(math.log(median) + spec["sigma"] * z)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def lengths(n: int, spec: Dict) -> np.ndarray:
    """The n lengths of `spec` ({"mean", "sigma", "min", "max"}): the
    median is solved by bisection so that the clipped grid's mean comes
    nearest the published mean."""
    lo, hi = 1.0, float(spec["max"])
    for _ in range(64):
        mid = math.sqrt(lo * hi)
        if _lognormal_grid(n, mid, spec).mean() < spec["mean"]:
            lo = mid
        else:
            hi = mid
    cands = [_lognormal_grid(n, m, spec) for m in (lo, hi)]
    return min(cands, key=lambda g: abs(g.mean() - spec["mean"]))


def serve_sizes(mix: Dict) -> List[Tuple[int, int]]:
    """The (prompt, output) lengths of one call: the same for every seed."""
    n = mix["requests_per_call"]
    p = lengths(n, mix["prompt"])
    o = lengths(n, mix["output"])
    o = o[np.random.default_rng(mix["size_seed"]).permutation(n)]
    return [(int(a), int(b)) for a, b in zip(p, o)]


def serve_call(mix: Dict, seed: int, call: int, vocab: int
               ) -> List[Tuple[np.ndarray, int]]:
    """The requests of call `call`: (prompt ids int32, max_new), in the
    order the client queues them. The order is the mix's (`size_seed`,
    call), the same for every seed; the prompt ids are the seed's."""
    rng = np.random.default_rng([seed, call])
    sizes = serve_sizes(mix)
    order = np.random.default_rng([mix["size_seed"], call]).permutation(
        len(sizes))
    out = []
    for i in order:
        p, n = sizes[i]
        out.append((rng.integers(0, vocab, p).astype(np.int32), n))
    return out


# -- ycsb -------------------------------------------------------------------
def ycsb_ops(mix: Dict) -> List[str]:
    """The op of each step of a window: reads, then updates."""
    t = mix["steps_per_window"]
    read_frac, update_frac = zipf.MIXES[mix["mix"]]
    n_upd = round(update_frac * t)
    if abs(n_upd - update_frac * t) > 1e-9 or \
            n_upd + round(read_frac * t) != t:
        raise ValueError(f"{t} steps cannot hold mix {mix['mix']} exactly")
    return ["read"] * (t - n_upd) + ["write"] * n_upd


class YcsbKeys:
    """The keys of windows 0, 1, 2, ... in order, drawn on `device` from
    the seed: `window()` gives the next window's [steps, ops] int32. Two
    streams of one seed give the same keys."""

    def __init__(self, mix: Dict, n_keys: int, seed: int, device):
        g = torch.Generator(device=device).manual_seed(seed)
        self.keys = zipf.ZipfianKeys(n_keys, g, device, theta=mix["theta"],
                                     active_frac=mix["active_frac"])
        self.shape = (mix["steps_per_window"], mix["ops_per_step"])

    def window(self) -> torch.Tensor:
        t, k = self.shape
        return self.keys.sample(t * k).view(t, k).to(torch.int32)


_M = 0xFFFFFFFF


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash step in int64 (no product passes 2^63)."""
    h = h ^ (h >> 16)
    h = (h * 0x45D9F3B) & _M
    h = h ^ (h >> 16)
    h = (h * 0x45D9F3B) & _M
    return h ^ (h >> 16)


def payload(seed: int, keys: torch.Tensor, window: int, width: int
            ) -> torch.Tensor:
    """float32 [len(keys), width] in [-1, 1): a hash of (seed, key, window,
    column); the load phase is window -1. Exact on every device."""
    col = torch.arange(width, dtype=torch.int64, device=keys.device)
    h = _mix32((keys.to(torch.int64)[:, None] * 0x9E3779B1 + col) & _M)
    h = _mix32(h ^ ((window + 1) * 0x7FEB352D + seed * 0x68E31DA5) & _M)
    return ((h >> 8).to(torch.float32) * (2.0 / (1 << 24)) - 1.0)
