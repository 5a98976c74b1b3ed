"""Scrambled-Zipfian keys (YCSB's ScrambledZipfian, θ 0.99): a frozen copy
of the port's `data/ycsb.py` generator, in torch so that the keys of a run
are drawn on the device from the seed. Zipf ranks by the inverse CDF over
the first `active_frac * n` ranks, scattered over the whole key space by
one random permutation, so hot keys lie throughout it."""
from __future__ import annotations

import torch

ZIPF_THETA = 0.99
MIXES = {"A": (0.5, 0.5), "B": (0.95, 0.05), "C": (1.0, 0.0)}


class ZipfianKeys:
    """Key sampler over [0, n_keys) on `device`, all draws from `generator`
    (a torch.Generator on that device): the scramble first, then samples."""

    def __init__(self, n_keys: int, generator: torch.Generator, device,
                 theta: float = ZIPF_THETA, active_frac: float = 1.0):
        self.n = n_keys
        self.g = generator
        n_active = max(1, int(n_keys * active_frac))
        w = 1.0 / torch.arange(1, n_active + 1, dtype=torch.float64,
                               device=device).pow(theta)
        cdf = torch.cumsum(w, 0)
        self.cdf = cdf / cdf[-1]
        self.scramble = torch.randperm(n_keys, generator=generator,
                                       device=device)

    def sample(self, k: int) -> torch.Tensor:
        """k keys, int64."""
        u = torch.rand(k, generator=self.g, dtype=torch.float64,
                       device=self.cdf.device)
        ranks = torch.searchsorted(self.cdf, u).clamp_(max=self.n - 1)
        return self.scramble[ranks]
