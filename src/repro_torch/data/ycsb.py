"""YCSB workload generation (paper §5 setup); a numpy copy of
`repro/data/ycsb.py` that yields the same key streams for the same seed.

Zipfian key streams with *scattered* hot keys: a fixed random permutation
("scramble") of the zipf ranks, as YCSB's ScrambledZipfian, so hot keys
lie throughout the key space — the regime where hotness fragmentation
bites.

Workload mixes (YCSB core):
    A: 50% reads / 50% updates
    B: 95% reads /  5% updates
    C: 100% reads
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np

ZIPF_THETA = 0.99  # YCSB default skew


@dataclasses.dataclass(frozen=True)
class WorkloadMix:
    name: str
    read_frac: float
    update_frac: float


WORKLOADS: Dict[str, WorkloadMix] = {
    "A": WorkloadMix("A", 0.5, 0.5),
    "B": WorkloadMix("B", 0.95, 0.05),
    "C": WorkloadMix("C", 1.0, 0.0),
}


class ZipfianKeys:
    """Scrambled-zipfian key sampler over [0, n_keys).

    `active_frac` reproduces the paper's working-set construction (fig 7:
    "12GB footprint while actively accessing only ~4GB"): requests are
    zipfian over the first `active_frac * n` ranks, and the scramble
    scatters those active keys throughout the whole key space — so the
    active set is a scattered 1/3 (say) of the footprint, exactly the
    hotness-fragmentation regime the paper evaluates.
    """

    def __init__(self, n_keys: int, theta: float = ZIPF_THETA,
                 seed: int = 0, active_frac: float = 1.0):
        self.n = n_keys
        self.theta = theta
        self.rng = np.random.default_rng(seed)
        n_active = max(1, int(n_keys * active_frac))
        # inverse-CDF tables: P(rank <= r) = zeta(r)/zeta(n_active)
        weights = 1.0 / np.power(np.arange(1, n_active + 1, dtype=np.float64),
                                 theta)
        self.cdf = np.cumsum(weights)
        self.cdf /= self.cdf[-1]
        # scatter hot (and active) ranks across the whole key space
        self.scramble = self.rng.permutation(n_keys)

    def sample(self, k: int) -> np.ndarray:
        u = self.rng.random(k)
        ranks = np.searchsorted(self.cdf, u)
        return self.scramble[ranks]

    def hot_set(self, frac: float) -> np.ndarray:
        """The keys covering the top `frac` of access probability."""
        n_hot = max(1, int(np.searchsorted(self.cdf, frac)))
        return self.scramble[:n_hot]


def ops_stream(mix: WorkloadMix, keys: ZipfianKeys, n_ops: int,
               batch: int = 4096, seed: int = 1
               ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (op_is_update [b], keys [b]) batches, deterministic per seed."""
    rng = np.random.default_rng(seed)
    done = 0
    while done < n_ops:
        b = min(batch, n_ops - done)
        ks = keys.sample(b)
        upd = rng.random(b) < mix.update_frac
        yield upd, ks
        done += b
