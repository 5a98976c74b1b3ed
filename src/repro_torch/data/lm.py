"""Synthetic LM token pipeline (port of `repro/data/lm.py`) — deterministic,
shardable, replayable, and bit for bit the JAX package's batches.

Tokens are drawn zipfian over the vocabulary from a counter-based PRNG
keyed on (seed, step, shard): any step of any shard can be regenerated on
its own, which makes the trainer replay-exact after a restore
(`runtime/trainer.py`). The PRNG is a numpy copy of what `jax.random`
computes with its default threefry implementation (partitionable, as
jax 0.9 runs it): `prng_key` (`PRNGKey`), `fold_in` and `uniform`
(float32). Generation stays on the host; `batch_at` uploads the int32
tokens to the pipeline's device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device, upload

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    zipf_theta: float = 1.1
    seed: int = 0


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def _threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under `key`, as `jax._src.prng._threefry2x32_lowering`."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> Tuple[int, int]:
    """`jax.random.PRNGKey(seed)`: the seed's high and low 32 bits (a seed
    that fits 32 bits has a zero high word)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise OverflowError(f"seed {seed} does not fit 32 bits")
    return 0, seed & 0xFFFFFFFF


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """`jax.random.fold_in(key, data)`: the hash of the counter pair (0,
    data), data a uint32."""
    if not 0 <= int(data) < 2 ** 32:
        raise OverflowError(f"data {data} out of bounds for uint32")
    with np.errstate(over="ignore"):
        a, b = _threefry2x32(key, np.zeros(1, _U32),
                            np.asarray([int(data)], _U32))
    return int(a[0]), int(b[0])


def _random_bits(key: Tuple[int, int], shape) -> np.ndarray:
    """32 random bits per element (`jax.random.bits`, uint32): the hash of
    each element's row-major index i as the pair (i >> 32, i & 0xFFFFFFFF),
    its two words xor-ed."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        a, b = _threefry2x32(key, (idx >> np.uint64(32)).astype(_U32),
                            (idx & np.uint64(0xFFFFFFFF)).astype(_U32))
    return (a ^ b).reshape(shape)


def uniform(key: Tuple[int, int], shape) -> np.ndarray:
    """`jax.random.uniform(key, shape)` in float32 on [0, 1): 23 random
    mantissa bits under the exponent of 1.0, minus 1."""
    bits = (_random_bits(key, shape) >> _U32(9)) | _U32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


class TokenPipeline:
    """Batches of `local_batch` sequences for shard `shard` of
    `num_shards`, on `device` (`resolve_device`: cuda unless the caller
    asks for another)."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1,
                 device: Optional[str] = None):
        if cfg.global_batch % num_shards:
            raise ValueError(f"global_batch {cfg.global_batch} is not a "
                             f"multiple of num_shards {num_shards}")
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        self.device = resolve_device(device)
        # zipfian inverse-CDF over the vocab (heavy head, long tail)
        w = 1.0 / np.power(
            np.arange(1, cfg.vocab_size + 1, dtype=np.float64),
            cfg.zipf_theta)
        cdf = np.cumsum(w)
        self._cdf = (cdf / cdf[-1]).astype(np.float32)
        # scatter hot ids across the vocab (realistic id assignment)
        self._scramble = np.random.default_rng(cfg.seed).permutation(
            cfg.vocab_size).astype(np.int32)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """Deterministic batch for (step, shard) — replay-exact."""
        cfg = self.cfg
        key = fold_in(fold_in(prng_key(cfg.seed), step), self.shard)
        u = uniform(key, (self.local_batch, cfg.seq_len + 1))
        ranks = np.searchsorted(self._cdf, u)
        toks = self._scramble[np.clip(ranks, 0, cfg.vocab_size - 1)]
        return {"tokens": upload(toks[:, :-1], self.device),
                "labels": upload(toks[:, 1:], self.device)}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
