"""The ten concurrent data structures (paper Table 1) as access-topology
generators; a numpy copy of `repro/data/structures.py` that draws the same
permutations in the same order, so a seed gives the same paths.

The paper evaluates HADES across ten ASCYLIB structures to show that
object-level tracking is robust to pointer-graph shape and concurrency
control. What tiering actually *sees* from a structure is the object
access stream each operation induces — which index/metadata objects are
touched on the way to the key/value, and which synchronization words are
shared. We reproduce exactly that: each structure precomputes its search
paths over the loaded key set and emits, per operation, the flat array of
object ids touched. Concurrency control appears as extra touched objects
(global locks, per-node lock/version words, epoch counters) — a coarse
lock is one scorching-hot object; per-node words scale with the path.

Object-id address map (CrestKV's; n = number of keys):
    [0,       n)        key objects     (30 B)
    [n,      2n)        per-key node objects (chain/tower/leaf-entry)
    [2n,     2n+M)      structure metadata (buckets, internal nodes, locks)
    value objects are allocated dynamically by CrestKV (1024 B),
    starting at `value_base` (updates allocate fresh value objects).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np

KEY_BYTES = 30
VALUE_BYTES = 1024
NODE_BYTES = 32
LOCK_BYTES = 16
BTREE_NODE_BYTES = 1024
MASSTREE_NODE_BYTES = 256
ART_NODE_BYTES = 128


class Structure:
    """Base: subclasses fill `meta_sizes` and implement `paths`."""
    name = "base"
    node_bytes = NODE_BYTES

    def __init__(self, n_keys: int, seed: int = 0):
        self.n = n_keys
        self.rng = np.random.default_rng(seed)
        self.key_base = 0
        self.node_base = n_keys
        self.meta_base = 2 * n_keys
        # sorted order: key k has rank `rank_of[k]`; key_at_rank inverts
        self.key_at_rank = self.rng.permutation(n_keys)
        self.rank_of = np.empty(n_keys, np.int64)
        self.rank_of[self.key_at_rank] = np.arange(n_keys)
        self._build()

    # -- to be provided by subclasses ----------------------------------------
    def _build(self):
        raise NotImplementedError

    def paths(self, op_keys: np.ndarray, is_update: np.ndarray) -> np.ndarray:
        """[n_ops, depth] object ids touched per op (-1 = no touch)."""
        raise NotImplementedError

    # -- common ---------------------------------------------------------------
    def meta_objects(self) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, sizes) of structure metadata objects to allocate at load."""
        sizes = np.asarray(self.meta_sizes, np.int64)
        ids = self.meta_base + np.arange(len(sizes), dtype=np.int64)
        return ids, sizes

    def node_objects(self) -> Tuple[np.ndarray, np.ndarray]:
        ids = self.node_base + np.arange(self.n, dtype=np.int64)
        return ids, np.full(self.n, self.node_bytes, np.int64)

    def touched(self, op_keys: np.ndarray, is_update: np.ndarray,
                value_obj: np.ndarray) -> np.ndarray:
        """Flat object-id stream for a batch of ops: index path + key +
        current value object."""
        p = self.paths(op_keys, is_update)
        cols = [p, (self.key_base + op_keys)[:, None], value_obj[:, None]]
        flat = np.concatenate(cols, axis=1).ravel()
        return flat[flat >= 0]


# ---------------------------------------------------------------------------
# Hash tables
# ---------------------------------------------------------------------------
class _HashBase(Structure):
    """Chained hash table, load factor 1. Chain walk touches the node
    objects of chain predecessors (insertion order)."""
    max_chain = 4
    extra_locks = 0  # number of lock objects per op (subclass)

    def _build(self):
        n = self.n
        self.n_buckets = n
        h = self.rng.permutation(n)          # bucket of key
        self.bucket_of = h % self.n_buckets
        # chain rank: order within bucket
        order = np.lexsort((np.arange(n), self.bucket_of))
        ranks = np.empty(n, np.int64)
        grp_start = np.concatenate([[0], np.nonzero(
            np.diff(self.bucket_of[order]))[0] + 1])
        starts = np.zeros(n, np.int64)
        starts[grp_start] = 1
        ranks[order] = np.arange(n) - np.maximum.accumulate(
            np.where(starts == 1, np.arange(n), -1))
        self.chain_rank = ranks
        self.sorted_by_bucket = order        # keys grouped by bucket
        self.pos_in_sorted = np.empty(n, np.int64)
        self.pos_in_sorted[order] = np.arange(n)
        # metadata: one bucket-head object per bucket (+ locks, subclass)
        self.meta_sizes = [16] * self.n_buckets + \
            [LOCK_BYTES] * self._n_lock_objects()
        self.lock_base = self.meta_base + self.n_buckets

    def _n_lock_objects(self) -> int:
        return 0

    def _lock_touch(self, op_keys: np.ndarray) -> List[np.ndarray]:
        return []

    def paths(self, op_keys: np.ndarray, is_update: np.ndarray) -> np.ndarray:
        bucket_obj = self.meta_base + self.bucket_of[op_keys]
        # chain predecessors: up to max_chain-1 node objects before ours
        r = self.chain_rank[op_keys]
        pos = self.pos_in_sorted[op_keys]
        depth = np.minimum(r, self.max_chain - 1)
        preds = []
        for i in range(self.max_chain - 1):
            take = i < depth
            idx = np.clip(pos - depth + i, 0, self.n - 1)
            pk = self.sorted_by_bucket[idx]
            preds.append(np.where(take, self.node_base + pk, -1))
        own = self.node_base + op_keys
        cols = [bucket_obj[:, None]] + [p[:, None] for p in preds] + \
            [own[:, None]] + [t[:, None] for t in self._lock_touch(op_keys)]
        return np.concatenate(cols, axis=1)


class HashHarris(_HashBase):
    """Harris lock-free list — no lock objects (CAS on next pointers)."""
    name = "hash-harris"


class HashPugh(_HashBase):
    """Pugh: fine-grained r/w lock per bucket."""
    name = "hash-pugh"

    def _n_lock_objects(self):
        return self.n_buckets

    def _lock_touch(self, op_keys):
        return [self.lock_base + self.bucket_of[op_keys]]


class HashCHM(_HashBase):
    """Java CHM: segmented bucket locks (16 segments)."""
    name = "hash-chm"
    N_SEG = 16

    def _n_lock_objects(self):
        return self.N_SEG

    def _lock_touch(self, op_keys):
        return [self.lock_base + self.bucket_of[op_keys] % self.N_SEG]


# ---------------------------------------------------------------------------
# Skip lists — search path touches tower nodes at descending levels
# ---------------------------------------------------------------------------
class _SkipBase(Structure):
    def _build(self):
        self.levels = max(2, int(math.log2(max(self.n, 2))))
        self.meta_sizes = self._meta()
        self.lock_base = self.meta_base

    def _meta(self) -> List[int]:
        return []

    def _locks(self, op_keys, is_update) -> List[np.ndarray]:
        return []

    def paths(self, op_keys, is_update):
        r = self.rank_of[op_keys]
        cols = []
        # descend: predecessor at level l is the rank with low l bits cleared
        for l in range(self.levels - 1, -1, -1):
            pred = (r >> l) << l
            cols.append((self.node_base +
                         self.key_at_rank[pred])[:, None])
        cols += [t[:, None] for t in self._locks(op_keys, is_update)]
        return np.concatenate(cols, axis=1)


class SkipCoarse(_SkipBase):
    """Global-lock skiplist (LevelDB memtable style) — one molten object."""
    name = "skip-coarse"

    def _meta(self):
        return [LOCK_BYTES]

    def _locks(self, op_keys, is_update):
        return [np.full(len(op_keys), self.lock_base, np.int64)]


class SkipFraser(_SkipBase):
    """Fraser lock-free skiplist (Redis sorted-set analog)."""
    name = "skip-fraser"


class SkipHerlihy(_SkipBase):
    """Herlihy optimistic: per-node lock words on pred/curr."""
    name = "skip-herlihy"

    def _meta(self):
        return [LOCK_BYTES] * self.n

    def _locks(self, op_keys, is_update):
        r = self.rank_of[op_keys]
        pred = self.key_at_rank[np.maximum(r - 1, 0)]
        return [self.lock_base + pred, self.lock_base + op_keys]


# ---------------------------------------------------------------------------
# B+Trees — root + internals are shared-hot; leaves follow key skew
# ---------------------------------------------------------------------------
class _BTreeBase(Structure):
    fanout = 64
    node_size = BTREE_NODE_BYTES

    def _build(self):
        f = self.fanout
        self.depth = max(1, math.ceil(math.log(max(self.n, 2), f)))
        # level l (0 = leaves): n_l = ceil(n / f^(l+1)) internal nodes
        self.level_sizes = [max(1, -(-self.n // f ** (l + 1)))
                            for l in range(self.depth)]
        self.level_base = np.cumsum([0] + self.level_sizes[:-1])
        self.meta_sizes = [self.node_size] * sum(self.level_sizes) + \
            self._extra_meta()
        self.extra_base = self.meta_base + sum(self.level_sizes)

    def _extra_meta(self) -> List[int]:
        return []

    def _extra(self, op_keys, is_update) -> List[np.ndarray]:
        return []

    def paths(self, op_keys, is_update):
        f = self.fanout
        r = self.rank_of[op_keys]
        cols = []
        for l in range(self.depth - 1, -1, -1):  # root .. leaf-parent
            node = r // f ** (l + 1)
            cols.append((self.meta_base + self.level_base[l] + node)[:, None])
        cols.append((self.node_base + op_keys)[:, None])  # leaf entry
        cols += [t[:, None] for t in self._extra(op_keys, is_update)]
        return np.concatenate(cols, axis=1)


class BTreeCoarse(_BTreeBase):
    """Global-lock B+Tree (SAP HANA style)."""
    name = "btree-coarse"

    def _extra_meta(self):
        return [LOCK_BYTES]

    def _extra(self, op_keys, is_update):
        return [np.full(len(op_keys), self.extra_base, np.int64)]


class BTreeOCC(_BTreeBase):
    """OCC B+Tree with epoch-based reclamation (VoltDB index style):
    every op touches the global epoch object; version words live inside
    the node objects already on the path."""
    name = "btree-occ"

    def _extra_meta(self):
        return [LOCK_BYTES]

    def _extra(self, op_keys, is_update):
        return [np.full(len(op_keys), self.extra_base, np.int64)]


class MassTree(_BTreeBase):
    """Masstree: trie of B+trees — modelled as a deeper, narrower tree
    (fanout 16) + RCU epoch object."""
    name = "masstree"
    fanout = 16
    node_size = MASSTREE_NODE_BYTES

    def _extra_meta(self):
        return [LOCK_BYTES]

    def _extra(self, op_keys, is_update):
        return [np.full(len(op_keys), self.extra_base, np.int64)]


# ---------------------------------------------------------------------------
# Adaptive Radix Tree — radix-256 path over the hashed key
# ---------------------------------------------------------------------------
class ART(Structure):
    """ART with fine-grained r/w locks: 4-level radix path on the hashed
    key; lock word per touched node (modelled for inner levels)."""
    name = "art"
    LEVELS = 4

    def _build(self):
        self.hash = self.rng.permutation(self.n).astype(np.int64)
        # level l: nodes keyed by the top (l+1) bytes of a 4-byte hash;
        # level sizes saturate at n
        self.level_sizes = [min(self.n, 256 ** (l + 1))
                            for l in range(self.LEVELS - 1)]
        self.level_base = np.cumsum([0] + self.level_sizes[:-1])
        n_nodes = sum(self.level_sizes)
        self.meta_sizes = [ART_NODE_BYTES] * n_nodes + \
            [LOCK_BYTES] * n_nodes
        self.lock_base = self.meta_base + n_nodes

    def paths(self, op_keys, is_update):
        h = self.hash[op_keys]
        cols = []
        for l in range(self.LEVELS - 1):
            node = (h >> (8 * (self.LEVELS - 1 - l))) % self.level_sizes[l]
            nid = self.level_base[l] + node
            cols.append((self.meta_base + nid)[:, None])
            cols.append((self.lock_base + nid)[:, None])
        cols.append((self.node_base + op_keys)[:, None])
        return np.concatenate(cols, axis=1)


STRUCTURES: Dict[str, type] = {
    s.name: s for s in (
        HashHarris, HashPugh, HashCHM,
        SkipCoarse, SkipFraser, SkipHerlihy,
        BTreeCoarse, BTreeOCC, MassTree, ART)
}


def make_structure(name: str, n_keys: int, seed: int = 0) -> Structure:
    return STRUCTURES[name](n_keys, seed)
