"""Bytes and operations of the HADES kernels, counted from what their
inputs need (each input byte read once, each output byte written once),
and their device time in a profiled stretch. Kernel names
are as the profiler lists them."""
from __future__ import annotations

from typing import Dict, Iterable

KERNELS = {"paged_attention": ("paged_attention_split",
                               "paged_attention_combine_kernel"),
           "access_scan": ("access_scan_kernel",),
           "migrate": ("migrate_kernel",)}


def device_time(profile: Dict, kernel: str):
    """(launches, device seconds) of `kernel` in a profile: launches are
    counted by its first kernel's name, time over all of them."""
    names = KERNELS[kernel]
    n, t = 0, 0.0
    for name, (k, s) in profile["kernels_by_name"].items():
        if any(p in name for p in names):
            t += s
            if names[0] in name:
                n += k
    return n, t


def paged_attention_bytes(lens: Iterable[int], heads: int, kv_heads: int,
                          head_dim: int, dtype_bytes: int) -> float:
    """One launch over sequences of `lens` tokens: their keys and values,
    each active sequence's query and output."""
    lens = [x for x in lens if x > 0]
    kv = 2 * sum(lens) * kv_heads * head_dim * dtype_bytes
    return kv + 2 * len(lens) * heads * head_dim * dtype_bytes


def access_scan_bytes(n_words: int) -> float:
    """The table read and written (4 + 4 bytes a word), two verdict masks
    (1 + 1), the threshold read and the skip count written."""
    return 10.0 * n_words + 8


def migrate_bytes(rows: float, row_bytes: int, moves: int) -> float:
    """Each moved row read and written; the move lists (source and
    destination int32, a flag byte) of `moves` entries read."""
    return 2.0 * rows * row_bytes + 9.0 * moves

