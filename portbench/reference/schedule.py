"""A plain model of a continuous-batching server's lanes, from the request
sizes alone (every request runs to its max_new; no stop token): FIFO
admission into free lanes at each window's entry, `window` steps a
window, a lane done once its last token is due and freed at the next
entry, one all-inactive window at the end that frees the last lanes. It
gives, for every window, the lanes that run in it and the paged blocks
each one holds at the window's close: the plain recount of the KV pool's
live blocks, and the sequence lengths the attention reads."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def windows(sizes: Sequence[Tuple[int, int]], lanes: int, window: int,
            max_len: int) -> List[Dict]:
    """sizes: (prompt length, max_new) per request, in queue order. Returns
    one dict per window: "running" [(lane, rid, steps before the window)]
    and "admitted" / "freed" counts."""
    queue = list(enumerate(sizes))
    lane: List = [None] * lanes          # [rid, steps, done]
    out = []
    while True:
        admitted = freed = 0
        for i in range(lanes):
            if lane[i] is not None and lane[i][2]:
                lane[i] = None
                freed += 1
            if lane[i] is None and queue:
                rid, _ = queue.pop(0)
                lane[i] = [rid, 0, False]
                admitted += 1
        if all(ln is None for ln in lane) and not freed:
            break
        running = [(i, ln[0], ln[1]) for i, ln in enumerate(lane)
                   if ln is not None]
        for ln in lane:
            if ln is None:
                continue
            p, n = sizes[ln[0]]
            last = min(p + n - 2, max_len - 1)    # step of the last token
            ln[2] = last < ln[1] + window
            ln[1] += window
        out.append({"running": running, "admitted": admitted,
                    "freed": freed})
    return out


def live_blocks(win: Dict, window: int, block_tokens: int, max_blocks: int,
                layers: int) -> int:
    """Blocks held at the close of window `win`: each running lane holds
    ceil(tokens / block_tokens) blocks (at most max_blocks) a layer."""
    return layers * sum(
        min(-(-(s + window) // block_tokens), max_blocks)
        for _, _, s in win["running"])
