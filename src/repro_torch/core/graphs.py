"""A window program as ONE CUDA graph replay over a static carry: the
port's counterpart of the JAX package's jitted window programs with a
donated carry. `runtime/server.Server` (its serve and decode windows) and
`core/engine.make_run_window` (the object engine's windows) both run
through it.

  * The static carry: once a graph exists, every leaf of the carry lives in
    a buffer the graphs read and write (`bind`); a captured body ends by
    copying each leaf the window replaced back into its buffer
    (`write_back`). One leaf, the pool's `data`, is adopted as it is: the
    window updates it in place and it is never copied.
  * `first_window`: a key's first window runs for real on the capture
    stream (so that per-stream state, such as access_scan's scratch, exists
    before the capture), then the body is captured there on a static copy
    of its input; a capture runs nothing, so the window does not advance
    twice. A capture that fails raises: nothing falls back.
  * `replay`: copy the input into the graph's static input, replay, and add
    the kernel launches its capture recorded (`kops.add_counts`), so that
    `kops.launches` stays true under replays. A body that opens a span
    recorder program (`spans.program`) leaves its stamp area with the
    graph, and each replay hands it to the window's copy (`spans.ran`).

All graphs of one holder share one memory pool.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch import spans
from repro_torch.kernels import ops as kops


@dataclasses.dataclass
class Graph:
    """One captured window program: the graph, its static input (a tensor
    or a pytree of tensors) and outputs, the kernel launches one replay
    makes, and the span recorder's program it captured (None when the
    recorder was off)."""
    graph: object
    x: object
    outs: object
    counts: Dict[str, Dict[str, int]]
    stamps: object = None


class WindowGraphs:
    """The captured programs of one carry, keyed by the caller."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graphs: Dict[tuple, Graph] = {}
        self.static: Optional[List[torch.Tensor]] = None
        self.spec = None
        self.side = self.mempool = None

    def bind(self, carry, adopt: Callable):
        """`carry` bound to the static carry: the first time, its leaves are
        cloned into it, except the leaf `adopt(carry)`, which is taken as it
        is; after that, each leaf that is not its buffer already is copied
        into it."""
        leaves, spec = pytree.tree_flatten(carry)
        if self.static is None:
            kept = adopt(carry)
            self.static = [t if t is kept else t.clone() for t in leaves]
            self.spec = spec
        else:
            if spec != self.spec:
                raise RuntimeError("the carry changed its structure")
            for buf, t in zip(self.static, leaves):
                if t is not buf:
                    buf.copy_(t)
        return pytree.tree_unflatten(self.static, self.spec)

    def write_back(self, carry) -> None:
        """The end of a captured body: copy each leaf the window replaced
        into its static buffer. A new leaf that is a view of a static buffer
        would be overwritten by an earlier copy: it raises."""
        leaves, spec = pytree.tree_flatten(carry)
        if spec != self.spec:
            raise RuntimeError("the window changed the carry's structure")
        owned = {b.untyped_storage().data_ptr() for b in self.static}
        for buf, t in zip(self.static, leaves):
            if t is buf:
                continue
            if t.untyped_storage().data_ptr() in owned:
                raise RuntimeError("a window output aliases the static carry")
            buf.copy_(t)

    def replay(self, g: Graph, x):
        """One replay of `g` on input `x` (the carry bound already).
        Returns the graph's static outputs, which the next replay
        overwrites."""
        for buf, t in zip(pytree.tree_leaves(g.x), pytree.tree_leaves(x)):
            buf.copy_(t)
        g.graph.replay()
        kops.add_counts(g.counts)
        if g.stamps is not None:
            spans.ran(g.stamps)
        return g.outs

    def first_window(self, key, body: Callable, carry, x, adopt: Callable,
                     generator: Optional[torch.Generator] = None):
        """Run `body(carry, x)` for real on the capture stream, bind its
        carry, then capture `body` under `key` on a static copy of `x`
        (with `generator`'s state registered, for a sampled program).
        Returns (the bound carry, the real run's outputs)."""
        if self.side is None:
            self.side = torch.cuda.Stream(self.device)
            self.mempool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(self.device)
        self.side.wait_stream(cur)
        with torch.cuda.stream(self.side):
            carry, outs = body(carry, x)
        cur.wait_stream(self.side)
        carry = self.bind(carry, adopt)
        static_x = pytree.tree_map(torch.clone, x)
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        snap = kops.count_snapshot()
        spans.take_captured()
        try:
            with torch.cuda.graph(graph, pool=self.mempool, stream=self.side):
                new, static_outs = body(carry, static_x)
                self.write_back(new)
        finally:
            counts = kops.counts_since(snap)
        self.graphs[key] = Graph(graph, static_x, static_outs, counts,
                                 spans.take_captured())
        return carry, outs
