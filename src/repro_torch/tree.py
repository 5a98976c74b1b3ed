"""Parameter trees of the port: nested dicts and lists (tuples) of tensors.

The leaf order is `jax.tree_util`'s: dict keys sorted, sequences in order.
A leaf's path name is the "/"-join of the dict keys and list indices
that lead to it, as the JAX package's checkpoints name their leaves.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten_with_paths(tree: Any, prefix: Tuple = ()
                       ) -> Tuple[List[str], List[Any]]:
    """(names, leaves) in `jax.tree_util`'s leaf order."""
    if isinstance(tree, dict):
        names, leaves = [], []
        for k in sorted(tree):
            n, lv = flatten_with_paths(tree[k], prefix + (k,))
            names += n
            leaves += lv
        return names, leaves
    if isinstance(tree, (list, tuple)):
        names, leaves = [], []
        for i, v in enumerate(tree):
            n, lv = flatten_with_paths(v, prefix + (i,))
            names += n
            leaves += lv
        return names, leaves
    return ["/".join(map(str, prefix))], [tree]


def leaves(tree: Any) -> List[Any]:
    return flatten_with_paths(tree)[1]


def unflatten(like: Any, new_leaves: List[Any]) -> Any:
    """A tree of `like`'s structure holding `new_leaves`, in leaf order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map_leaves(fn: Callable[[Any], Any], tree: Any) -> Any:
    return unflatten(tree, [fn(x) for x in leaves(tree)])
