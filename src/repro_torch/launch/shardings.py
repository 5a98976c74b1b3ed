"""Sharding rules (port of `repro/launch/shardings.py`): parameter,
optimizer, batch and decode-state specs for every architecture, derived
from leaf paths and shapes, and their layout as DTensors.

Scheme (the JAX package's):
  * 2-D weight sharding = FSDP over "data" x TP over "model": every
    large matrix shards its TP axis (heads / d_ff / experts / vocab) over
    "model" and its other big axis over "data" (ZeRO-3 style). Tensors
    whose dims don't divide are left replicated on that axis (MQA kv
    projections, tiny norms). The rules place the weights; where XLA's
    SPMD partitioner inserts the all-gathers, the port's layers gather
    each weight's data shards where they start (`models/spmd.py`
    `gather_weights`), and the gradients go back to these placements by
    reduce-scatter.
  * The "pod" axis carries pure data parallelism: params are NOT sharded
    over pods; the batch is.
  * Decode KV caches shard batch over "data" and cache length over
    "model".

A spec is what JAX's PartitionSpec is (`P`, a tuple): one entry per
tensor dim, each None, an axis name or a tuple of axis names (the dim
split over several mesh axes, the first major). `placements` turns it
into DTensor placements, one per mesh dim: `Shard(d)` on each mesh dim
that tensor dim d names, `Replicate()` on the others; `distribute` lays a
tree out as DTensors.

Leaf layout: the port keeps one dict per layer (`layers/3/wq` [D, E]),
where JAX stacks the layers on a leading axis (`layers/wq` [L, D, E];
zamba2's mamba blocks on [G, per]). The rules key on the last name, on
"moe" in the path and on the trailing dims, so a port leaf's spec is
JAX's with the stacked leading entries dropped. Decode states are stacked
alike in both packages ([L, B, C, KV, Dh]; zamba2's h [G, per, B, N, nh,
64]), so their specs are JAX's entry for entry.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

from repro_torch import tree as tree_lib
from repro_torch.launch.mesh import axis_sizes


class P(tuple):
    """A partition spec: P(None, "model"), P(("data", "model"), None). A
    one-name tuple entry is that name, as JAX's PartitionSpec has it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _div(n: int, size: int) -> bool:
    return n > 0 and size > 0 and n % size == 0


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def param_spec(mesh, path: str, shape: Sequence[int],
               variant: str = "") -> P:
    """Spec of one parameter leaf. Paths look like layers/3/wq,
    layers/3/moe/wi, mamba/2/1/m/in_proj, embed, out, ...

    Variants:
      "moe_zero"  — MoE expert weights TP-only on F (contraction dim
                    unsharded -> no activation-sized partial-sum
                    all-reduces); optimizer state stays 2-D (ZeRO).
      "serve_tp"  — decode-only: TP over ("data", "model") on every
                    output dim (batch ~ 1 leaves "data" idle).
    """
    dsz = _axis_size(mesh, "data")
    msz = _axis_size(mesh, "model")
    name = path.split("/")[-1]
    nd = len(shape)

    def spec(*trailing):
        return P(*([None] * (nd - len(trailing)) + list(trailing)))

    if variant == "serve_tp":
        both = dsz * msz

        def tp(out_axis_last: bool):
            a, b = shape[-2:]
            out = b if out_axis_last else a
            if out % both == 0:
                e = ("data", "model")
            elif out % msz == 0:
                e = "model"
            else:
                return P()
            return spec(None, e) if out_axis_last else spec(e, None)

        if name in ("wq", "wk", "wv", "xq", "xv", "xk", "wi", "wg",
                    "in_proj", "x_proj", "dt_proj"):
            if "moe" in path:
                f = shape[-1]
                if f % both == 0:
                    return spec(None, None, ("data", "model"))
                return spec(None, None,
                            "model" if f % msz == 0 else None)
            return tp(out_axis_last=True)
        if name in ("wo", "xo", "out_proj"):
            if "moe" in path:
                f = shape[-2]
                if f % both == 0:
                    return spec(None, ("data", "model"), None)
                return spec(None,
                            "model" if f % msz == 0 else None, None)
            return tp(out_axis_last=False)
        if name == "embed":
            v, _ = shape
            return P(("data", "model") if v % both == 0 else
                     ("model" if v % msz == 0 else None), None)
        if name == "out":
            _, v = shape
            return P(None, ("data", "model") if v % both == 0 else
                     ("model" if v % msz == 0 else None))
        return P()

    if variant == "moe_zero" and "moe" in path:
        if name in ("wi", "wg"):
            return spec(None, None, "model" if _div(shape[-1], msz)
                        else None)
        if name == "wo":
            return spec(None, "model" if _div(shape[-2], msz) else None,
                        None)

    if name in ("ln", "ln1", "ln2", "ln_x", "final_ln", "enc_ln", "norm",
                "conv_b", "dt_bias", "D", "A_log", "conv_w", "router"):
        return P()
    if name == "embed":
        v, d = shape
        return P("model" if _div(v, msz) else None,
                 "data" if _div(d, dsz) else None)
    if name == "out":
        d, v = shape
        return P("data" if _div(d, dsz) else None,
                 "model" if _div(v, msz) else None)
    if name in ("wq", "wk", "wv", "xq", "xk", "xv"):
        d, e = shape[-2:]
        return spec("data" if _div(d, dsz) else None,
                    "model" if _div(e, msz) else None)
    if name in ("wo", "xo") and nd >= 2 and "moe" not in path:
        e, d = shape[-2:]
        return spec("model" if _div(e, msz) else None,
                    "data" if _div(d, dsz) else None)
    if "moe" in path and name in ("wi", "wg"):
        e, d, f = shape[-3:]
        if _div(e, msz):
            return spec("model", "data" if _div(d, dsz) else None, None)
        return spec(None, "data" if _div(d, dsz) else None,
                    "model" if _div(f, msz) else None)
    if "moe" in path and name == "wo":
        e, f, d = shape[-3:]
        if _div(e, msz):
            return spec("model", None, "data" if _div(d, dsz) else None)
        return spec(None, "model" if _div(f, msz) else None,
                    "data" if _div(d, dsz) else None)
    if name in ("wi", "wg"):                      # dense ffn
        d, f = shape[-2:]
        return spec("data" if _div(d, dsz) else None,
                    "model" if _div(f, msz) else None)
    if name == "wo":                              # dense ffn out
        f, d = shape[-2:]
        return spec("model" if _div(f, msz) else None,
                    "data" if _div(d, dsz) else None)
    if name in ("in_proj", "x_proj", "dt_proj", "out_proj"):
        a, b = shape[-2:]
        return spec("data" if _div(a, dsz) else None,
                    "model" if _div(b, msz) else None)
    return P()


def _with_paths(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """A tree of `tree`'s structure holding fn(path, leaf) at each leaf."""
    names, leaves = tree_lib.flatten_with_paths(tree)
    return tree_lib.unflatten(tree, [fn(n, x) for n, x in zip(names, leaves)])


def param_shardings(mesh, params_shape: Any, variant: str = "") -> Any:
    """Spec tree matching a params tree (real or "meta" tensors)."""
    return _with_paths(lambda path, leaf: param_spec(
        mesh, path, tuple(leaf.shape), variant), params_shape)


def opt_shardings(mesh, opt_shape: Any, params_sh: Any,
                  params_shape: Any = None, variant: str = "") -> Any:
    """Optimizer m/v inherit the param specs; step is replicated. Under
    "moe_zero" m/v keep the BASELINE 2-D shards (ZeRO: the update
    resharding is a weights-sized reduce-scatter/all-gather instead of
    activation-sized partial-sum all-reduces)."""
    mv_sh = params_sh
    if variant == "moe_zero" and params_shape is not None:
        mv_sh = param_shardings(mesh, params_shape, variant="")
    return {"m": mv_sh, "v": mv_sh, "step": P()}


def batch_spec(mesh, ndim: int) -> P:
    """Batch arrays: leading dim over (pod, data)."""
    axes = ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
    return P(axes, *([None] * (ndim - 1)))


def batch_shardings(mesh, batch_shape: Any) -> Any:
    sizes = axis_sizes(mesh)
    total = sizes.get("pod", 1) * sizes.get("data", 1)

    def one(_, leaf):
        if leaf.dim() >= 1 and leaf.shape[0] % total == 0:
            return batch_spec(mesh, leaf.dim())
        return P()
    return _with_paths(one, batch_shape)


def decode_state_shardings(mesh, state_shape: Any, cfg,
                           variant: str = "") -> Any:
    """KV caches [L, B, C, KV, D]: B->data, C->model. SSM states
    [L, B, ...]: B->data (zamba2's [G, per, B, ...]: B->data). enc_out
    batch-sharded; a non-tensor leaf (the port's "pos", a Python int) has
    no spec (None). "serve_tp": cache length shards over BOTH axes (idle
    batch)."""
    dsz = _axis_size(mesh, "data")
    msz = _axis_size(mesh, "model")

    def c_axis(c):
        if variant == "serve_tp" and _div(c, dsz * msz):
            return ("data", "model")
        return "model" if _div(c, msz) else None

    def b_axis(b):
        return "data" if _div(b, dsz) and variant != "serve_tp" else None

    def one(path, leaf):
        if not hasattr(leaf, "shape"):
            return None
        name = path.split("/")[-1]
        shape = tuple(leaf.shape)
        if name in ("k", "v"):
            _, b, c, _, _ = shape
            return P(None, b_axis(b), c_axis(c), None, None)
        if name == "k_pos":
            _, b, c = shape
            return P(None, b_axis(b), c_axis(c))
        if name in ("h", "conv"):
            bdim = 1 if len(shape) >= 3 else 0
            spec = [None] * len(shape)
            if _div(shape[bdim], dsz):
                spec[bdim] = "data"
            # zamba2 stacks states [groups, per, B, ...]
            if len(shape) >= 4 and not _div(shape[1], dsz) and \
                    _div(shape[2], dsz):
                spec = [None] * len(shape)
                spec[2] = "data"
            return P(*spec)
        if name == "enc_out":
            return P("data" if _div(shape[0], dsz) else None)
        return P()
    return _with_paths(one, state_shape)


# --- DTensor layout --------------------------------------------------------

def placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements of `spec` on `mesh`, one per mesh dim: Shard(d)
    on every mesh dim that tensor dim d's entry names, Replicate()
    elsewhere. A tuple entry must list its axes in mesh order (major
    first), the layout DTensor gives a dim sharded on two mesh dims."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = []
        for ax in axes:
            if ax not in names:
                raise ValueError(f"spec {spec} names axis {ax!r}, not in "
                                 f"mesh axes {names}")
            idx.append(names.index(ax))
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order "
                             f"{names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} used twice in "
                                 f"{spec}")
            out[i] = Shard(d)
    return tuple(out)


def _map2(fn, tree: Any, specs: Any) -> Any:
    """fn(leaf, spec) over a tree and a spec tree of its structure, in
    `repro_torch.tree`'s leaf order (the tree's leaves decide where the
    spec tree stops: a spec is a tuple)."""
    if isinstance(tree, dict):
        return {k: _map2(fn, tree[k], specs[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, t, s) for t, s in zip(tree, specs,
                                                          strict=True))
    return fn(tree, specs)


def distribute_leaf(t, mesh, spec, src_data_rank: Optional[int] = 0):
    """One tensor as a DTensor laid out by `spec` (moved to the mesh's
    device type). src_data_rank=None takes each rank's shard from its own
    copy with no communication (every rank must hold the same tensor);
    an int scatters that rank's copy."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(mesh, spec),
                             src_data_rank=src_data_rank)


def distribute(tree: Any, mesh, specs: Any,
               src_data_rank: Optional[int] = 0) -> Any:
    """A params / optimizer / batch / state tree as DTensors on `mesh`, by
    the spec tree `specs` of its structure (`param_shardings`,
    `opt_shardings`, `batch_shardings`, `decode_state_shardings`).
    Leaves that are not tensors, or whose spec is None, pass through."""
    import torch

    def one(t, spec):
        if not isinstance(t, torch.Tensor) or spec is None:
            return t
        return distribute_leaf(t, mesh, spec, src_data_rank)
    return _map2(one, tree, specs)


def param_placer(mesh, variant: str = "") -> Callable[[str, Any], Any]:
    """place(path, leaf) -> the leaf as a DTensor by `param_spec`, each
    rank keeping its shard of its own copy (no communication: every rank
    must draw the same leaf). `Model.init(generator, place=...)` applies
    it leaf by leaf as the weights are drawn, so the whole tree never
    exists on one device."""
    def place(path, leaf):
        return distribute_leaf(
            leaf, mesh, param_spec(mesh, path, tuple(leaf.shape), variant),
            src_data_rank=None)
    return place
