"""The model's attention on DTensors (the port's counterpart of what XLA's
SPMD partitioner does with the JAX package's attention).

Attention is parallel over batch and heads, and a layout that shards a
tensor over both (the batch over "data", the heads over "model") merges
them into one batch dim of the score product, which DTensor's sharding
propagation cannot express (`aten.bmm` on a dim sharded twice). So a
DTensor call of an attention function runs the plain function on each
rank's shard through `torch.distributed.tensor.experimental.local_map`:

  * q, k, v [B, S, H|KV, D] are first redistributed to the batch over the
    data axes ("pod", "data") and the heads over "model", where they
    divide (otherwise replicated on that axis); a redistribution shows in
    the collective counts like any other;
  * with the q heads over "model" and KV heads that do not divide it
    (GQA / MQA), k and v stay whole on "model" and each rank picks the kv
    head of each of its q heads (h // (H / KV));
  * positions and masks that the forward built as plain tensors are the
    same on every rank: they enter as replicated and are cut to the batch
    shard locally.

Decode attention over a cache whose length is sharded on "model" (the
sharding rules' layout for decode: batch over "data", cache length over
"model") is flash decoding: each rank writes the new token where its
shard holds the slot, takes the softmax partials (max, sum, weighted sum)
over its part of the cache, and the partials are combined by all-reduces
over "model" (max, then sums), what the JAX package's SPMD program lowers
to (a psum over the sharded length).

Likewise the mamba1 scan (`scan`) and mamba2's SSD core (`batch_heads`)
run on local batch / channel / head shards, the embedding lookup
(`lookup`) on each rank's rows of the vocab, and the loss (`vocab_nll`)
on each rank's vocab shard of the logits, whose log-sum-exp and label
pick take all-reduces of [B, S] over "model" and never gather the
logits; a head whose vocab the rules leave whole on "model" (one the
axis does not divide) is split there first (`shard_on_model`). The MoE
block partitions its dispatch itself (`models/moe.py`: each rank routes
its own tokens, only the routing is gathered over the data axes, and
slot rows move by all-to-all over the data group, `data_group`).
`constrain` (the residual stream and its gradient in the batch layout),
`pin_grad` (a gradient back in its tensor's layout) and `split_heads`
(GQA kv heads gathered on "model") keep DTensor's propagation away from
dims sharded twice, which it has no rule for.

The weights follow the sharding rules' scheme, FSDP over the data axes x
TP over "model": `gather_weights`, called on a layer's parameters where
they enter its body (inside the rematerialised function), gathers each
weight's data-axis shards and keeps its "model" shards, so every product
contracts whole rows and the TP sums over "model" are the only
activation-sized reductions. Its backward reduce-scatters the weight's
gradient back to the leaf's own shards. On plain tensors every function
here is the plain call.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from repro_torch.launch.mesh import axis_sizes, data_axes

if torch.distributed.is_available():
    from torch.distributed.tensor import DTensor
else:                                   # a torch without distributed
    DTensor = ()


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def _data_size(mesh) -> int:
    n = 1
    for name in data_axes(mesh):
        n *= axis_sizes(mesh)[name]
    return n


def _layout(mesh, batch: Optional[int], heads: Optional[int] = None,
            head_dim: int = 2, batch_dim: int = 0) -> tuple:
    """Placements: dim `batch_dim` over the data axes if `batch` (None: no
    batch dim) divides them, dim `head_dim` over "model" if `heads`
    divides it; Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    data_ok = batch is not None and batch % _data_size(mesh) == 0
    msz = axis_sizes(mesh).get("model", 1)
    out = []
    for name in mesh.mesh_dim_names:
        if name in data_axes(mesh) and data_ok:
            out.append(Shard(batch_dim))
        elif name == "model" and heads is not None and heads % msz == 0:
            out.append(Shard(head_dim))
        else:
            out.append(Replicate())
    return tuple(out)


def gathered_placements(mesh, placements) -> tuple:
    """The placements `gather_weights` gives a leaf laid out as
    `placements` on `mesh`: Replicate on each data-axis mesh dim that
    shards a tensor dim "model" does not also shard (FSDP's gather), every
    other placement as it is ("model" shards: TP; a dim split over
    ("data", "model") together, the "serve_tp" layout, stays). Raises on
    a placement that is neither Shard nor Replicate (a Partial weight)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    for p in placements:
        if not isinstance(p, (Shard, Replicate)):
            raise ValueError(f"gather_weights: placement {p} of "
                             f"{tuple(placements)} is not Shard / Replicate")
    model = {p.dim for name, p in zip(names, placements)
             if name == "model" and isinstance(p, Shard)}
    data = data_axes(mesh)
    return tuple(Replicate() if name in data and isinstance(p, Shard)
                 and p.dim not in model else p
                 for name, p in zip(names, placements))


def shard_on_model(x, dim: int):
    """x with dim `dim` split over "model" where x is a DTensor whole on
    that axis (a Replicate -> Shard redistribution: each rank keeps its
    chunk, no collective; uneven chunks as `torch.chunk` cuts them, e.g.
    256,206 over 16: fifteen of 16,013 and one of 16,011). For a weight
    the sharding rules leave whole on "model" because the dim does not
    divide it (seamless-m4t's vocab in the head): without the split every
    model rank computes the whole product. Its gradient goes back in the
    layout it comes in (`_Split`). Plain tensors, a mesh without a
    "model" axis of size > 1 and a DTensor already split on "model" pass
    as they are."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    if axis_sizes(mesh).get("model", 1) == 1:
        return x
    i = names.index("model")
    if x.placements[i] != Replicate():
        return x
    place = list(x.placements)
    place[i] = Shard(dim % x.dim())
    return _Split.apply(x, tuple(place))


class _Split(torch.autograd.Function):
    """x redistributed to `place`, its gradient passed on in the layout it
    comes in: the redistribution's own backward would gather a weight's
    gradient over "model" and all-reduce it over the data axes, where the
    gradient of a leaf gathered by `gather_weights` then needs only its
    reduce-scatter over the data axes and a gather over "model"."""

    @staticmethod
    def forward(ctx, x, place):
        return x.redistribute(x.device_mesh, place)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_weights(tree):
    """A layer's parameter dict (or list of them, or one leaf) with every
    DTensor leaf redistributed to `gathered_placements`: each weight
    gathered over the data axes, its "model" shards kept. The identity on
    plain tensors and when the data axes have size 1 (the (1, 1) and
    (1, n) meshes). Called where a layer's weights enter its body, inside
    the function that `transformer._maybe_remat` wraps: the gathered copy
    lives for one layer and is gathered again in the recompute, and the
    redistribution's backward returns the gradient in the leaf's own
    placements (a reduce-scatter over the data axes of the gradient's
    partial sums; an all-reduce for a leaf with nothing to gather), which
    AdamW's state shares."""
    if isinstance(tree, dict):
        return {k: gather_weights(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_weights(v) for v in tree)
    if not is_dtensor(tree) or _data_size(tree.device_mesh) == 1:
        return tree
    place = gathered_placements(tree.device_mesh, tree.placements)
    if place == tuple(tree.placements):
        # nothing to gather (a replicated norm scale, "serve_tp"): the
        # gradient, partial over the batch's data axes, is all-reduced
        # back to the leaf's placements all the same
        return pin_grad(tree)
    return tree.redistribute(tree.device_mesh, place)


def data_group(mesh):
    """(size, this rank's index, process group) of the data axes taken
    together, in the order DTensor splits a dim sharded on all of them
    (the batch): the group is None for size 1, one axis's group, or the
    flattened group of several (the multi-pod mesh's ("pod", "data"))."""
    axes = data_axes(mesh)
    sizes = axis_sizes(mesh)
    index = 0
    for name in axes:
        index = index * sizes[name] + mesh.get_local_rank(name)
    big = tuple(name for name in axes if sizes[name] > 1)
    if not big:
        return 1, 0, None
    group = mesh.get_group(big[0]) if len(big) == 1 else \
        mesh[big]._flatten().get_group()
    return _data_size(mesh), index, group


def chunk_ranges(n: int, mesh) -> list:
    """[(lo, hi)] of a dim of n split over every data axis of `mesh`, for
    each index of `data_group` in order: `torch.chunk` over the first axis,
    each chunk again over the next, as DTensor lays out a dim sharded on
    several mesh dims (uneven and empty chunks included)."""
    ranges = [(0, n)]
    for name in data_axes(mesh):
        parts = axis_sizes(mesh)[name]
        ranges = [(lo + _chunk_first(hi - lo, parts, i),
                   lo + _chunk_first(hi - lo, parts, i + 1))
                  for lo, hi in ranges for i in range(parts)]
    return ranges


def _partial_on(mesh, place, axes) -> tuple:
    """`place` with Partial() on each mesh dim named in `axes` where it is
    Replicate: the layout of the gradient of a local_map input that each
    rank uses whole but only for its own shard of the work (a weight the
    batch shards share, kv heads each "model" rank picks from), whose
    local gradients are that rank's part of the sum."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple(Partial() if name in axes and p == Replicate() else p
                 for name, p in zip(mesh.mesh_dim_names, place))


def lookup(fn: Callable, table, tokens):
    """fn(table, tokens), an embedding lookup (`layers.embed`: rows of
    table [V, D] at tokens [B, ...]). On a DTensor table, each rank looks
    up its batch shard's tokens (over the data axes, where B divides them)
    in its shard of the rows (the vocab over "model", where the table has
    it so), rows outside the shard as zeros, and the result is partial
    over "model": the next layout redistribution sums it, one row from
    one rank (vocab-parallel embedding, as XLA partitions a gather from a
    row-sharded table). The table's gradient stays a local scatter into
    each rank's rows, partial over the data axes. Plain tensors go to fn
    as they are."""
    if not is_dtensor(table):
        return fn(table, tokens)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    names = tuple(mesh.mesh_dim_names)
    split = "model" in names and \
        table.placements[names.index("model")] == Shard(0)
    t_place = tuple(Shard(0) if name == "model" and split else Replicate()
                    for name in names)
    i_place = _layout(mesh, tokens.shape[0])
    out = tuple(Partial() if name == "model" and split else p
                for name, p in zip(names, i_place))

    def local(table_, tokens_):
        if not split:
            return fn(table_, tokens_)
        rows = table_.shape[0]
        idx = tokens_.long() - mesh.get_local_rank("model") * rows
        inside = (idx >= 0) & (idx < rows)
        got = fn(table_, idx.clamp(0, rows - 1))
        return torch.where(inside[..., None], got,
                           torch.zeros((), dtype=got.dtype,
                                       device=got.device))
    return local_map(local, out_placements=list(out),
                     in_placements=(t_place, i_place),
                     in_grad_placements=(_partial_on(mesh, t_place,
                                                     data_axes(mesh)),
                                         i_place),
                     device_mesh=mesh, redistribute_inputs=True)(
        table, _as_dtensor(tokens, mesh))


def _chunk_first(n: int, parts: int, i: int) -> int:
    """Where chunk i of `torch.chunk`'s `parts` chunks of n starts (n if it
    is empty): the offset of a rank's shard of a dim DTensor splits
    unevenly."""
    return min(i * -(-n // parts), n)


class _VocabNLL(torch.autograd.Function):
    """-log softmax(logits)[label] on each rank's vocab shard: the max,
    the sum of exp(logit - max) and the label's logit (0 on the ranks
    whose shard does not hold it) all-reduced over `group` (None: the
    vocab is whole here). The backward is local: (softmax - onehot) of
    the shard, times the incoming gradient."""

    @staticmethod
    def forward(ctx, logits, labels, first, group):
        v = logits.shape[-1]
        m = logits.detach().amax(-1)
        if group is not None:
            m = _wait(_all_reduce(m, "max", group))
        den = torch.exp(logits - m[..., None]).sum(-1)
        idx = labels - first
        inside = (idx >= 0) & (idx < v)
        idx = idx.clamp(0, v - 1)
        picked = torch.where(inside, torch.gather(
            logits, -1, idx[..., None])[..., 0],
            torch.zeros((), dtype=logits.dtype, device=logits.device))
        if group is not None:
            den = _wait(_all_reduce(den, "sum", group))
            picked = _wait(_all_reduce(picked, "sum", group))
        ctx.save_for_backward(logits, m, den, idx, inside)
        return torch.log(den) + m - picked

    @staticmethod
    def backward(ctx, g):
        logits, m, den, idx, inside = ctx.saved_tensors
        sm = torch.exp(logits - m[..., None]) / den[..., None]
        onehot = (torch.arange(logits.shape[-1], device=logits.device)
                  == idx[..., None]) & inside[..., None]
        return (sm - onehot.to(sm.dtype)) * g[..., None], None, None, None


def vocab_nll(logits, labels):
    """-log softmax(logits)[labels] [B, S] of logits [B, S, V] and labels
    [B, S] (int, in range). On DTensor logits each rank works on its batch
    shard and its shard of the vocab (over "model", even or not): the
    log-sum-exp and the label's logit take three all-reduces of [B, S]
    over "model" (max, sum, sum), and nothing gathers the logits, as XLA
    partitions JAX's `log_softmax` / `take_along_axis` loss over vocab-
    sharded logits; the gradient stays a local [B, S, V/model] shard. The
    result is laid out as the batch. Plain logits take the plain
    `log_softmax` and `gather` (the reference's own order of operations)."""
    if not is_dtensor(logits):
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, labels[..., None])[..., 0]
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    names = tuple(mesh.mesh_dim_names)
    v = logits.shape[-1]
    split = "model" in names and logits.placements[names.index(
        "model")] == Shard(logits.dim() - 1)
    row_place = _layout(mesh, logits.shape[0])
    l_place = tuple(Shard(logits.dim() - 1) if name == "model" and split
                    else p for name, p in zip(names, row_place))
    group = mesh.get_group("model") if split else None

    def local(logits_, labels_):
        first = _chunk_first(v, mesh.size(names.index("model")),
                             mesh.get_local_rank("model")) if split else 0
        return _VocabNLL.apply(logits_, labels_.long(), first, group)
    return local_map(local, out_placements=list(row_place),
                     in_placements=(l_place, row_place),
                     in_grad_placements=(l_place, row_place),
                     device_mesh=mesh, redistribute_inputs=True)(
        logits, _as_dtensor(labels, mesh))


def _as_dtensor(x, mesh):
    """A plain tensor built alike on every rank, as a replicated DTensor."""
    from torch.distributed.tensor import Replicate
    if x is None or is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _local_kv_heads(mesh, k, heads_local: int, n_rep: int):
    """k [B, S, KV, D], whole on "model": the kv head of each of this
    rank's q heads [B, S, heads_local, D]."""
    first = mesh.get_local_rank("model") * heads_local
    idx = torch.div(torch.arange(first, first + heads_local,
                                 device=k.device), n_rep,
                    rounding_mode="floor")
    return k.index_select(2, idx)


def attention(fn: Callable, q, k, v, *args, **kw):
    """fn(q, k, v, *args, **kw) on each rank's batch and head shard of the
    DTensors q [B, Sq, H, D], k / v [B, Sk, KV, D]; tensor arguments in
    args / kw (positions, masks: [B, ...]) are cut to the batch shard, the
    others pass as they are. The result is a DTensor laid out as q."""
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    b, _, h, _ = q.shape
    kv = k.shape[2]
    msz = axis_sizes(mesh).get("model", 1)
    q_place = _layout(mesh, b, h)
    heads_split = h % msz == 0
    kv_split = heads_split and kv % msz == 0
    kv_place = _layout(mesh, b, kv if kv_split else None)
    pick = heads_split and not kv_split and msz > 1
    given = list(enumerate(args)) + list(kw.items())
    keys = [key for key, x in given if isinstance(x, torch.Tensor)]
    tensors = [_as_dtensor(dict(given)[key], mesh) for key in keys]

    def local(q_, k_, v_, *ts):
        if pick:
            k_ = _local_kv_heads(mesh, k_, q_.shape[2], h // kv)
            v_ = _local_kv_heads(mesh, v_, q_.shape[2], h // kv)
        got = dict(zip(keys, ts))
        return fn(q_, k_, v_, *[got.get(i, x) for i, x in enumerate(args)],
                  **{n: got.get(n, x) for n, x in kw.items()})

    places = (q_place, kv_place, kv_place) + tuple(
        _layout(mesh, b) for _ in tensors)
    kv_grad = _partial_on(mesh, kv_place, ("model",) if pick else ())
    return local_map(local, out_placements=list(q_place), in_placements=places,
                     in_grad_placements=(q_place, kv_grad, kv_grad)
                     + places[3:],
                     device_mesh=mesh, redistribute_inputs=True)(
        q, _as_dtensor(k, mesh), _as_dtensor(v, mesh), *tensors)


def decode_attention(q, cache: dict, new_k, new_v, pos: int,
                     cache_len: int, window: int):
    """One decode step of attention over a layer's dense cache of
    DTensors {"k", "v": [B, C, KV, D], "k_pos": [B, C]}: writes new_k /
    new_v [B, 1, KV, D] and `pos` at slot pos % C IN PLACE
    (`attention.write_cache` on the rank whose shard holds the slot),
    then attends q [B, 1, H, D] over the first `cache_len` slots (with the
    sliding window by absolute positions). The cache keeps its layout
    (batch over the data axes, length over "model" where it divides);
    q and the new entries are replicated on "model" to meet it. Over a
    sharded length each rank takes `attention.decode_attention_partial`
    over its slots, and the partials are combined by all-reduces."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.models import attention as attn_lib
    mesh = q.device_mesh
    c = cache["k"].shape[1]
    cache_place = tuple(cache["k"].placements)
    pos_place = tuple(cache["k_pos"].placements)
    split = tuple(i for i, p in enumerate(cache_place)
                  if isinstance(p, Shard) and p.dim == 1)
    if any(isinstance(p, Shard) and p.dim not in (0, 1)
           for p in cache_place):
        raise ValueError(f"cache placements {cache_place}")
    row_place = tuple(p if isinstance(p, Shard) and p.dim == 0
                      else Replicate() for p in cache_place)
    slot = pos % c
    group = [mesh.get_group(i) for i in split]

    def local(q_, kc, vc, kp, nk, nv):
        c_local = kc.shape[1]
        first = 0
        for i in split:
            first = first * mesh.shape[i] + mesh.get_local_rank(i)
        first *= c_local
        local_cache = {"k": kc, "v": vc, "k_pos": kp}
        if first <= slot < first + c_local:
            attn_lib.write_cache(local_cache, slot - first, nk, nv, pos)
        if not split:
            return attn_lib.decode_attention(q_, kc, vc, cache_len,
                                             window=window, k_pos=kp,
                                             q_pos=pos)
        valid = attn_lib.decode_mask(c_local, cache_len, window=window,
                                     k_pos=kp, q_pos=pos,
                                     device=q_.device, first=first)
        out, m, den = attn_lib.decode_attention_partial(q_, kc, vc, valid)
        m_all = m
        for g in group:
            m_all = _all_reduce(m_all, "max", g)
        out, den = attn_lib.rescale_partial(out, m, den, m_all)
        for g in group:
            den = _all_reduce(den, "sum", g)
            out = _all_reduce(out, "sum", g)
        return attn_lib.normalise_partials(out, den).to(q_.dtype)

    f = local_map(local, out_placements=list(row_place),
                  in_placements=(row_place, cache_place, cache_place,
                                 pos_place, row_place, row_place),
                  device_mesh=mesh, redistribute_inputs=True)
    return f(q, cache["k"], cache["v"], cache["k_pos"],
             _as_dtensor(new_k, mesh), _as_dtensor(new_v, mesh))


def _all_reduce(x, op: str, group):
    """A functional all-reduce over `group` (it shows in the collective
    counts as `_c10d_functional.all_reduce`)."""
    from torch.distributed import _functional_collectives as funcol
    return funcol.all_reduce(x, op, group)


def _wait(x):
    """A functional collective's result, waited for."""
    from torch.distributed import _functional_collectives as funcol
    return funcol.wait_tensor(x)


def wrap(fn: Callable) -> Callable:
    """fn, an attention function taking q, k, v first (those of
    `models/attention.py`, the flash_attention kernel's wrapper), routed
    through `attention` when its q is a DTensor."""
    @functools.wraps(fn)
    def run(q, k, v, *args, **kw):
        if is_dtensor(q):
            return attention(fn, q, k, v, *args, **kw)
        return fn(q, k, v, *args, **kw)
    return run


class _Constrain(torch.autograd.Function):
    """x redistributed to `place`, and its gradient too (a redistribution's
    own backward returns the gradient in the input's layout)."""

    @staticmethod
    def forward(ctx, x, place):
        ctx.place = place
        return x.redistribute(x.device_mesh, place)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.place), None


def constrain(x, dim: int = 0):
    """The residual stream [B, S, D] and its gradient in the batch layout:
    batch over the data axes, whole on "model" (a redistribution, the
    counterpart of JAX's `with_sharding_constraint`); a plain tensor as
    it is. Without it DTensor's propagation may leave the stream, or its
    gradient, sharded over the sequence on "model", which the next
    flattening product cannot take (a dim sharded twice). `dim` names
    another dim to split over the data axes in place of the batch (the
    MoE experts' rows [E, G, D] on G: with the experts' weights gathered,
    each data rank computes its share of the rows)."""
    if not is_dtensor(x):
        return x
    return _Constrain.apply(x, _layout(x.device_mesh, x.shape[dim],
                                       batch_dim=dim))


def pin_grad(x):
    """x as it is, its gradient redistributed to x's own layout (a
    DTensor's; a plain tensor passes). Where DTensor would resolve a
    partial gradient by scattering it over the sequence (the mamba2
    block's gated norm, on the multi-pod mesh), the layout the forward
    had comes back, and the weight gradient's product stays
    expressible."""
    if not is_dtensor(x):
        return x
    return _Constrain.apply(x, tuple(x.placements))


def split_heads(t, heads: int):
    """t [..., heads * Dh] -> [..., heads, Dh]. A DTensor whose last dim
    is sharded on "model" in more shards than it has heads (the kv
    projection of GQA / MQA: 2 kv heads over a model axis of 16) is first
    gathered on "model": DTensor cannot lay one head over several ranks."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        mesh = t.device_mesh
        place = list(t.placements)
        for i, p in enumerate(place):
            if isinstance(p, Shard) and p.dim == t.dim() - 1 and \
                    heads % mesh.shape[i]:
                place[i] = Replicate()
        if place != list(t.placements):
            t = t.redistribute(mesh, place)
    return t.reshape(*t.shape[:-1], heads, t.shape[-1] // heads)


def batch_heads(fn: Callable, heads: int, *args, out):
    """fn(*tensors), each arg a (tensor, batch dim or None, head dim or
    None) and `out` each output's (batch dim, head dim): on DTensors every
    rank runs fn on its shard of the batch (over the data axes, where it
    divides) and of the `heads` heads (over "model", where they divide
    it), every other dim whole (a tensor without a head dim, e.g. one the
    heads share, whole on "model"). For work that is independent across
    sequences and heads (the SSD block of mamba2). Plain tensors go to fn
    as they are."""
    tensors = [t for t, _, _ in args]
    if not any(is_dtensor(t) for t in tensors):
        return fn(*tensors)
    from torch.distributed.tensor.experimental import local_map
    mesh = next(t.device_mesh for t in tensors if is_dtensor(t))
    b = next(t.shape[bd] for t, bd, _ in args if bd is not None)
    msz = axis_sizes(mesh).get("model", 1)
    split = heads % msz == 0

    def place(bd, hd):
        return _layout(mesh, None if bd is None else b,
                       heads if split and hd is not None else None,
                       head_dim=0 if hd is None else hd,
                       batch_dim=0 if bd is None else bd)

    def grad_place(bd, hd):
        # an input without a batch (head) dim is used whole by every
        # batch (head) shard: its gradient is partial over those axes
        return _partial_on(mesh, place(bd, hd), (
            data_axes(mesh) if bd is None else ()) + (
            ("model",) if hd is None and split else ()))
    return local_map(
        fn, out_placements=tuple(list(place(bd, hd)) for bd, hd in out),
        in_placements=tuple(place(bd, hd) for _, bd, hd in args),
        in_grad_placements=tuple(grad_place(bd, hd) for _, bd, hd in args),
        device_mesh=mesh, redistribute_inputs=True)(
        *[_as_dtensor(t, mesh) for t in tensors])


def scan(fn: Callable, a, b, h0):
    """fn(a, b, h0), the mamba_scan recurrence (a, b [B, S, C, N], h0
    [B, C, N]; sequential over S, parallel over the other dims), on each
    rank's shard when a is a DTensor: a and b keep their shards of B, C
    and N, and are gathered over S (and summed, if partial); h0 follows
    them. Plain tensors go to fn as they are."""
    if not is_dtensor(a):
        return fn(a, b, h0)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = a.device_mesh
    lane = {0: 0, 2: 1, 3: 2}          # a's dim -> h0's dim
    a_place = tuple(p if isinstance(p, Shard) and p.dim in lane
                    else Replicate() for p in a.placements)
    h_place = tuple(Shard(lane[p.dim]) if isinstance(p, Shard) else p
                    for p in a_place)
    return local_map(fn, out_placements=(list(a_place), list(h_place)),
                     in_placements=(a_place, a_place, h_place),
                     device_mesh=mesh, redistribute_inputs=True)(
        a, _as_dtensor(b, mesh), _as_dtensor(h0, mesh))
