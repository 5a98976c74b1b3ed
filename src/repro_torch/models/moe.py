"""Mixture-of-Experts with sort-based dispatch (port of
`repro/models/moe.py`).

Top-k routing in fp32 with softmax-renormalised weights; the slots are
sorted by expert, each expert takes at most G (`capacity`) of them into an
[E, G, D] buffer, the experts run as three batched products
[E, G, D] x [E, D, F] (plain `torch.bmm`, as the JAX package computes them
outside any Pallas kernel), and each token sums its k weighted outputs.
The per-expert counts are returned as the expert-level access bitmap that
`models/expert_tiering.py` consumes.

The port reproduces what the JAX package computes, bit for bit in its
integer parts:

  * experts are chosen by a stable descending sort of the gates, so among
    equal gates the lowest expert id wins, as `jax.lax.top_k` picks
    (`torch.topk` does not promise that order);
  * the drop bin of the dispatch is row n = T*k, which lies inside the
    [E*G] buffer (G >= 1.25 n / E): when a token is dropped, XLA's scatter
    lets the last write in sorted order win, so a kept slot at row n gets
    the last dropped token's input. The port finds, for every row, the
    largest sorted index that writes it (`scatter_reduce_` "amax", which
    is order-free) and gathers that token: deterministic on any device;
  * the combine adds each token's k contributions in ascending expert id
    (the sorted order JAX's scatter-add visits them) into a zero buffer of
    the output dtype, one add at a time. No atomics: graph and eager runs
    on the card agree bit for bit in bf16.

Every shape is static and nothing reads a device value on the host, so the
block runs inside the serve window's CUDA graph. On DTensors (the
sharding rules' layout) the dispatch is partitioned instead
(`_moe_block_sharded`): each rank routes its own tokens, every rank
computes the same integer bookkeeping from the gathered expert ids, and
slot rows move by all-to-all over the data axes, whose uneven counts the
host reads once a layer (that path runs eagerly, never in a graph).

Sharding hints (`set_sharding_hints`, `_hint`, the JAX package's
`with_sharding_constraint` hints of the dry run's "moe_hints" variant):
on DTensors (`launch/shardings.py`) a hint redistributes the dispatched
tokens [E, G, D] ("dispatch") and the experts' hidden [E, G, F]
("hidden") to the hinted specs on the tensor's own mesh, so that the
weights are gathered rather than partial sums of activations reduced. On
plain tensors a hint is the identity.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import spmd


_SHARDING_HINTS = None


def set_sharding_hints(hints) -> None:
    """hints: {"dispatch": spec for [E, G, D]-like tensors, "hidden": spec
    for [E, G, F]} (`launch.shardings.P`), or None to disable."""
    global _SHARDING_HINTS
    _SHARDING_HINTS = hints


def _hint(x: torch.Tensor, name: str) -> torch.Tensor:
    if not (_SHARDING_HINTS and name in _SHARDING_HINTS):
        return x
    if not spmd.is_dtensor(x):
        return x
    from repro_torch.launch.shardings import placements
    return x.redistribute(x.device_mesh, placements(
        x.device_mesh, _SHARDING_HINTS[name]))


def init_moe(cfg, dtype, generator, device) -> dict:
    """Router [D, E] fp32; wi / wg [E, D, F] and wo [E, F, D] in `dtype`,
    at the JAX package's scales."""
    d, e = cfg.d_model, cfg.num_experts
    f = cfg.moe_d_ff or cfg.d_ff

    def nrm(shape, scale, dt):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * scale).to(dt)
    s_in, s_out = d ** -0.5, f ** -0.5
    return {"router": nrm((d, e), s_in, torch.float32),
            "wi": nrm((e, d, f), s_in, dtype),
            "wg": nrm((e, d, f), s_in, dtype),
            "wo": nrm((e, f, d), s_out, dtype)}


def capacity(t: int, cfg, capacity_factor: float = 1.25) -> int:
    """Per-expert token capacity G of `moe_block`'s dispatch for `t`
    tokens: routing counts above it are dropped (their contribution is
    zero; the residual stream carries them)."""
    e, k = cfg.num_experts, cfg.experts_per_token
    g = int(max(8, -(-t * k // e) * capacity_factor))  # ceil with slack
    return -(-g // 8) * 8                              # pad to 8


def _route(p: dict, xf: torch.Tensor, k: int):
    """(gates [T, E] fp32, top-k weights [T, k] renormalised, top-k expert
    ids [T, k] int64), ties to the lowest expert id."""
    gates = torch.softmax(xf.float() @ p["router"], dim=-1)
    topk_w, topk_e = torch.sort(gates, dim=-1, descending=True, stable=True)
    topk_w, topk_e = topk_w[:, :k], topk_e[:, :k]
    return gates, topk_w / topk_w.sum(-1, keepdim=True), topk_e


def _counts(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Slots routed to each expert, [E] int32 (an integer sum: any order
    gives the same counts)."""
    return torch.zeros(e, dtype=torch.int32, device=flat_e.device) \
        .scatter_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))


def _experts(buf: torch.Tensor, p: dict) -> torch.Tensor:
    """SwiGLU of each expert over its rows: [E, G, D] -> [E, G, D]."""
    buf = _hint(buf, "dispatch")
    h = _hint(torch.bmm(buf, p["wi"]), "hidden")
    gate = _hint(torch.bmm(buf, p["wg"]), "hidden")
    h = F.silu(gate.float()).to(h.dtype) * h
    return _hint(torch.bmm(h, p["wo"]), "dispatch")


def moe_block(p: dict, x: torch.Tensor, cfg, capacity_factor: float = 1.25,
              with_aux: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux loss fp32 scalar, expert counts
    [E] int32). With `with_aux` False the aux loss is not computed (None):
    decode discards it. On DTensors the dispatch is partitioned
    (`_moe_block_sharded`)."""
    b, s, d = x.shape
    t = b * s
    g = capacity(t, cfg, capacity_factor)
    if spmd.is_dtensor(x):
        return _moe_block_sharded(p, x, cfg, g, with_aux)
    buf, aux_loss, counts, src, w, idx = _dispatch(p["router"],
                                                   x.reshape(t, d), cfg, g,
                                                   with_aux)
    return _combine(_experts(buf, p), src, w, idx).reshape(b, s, d), \
        aux_loss, counts


def _slots(flat_e: torch.Tensor, e: int, k: int, g: int):
    """The bookkeeping of the n = T*k slots (flat_e [n]: slot i is token
    i // k's choice i % k): counts [E] int32, the stable sort by expert
    `order` and, for each sorted slot, its expert se, its token st, its
    position `slots`, its rank among its expert's slots, whether it is
    kept (rank < g) and its row `dest` of the [E*G] buffer (n, the drop
    bin, when dropped). Integers only: every rank of a sharded block
    computes them alike from the gathered expert ids."""
    n = flat_e.shape[0]
    counts = _counts(flat_e, e)
    order = torch.argsort(flat_e, stable=True)
    se, st = flat_e[order], order // k
    slots = torch.arange(n, device=flat_e.device)
    starts = torch.cumsum(counts, 0) - counts
    rank = slots - starts[se]
    keep = rank < g
    dest = torch.where(keep, se * g + rank, n)          # n: the drop bin
    return counts, order, se, st, slots, rank, keep, dest


def _winners(dest: torch.Tensor, slots: torch.Tensor, rows: int):
    """For each of the buffer's `rows` rows, the largest sorted slot that
    writes it, -1 for none (the last write in sorted order wins, as in
    XLA's scatter; a drop bin past the buffer writes nothing)."""
    return torch.full((max(rows, dest.shape[0]) + 1,), -1, dtype=torch.int64,
                      device=dest.device).scatter_reduce_(
        0, dest, slots, "amax", include_self=True)[:rows]


def _dispatch(router: torch.Tensor, xf: torch.Tensor, cfg, g: int,
              with_aux: bool):
    """Route the tokens xf [T, D] and gather them into the experts' rows:
    (buf [E, G, D], aux loss or None, counts [E] int32, and the combine's
    src [T*k], w [T*k] (0 for a dropped slot) and idx [T, k])."""
    t, d = xf.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    gates, topk_w, topk_e = _route({"router": router}, xf, k)
    n = t * k
    counts, order, se, st, slots, rank, keep, dest = _slots(
        topk_e.reshape(n), e, k, g)
    # load-balancing aux loss (Switch / Mixtral style)
    aux_loss = (e * torch.sum(gates.mean(0) * (counts.float() / n))
                if with_aux else None)
    # slot i of the sorted order is token st[i]'s choice of expert se[i],
    # with weight sw[i]; each row takes the token of its last writer
    sw = topk_w.reshape(n)[order]
    winner = _winners(dest, slots, e * g)
    buf = torch.where((winner >= 0)[:, None], xf[st[winner.clamp(min=0)]],
                      torch.zeros((), dtype=xf.dtype, device=xf.device))
    # each token adds its k contributions in ascending expert id, which is
    # ascending sorted position: idx [T, k] holds each token's sorted
    # positions in that order
    src = torch.where(keep, se * g + rank, 0)
    w = torch.where(keep, sw, 0.0)
    idx = torch.empty_like(order).scatter_(0, order, slots)
    idx = torch.sort(idx.view(t, k), dim=-1).values
    return buf.reshape(e, g, d), aux_loss, counts, src, w, idx


def _combine(y: torch.Tensor, src: torch.Tensor, w: torch.Tensor,
             idx: torch.Tensor) -> torch.Tensor:
    """Gather the experts' rows y [E, G, D] back to the tokens [T, D]: the
    k weighted contributions of each token added one at a time."""
    y = y.reshape(-1, y.shape[-1])
    return _add_parts(y[src[idx]], w[idx])


def _add_parts(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """rows [T, k, D] weighted by w [T, k] (fp32) and added one at a time,
    in k order, into a zero [T, D] buffer of the rows' dtype."""
    parts = rows * w.to(rows.dtype)[..., None]
    out = torch.zeros((rows.shape[0], rows.shape[2]), dtype=rows.dtype,
                      device=rows.device)
    for j in range(rows.shape[1]):
        out = out + parts[:, j]
    return out


def _expert_split(w, mesh) -> str:
    """How the experts' weights lie on "model": "experts" (wi's expert
    dim split there: each model rank runs its experts), "ffn" (the hidden
    dim split: each runs a partial sum of every expert) or "whole"."""
    from torch.distributed.tensor import Shard
    names = tuple(mesh.mesh_dim_names)
    if "model" not in names or mesh.size(names.index("model")) == 1 or \
            not spmd.is_dtensor(w):
        return "whole"
    place = w.placements[names.index("model")]
    if place == Shard(0):
        return "experts"
    return "ffn" if place == Shard(2) else "whole"


def _exchange(rows: torch.Tensor, counts, me: int, group) -> torch.Tensor:
    """rows [N, D], sorted by the rank they go to, exchanged over `group`
    (an all-to-all; counts[s][r]: rows rank s sends rank r): the rows
    that reach this rank, by sending rank."""
    if group is None:
        return rows
    from torch.distributed import _functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_to_all_single_autograd(
        rows, [c[me] for c in counts], list(counts[me]), group))


class _GatherCols(torch.autograd.Function):
    """rows [N, D / n] of each of the n ranks of `group` (one slice of the
    hidden width each, the same rows everywhere) gathered to [N, D]. The
    backward keeps this rank's slice of the gradient, which every rank
    holds whole (the rows feed the same product on every rank)."""

    @staticmethod
    def forward(ctx, rows, group, me):
        from torch.distributed import _functional_collectives as funcol
        ctx.me, ctx.cols = me, rows.shape[1]
        return funcol.wait_tensor(funcol.all_gather_tensor(
            rows.contiguous(), 1, group))

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.me * ctx.cols:(ctx.me + 1) * ctx.cols], None, None


def _host_counts(mats: torch.Tensor, balanced) -> list:
    """The exchange's counts [2, nd, nd] on the host: the one host sync of
    a sharded MoE layer. Fake tensors (the dry run) hold no values: there
    the counts of a balanced routing, `balanced()`, stand in."""
    from torch._subclasses.fake_tensor import FakeTensor
    if isinstance(mats, FakeTensor):
        return balanced()
    return mats.tolist()


def _moe_block_sharded(p: dict, x, cfg, g: int, with_aux: bool):
    """`moe_block` on DTensors, partitioned as XLA partitions the JAX
    package's block, with no rank holding every token [T, D] or the whole
    [E, G, D]:

      * routing: each rank routes its own tokens (its batch shard over the
        data axes); only the routing is gathered over the data axes, the
        gates [T, E] fp32 (for the aux loss's mean) and the expert ids
        [T*k]; every rank then computes the global stable sort, ranks,
        counts and capacity drops (`_slots`) and the aux loss, bit for
        bit the plain block's;
      * rows: a rank computes the experts' rows it owns, its experts on
        "model" (all of them, partially over the hidden dim, where wi's
        hidden dim is split there) x its share of the capacity G over the
        data axes (`_capacity_shares`), through `_experts` on a DTensor
        [E, G, D] (so the hints keep their meaning), the weights
        FSDP-gathered; the token rows those rows need reach it by an
        all-to-all over the data axes (a rank sends at most k * T_local
        rows, and receives the filled rows it owns);
      * combine: the rows' outputs go back by the reverse all-to-all, and
        each rank adds its own tokens' k contributions in ascending expert
        id (`_add_parts`, as `_combine`); contributions of experts on other
        "model" ranks make the result a partial sum over "model", which
        `spmd.constrain` all-reduces ([T_local, D], the dense FFN's TP
        sum).

    Uneven all-to-all splits need the counts on the host once a layer
    (`_host_counts`). Where the batch does not divide the data axes (a
    decode of fewer sequences), every data rank holds every token and
    runs the block for them all, as the dense FFN does there."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t, n = b * s, b * s * k
    x = x.redistribute(mesh, spmd._layout(mesh, b))
    nd, di, group = spmd.data_group(mesh) if b % spmd._data_size(
        mesh) == 0 else (1, 0, None)
    xd = Shard(0) if nd > 1 else Replicate()     # x's data placement
    split = _expert_split(p["wi"], mesh)
    mi = mesh.get_local_rank("model") if split != "whole" else 0
    ce = e // mesh.size(names.index("model")) if split == "experts" else e
    e0 = mi * ce if split == "experts" else 0

    def place(data_p, model_p):
        return tuple(data_p if name in spmd.data_axes(mesh) else
                     model_p if name == "model" else Replicate()
                     for name in names)
    whole = place(Replicate(), Replicate())
    rest = Replicate() if split == "whole" else Partial()
    tl = t // nd
    dev = x.to_local().device

    # routing: own tokens; the w path's gradient is this rank's share
    x_route = x.to_local(grad_placements=place(xd, rest)).reshape(tl, d)
    router = p["router"]
    if spmd.is_dtensor(router):
        router = router.to_local(grad_placements=place(
            Partial() if nd > 1 else Replicate(), rest))
    _, topk_w, topk_e = _route({"router": router}, x_route, k)
    ids = DTensor.from_local(topk_e.to(torch.int32), mesh,
                             place(xd, Replicate()), run_check=False)
    flat_e = ids.redistribute(mesh, whole).to_local().reshape(n).long()
    counts, order, se, st, slots, rank, keep, dest = _slots(flat_e, e, k, g)
    aux_loss = None
    if with_aux:
        gates = torch.softmax(x.reshape(t, d).float() @ p["router"], dim=-1)
        gates = gates.redistribute(mesh, whole).to_local()
        aux_loss = DTensor.from_local(
            e * torch.sum(gates.mean(0) * (counts.float() / n)), mesh,
            whole, run_check=False)

    # the rows this rank owns: experts [e0, e0 + ce) x its share of G
    held = _capacity_shares(g, nd, mesh)
    gd = len(held[di])
    g_owner, g_local = _capacity_owners(held, g, dev)
    mine_g = torch.arange(held[di].start, held[di].stop, held[di].step,
                          device=dev)
    kept = torch.arange(g, device=dev) < counts[e0:e0 + ce, None]  # [ce, G]
    row_tok = st[_winners(dest, slots, e * g).view(e, g)[e0:e0 + ce]
                 .clamp(min=0)]
    row_from = row_tok // tl
    col = torch.arange(ce * g, device=dev).view(ce, g)
    here = keep & (se >= e0) & (se < e0 + ce)   # sorted slots with rows here
    r_owner = g_owner[rank.clamp(max=g - 1)]
    t_owner = st // tl
    mats = torch.zeros(2, nd * nd, dtype=torch.int64, device=dev)
    mats[0].scatter_add_(0, (row_from * nd + g_owner).reshape(-1),
                         kept.reshape(-1).long())
    mats[1].scatter_add_(0, r_owner * nd + t_owner, here.long())

    def balanced():
        f = min(-(-n // e), g)
        rows = [ce * len(range(r.start, min(r.stop, f), r.step))
                for r in held]
        fwd = [[r // nd + (i < r % nd) for r in rows] for i in range(nd)]
        return [sum(fwd, []), sum(map(list, zip(*fwd)), [])]
    fwd, rev = [[m[i * nd:(i + 1) * nd] for i in range(nd)]
                for m in _host_counts(mats, balanced)]

    # forward: each row's token from its data rank. Where every model rank
    # runs every expert (the hidden dim split), the model ranks of a data
    # index need the same rows: each moves its 1 / model of the hidden
    # width over the data axes, and the widths are gathered over "model"
    nm = mesh.size(names.index("model")) if split == "ffn" else 1
    cols = d // nm if group is not None and d % nm == 0 else d
    c0 = mi * cols if cols < d else 0
    rows_h = x.to_local(grad_placements=place(
        xd, Partial() if split == "experts" or cols < d else Replicate())
    ).reshape(tl, d)[:, c0:c0 + cols]
    big = nd * ce * g
    sent = kept & (row_from == di)
    pick = torch.argsort(torch.where(sent, g_owner * (ce * g) + col,
                                     big + col).reshape(-1))[:sum(fwd[di])]
    recv = _exchange(rows_h[row_tok.reshape(-1)[pick] - di * tl], fwd, di,
                     group)
    if cols < d:
        recv = _GatherCols.apply(recv, mesh.get_group("model"), mi)
    mine = kept[:, mine_g].reshape(-1)
    key = torch.where(kept[:, mine_g], row_from[:, mine_g] * (ce * g)
                      + col[:, mine_g], big + col[:, mine_g])
    pos = torch.where(mine, _inverse(torch.argsort(key.reshape(-1))),
                      recv.shape[0])
    buf = torch.cat([recv, recv.new_zeros(1, d)])[pos].view(ce, gd, d)
    buf = DTensor.from_local(
        buf, mesh, place(Shard(1) if nd > 1 else Replicate(),
                         Shard(0) if split == "experts" else Replicate()),
        run_check=False, shape=(e, g, d), stride=(g * d, d, 1))
    y = _experts(buf, p)

    # the rows' outputs, this rank's share of each: its experts' rows, or
    # its partial sums over the hidden dim (as the product left them)
    y_data = Shard(1) if nd > 1 else Replicate()
    y_model = y.placements[names.index("model")] if "model" in names \
        else Replicate()
    if split == "experts":
        y = y.redistribute(mesh, place(y_data, Shard(0))).to_local()
    elif split == "ffn" and y_model == Partial():
        y = y.redistribute(mesh, place(y_data, Partial())).to_local()
    elif split == "ffn":
        # a hint left the rows whole on "model": rank 0 of it adds them
        y = y.redistribute(mesh, place(y_data, Replicate())).to_local(
            grad_placements=place(y_data, Partial())) * (mi == 0)
    else:
        y = y.redistribute(mesh, place(y_data, Replicate())).to_local()
    y = y.reshape(ce * gd, d)

    # back: each kept slot's row to its token's data rank
    out_sent = here & (r_owner == di)
    pick = torch.argsort(torch.where(out_sent, t_owner * n + slots,
                                     nd * n + slots))[:sum(rev[di])]
    row = (se - e0) * gd + g_local[rank.clamp(max=g - 1)]
    back = _exchange(y[row[pick]], rev, di, group)
    inv = _inverse(torch.argsort(torch.where(here & (t_owner == di),
                                             r_owner * n + slots,
                                             nd * n + slots)))
    own = _inverse(order)[di * tl * k:(di + 1) * tl * k]
    idx = torch.sort(own.view(tl, k), dim=-1).values  # own tokens' slots
    pos = torch.where(here[idx], inv[idx], back.shape[0])
    w = torch.where(keep[idx], topk_w.reshape(-1)[order[idx] - di * tl * k],
                    0.0)
    out = _add_parts(torch.cat([back, back.new_zeros(1, d)])[pos], w)
    out = DTensor.from_local(out.view(b // nd, s, d), mesh, place(xd, rest),
                             run_check=False)
    counts = DTensor.from_local(counts, mesh, whole, run_check=False)
    return spmd.constrain(out), aux_loss, counts


def _capacity_shares(g: int, nd: int, mesh) -> list:
    """The capacity positions (0..G-1 of every expert) each of the nd data
    ranks holds, as ranges, in the order of its local rows: every nd-th
    where nd divides G (an expert's slots fill its rows from position 0,
    so interleaving spreads the filled rows evenly over the data ranks),
    else `spmd.chunk_ranges`' chunks. Either way a rank holds as many as
    a DTensor shard of G over the data axes has rows: the [E, G, D]
    DTensor holds the experts' rows with G permuted, which products row by
    row and redistributions carry as they are."""
    if nd > 1 and g % nd == 0:
        return [range(r, g, nd) for r in range(nd)]
    return [range(lo, hi) for lo, hi in (spmd.chunk_ranges(g, mesh)
                                         if nd > 1 else [(0, g)])]


def _capacity_owners(held: list, g: int, dev):
    """For each capacity position 0..G-1, the data rank holding it and its
    local row there (`_capacity_shares`' ranges `held`), as tensors."""
    pos = torch.arange(g, device=dev)
    if held[0].step > 1:
        return pos % len(held), pos // len(held)
    # the last chunk starting at or before each position (an empty chunk
    # starts where the next one does)
    starts = torch.tensor([r.start for r in held], device=dev)
    owner = torch.searchsorted(starts, pos, right=True) - 1
    return owner, pos - starts[owner]


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    """The inverse of the permutation perm [N]: where each i went."""
    return torch.empty_like(perm).scatter_(
        0, perm, torch.arange(perm.shape[0], device=perm.device))


def moe_block_gathered(p: dict, x: torch.Tensor, cfg
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode-path MoE: gather only the routed experts' weights (exact, the
    same math as `moe_block` with no drops); it pays when T*k < E. x:
    [B, S, D] with small T = B*S. The aux loss is zero, as in JAX. On
    DTensors each rank runs it on its own shards
    (`_moe_block_gathered_sharded`)."""
    if spmd.is_dtensor(x):
        return _moe_block_gathered_sharded(p, x, cfg)
    b, s, d = x.shape
    out, counts = _gathered(p, x.reshape(-1, d), cfg)
    return (out.reshape(b, s, d),
            torch.zeros((), dtype=torch.float32, device=x.device), counts)


def _gathered(p: dict, xf: torch.Tensor, cfg):
    """The routed experts' products over the tokens xf [T, D]: (out [T, D],
    counts [E] int32)."""
    e, k = cfg.num_experts, cfg.experts_per_token
    _, topk_w, topk_e = _route(p, xf, k)
    return _products(p, xf, topk_w, topk_e), _counts(topk_e.reshape(-1), e)


def _products(p: dict, xf: torch.Tensor, w: torch.Tensor, ids: torch.Tensor
              ) -> torch.Tensor:
    """sum_c w[t, c] * SwiGLU of expert ids[t, c] (an index into p's
    experts) over xf [T, D]: [T, D]. Reads one expert matrix per row of
    ids."""
    wi, wg, wo = p["wi"][ids], p["wg"][ids], p["wo"][ids]
    h = torch.einsum("td,tkdf->tkf", xf, wi)
    g = torch.einsum("td,tkdf->tkf", xf, wg)
    h = F.silu(g.float()).to(h.dtype) * h
    y = torch.einsum("tkf,tkfd->tkd", h, wo)
    return torch.einsum("tk,tkd->td", w.to(y.dtype), y)


def _moe_block_gathered_sharded(p: dict, x, cfg):
    """`moe_block_gathered` on DTensors, on each rank's own shards (through
    local_map): its tokens (the batch over the data axes where it divides
    them), the router whole, and the experts' weights as the rules lay
    them on "model" (`_expert_split`), never gathered there: where the
    experts are split, a rank takes the routed rows of its own experts
    only; where their hidden dim is, every routed row over its slice.
    Either way the out is partial over "model", summed by
    `spmd.constrain` (the dense FFN's TP sum), and the counts of the own
    tokens partial over the data axes, summed to the whole [E]."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    split = _expert_split(p["wi"], mesh)
    x_place = spmd._layout(mesh, x.shape[0])
    rest = Replicate() if split == "whole" else Partial()
    model = {"experts": (Shard(0), Shard(0)), "ffn": (Shard(2), Shard(1)),
             "whole": (Replicate(), Replicate())}[split]
    w_place = [tuple(model[i] if name == "model" else Replicate()
                     for name in names) for i in (0, 0, 1)]
    whole = tuple(Replicate() for _ in names)
    e0 = mesh.get_local_rank("model") * (cfg.num_experts //
                                         mesh.size(names.index("model"))) \
        if split == "experts" else 0
    own = tuple(Partial() if isinstance(pl, Shard) else Replicate()
                for pl in x_place)

    def local(x_, router, wi, wg, wo):
        b, s, d = x_.shape
        xf, lp = x_.reshape(-1, d), dict(router=router, wi=wi, wg=wg, wo=wo)
        if split != "experts":
            out, counts = _gathered(lp, xf, cfg)
            return out.reshape(b, s, d), counts
        # only the (token, choice) pairs routed to this rank's experts
        _, topk_w, topk_e = _route(lp, xf, cfg.experts_per_token)
        t, c = torch.nonzero((topk_e >= e0) & (topk_e < e0 + wi.shape[0]),
                             as_tuple=True)
        part = _products(lp, xf[t], topk_w[t, c][:, None],
                         (topk_e[t, c] - e0)[:, None])
        out = torch.zeros_like(xf).index_add_(0, t, part)
        return (out.reshape(b, s, d),
                _counts(topk_e.reshape(-1), cfg.num_experts))
    data = spmd.data_axes(mesh)
    out, counts = local_map(
        local, device_mesh=mesh, redistribute_inputs=True,
        out_placements=(tuple(rest if name == "model" else pl
                              for name, pl in zip(names, x_place)), own),
        in_placements=(x_place, whole, *w_place),
        in_grad_placements=(
            spmd._partial_on(mesh, x_place, () if split == "whole"
                             else ("model",)),
            spmd._partial_on(mesh, whole, data),
            *(spmd._partial_on(mesh, pl, data) for pl in w_place)))(
        x, p["router"], p["wi"], p["wg"], p["wo"])
    zero = DTensor.from_local(torch.zeros((), dtype=torch.float32,
                                          device=x.to_local().device),
                              mesh, whole, run_check=False)
    return spmd.constrain(out), zero, counts.redistribute(mesh, whole)


def moe_block_ref(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Oracle: every expert over every token, combined by the top-k gates.
    O(E x full FLOPs), tiny shapes only; no capacity drops, so it matches
    `moe_block` only when no expert overflows."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    gates, topk_w, topk_e = _route(p, xf, cfg.experts_per_token)
    w = torch.zeros_like(gates).scatter_(1, topk_e, topk_w)     # [T, E]
    h = torch.einsum("td,edf->etf", xf, p["wi"])
    g = torch.einsum("td,edf->etf", xf, p["wg"])
    h = F.silu(g.float()).to(h.dtype) * h
    y = torch.einsum("etf,efd->etd", h, p["wo"])                 # [E, T, D]
    return torch.einsum("te,etd->td", w.to(y.dtype), y).reshape(b, s, d)
