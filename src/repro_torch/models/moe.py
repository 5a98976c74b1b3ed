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
block runs inside the serve window's CUDA graph.

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
    decode discards it."""
    b, s, d = x.shape
    t = b * s
    g = capacity(t, cfg, capacity_factor)
    xf = x.reshape(t, d)
    if spmd.is_dtensor(x):
        # the dispatch ranks every slot among all slots of its expert:
        # it runs whole on every rank (the token shards all-gathered)
        buf, aux_loss, counts, src, w, idx = spmd.replicated(
            _dispatch, p["router"], xf, cfg, g, with_aux)
        # the experts' rows split over the data axes: with the expert
        # weights gathered there (FSDP), each data rank runs its share
        out = spmd.replicated(_combine, _experts(spmd.constrain(buf, dim=1),
                                                 p), src, w, idx)
        return spmd.constrain(out.reshape(b, s, d)), aux_loss, counts
    buf, aux_loss, counts, src, w, idx = _dispatch(p["router"], xf, cfg, g,
                                                   with_aux)
    return _combine(_experts(buf, p), src, w, idx).reshape(b, s, d), \
        aux_loss, counts


def _dispatch(router: torch.Tensor, xf: torch.Tensor, cfg, g: int,
              with_aux: bool):
    """Route the tokens xf [T, D] and gather them into the experts' rows:
    (buf [E, G, D], aux loss or None, counts [E] int32, and the combine's
    src [T*k], w [T*k] (0 for a dropped slot) and idx [T, k])."""
    t, d = xf.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    gates, topk_w, topk_e = _route({"router": router}, xf, k)

    n = t * k
    flat_e = topk_e.reshape(n)
    counts = _counts(flat_e, e)
    # load-balancing aux loss (Switch / Mixtral style)
    aux_loss = (e * torch.sum(gates.mean(0) * (counts.float() / n))
                if with_aux else None)

    # sort-based dispatch: slot i of the sorted order is token st[i]'s
    # choice of expert se[i], with weight sw[i]
    order = torch.argsort(flat_e, stable=True)
    se, sw, st = flat_e[order], topk_w.reshape(n)[order], order // k
    slots = torch.arange(n, device=xf.device)
    starts = torch.cumsum(counts, 0) - counts
    rank = slots - starts[se]
    keep = rank < g
    dest = torch.where(keep, se * g + rank, n)          # n: the drop bin
    # the row each sorted slot writes; the last write in sorted order wins
    winner = torch.full((e * g + 1,), -1, dtype=torch.int64,
                        device=xf.device).scatter_reduce_(
        0, dest, slots, "amax", include_self=True)
    src_tok = st[winner.clamp(min=0)]
    buf = torch.where((winner >= 0)[:, None], xf[src_tok],
                      torch.zeros((), dtype=xf.dtype, device=xf.device))

    # each token adds its k contributions in ascending expert id, which is
    # ascending sorted position: idx [T, k] holds each token's sorted
    # positions in that order
    src = torch.where(keep, se * g + rank, 0)
    w = torch.where(keep, sw, 0.0)
    idx = torch.empty_like(order).scatter_(0, order, slots)
    idx = torch.sort(idx.view(t, k), dim=-1).values
    return buf[:-1].reshape(e, g, d), aux_loss, counts, src, w, idx


def _combine(y: torch.Tensor, src: torch.Tensor, w: torch.Tensor,
             idx: torch.Tensor) -> torch.Tensor:
    """Gather the experts' rows y [E, G, D] back to the tokens [T, D]: the
    k weighted contributions of each token added one at a time."""
    t, k = idx.shape
    y = y.reshape(-1, y.shape[-1])
    parts = y[src[idx]] * w.to(y.dtype)[idx][..., None]  # [T, k, D]
    out = torch.zeros((t, y.shape[1]), dtype=y.dtype, device=y.device)
    for j in range(k):
        out = out + parts[:, j]
    return out


def moe_block_gathered(p: dict, x: torch.Tensor, cfg
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode-path MoE: gather only the routed experts' weights (exact, the
    same math as `moe_block` with no drops); it pays when T*k < E. x:
    [B, S, D] with small T = B*S. The aux loss is zero, as in JAX."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    xf = x.reshape(-1, d)
    _, topk_w, topk_e = _route(p, xf, k)
    wi, wg, wo = p["wi"][topk_e], p["wg"][topk_e], p["wo"][topk_e]
    h = torch.einsum("td,tkdf->tkf", xf, wi)
    g = torch.einsum("td,tkdf->tkf", xf, wg)
    h = F.silu(g.float()).to(h.dtype) * h
    y = torch.einsum("tkf,tkfd->tkd", h, wo)
    out = torch.einsum("tk,tkd->td", topk_w.to(y.dtype), y)
    return (out.reshape(b, s, d),
            torch.zeros((), dtype=torch.float32, device=x.device),
            _counts(topk_e.reshape(-1), e))


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
