"""MoE expert tiering: the HADES management plane for expert slabs (port
of `repro/models/expert_tiering.py`).

The per-expert routed-token counts that `moe_block` returns every step are
the access bitmap at expert granularity. This module runs the same CIW +
MIAD state machine over experts: hot experts stay resident in device
memory, cold ones become demotion candidates once the re-route rate
(tokens that hit a demoted expert, which faults its slab back) is below
target. It keeps the residency decisions and the accounting; no slab
moves. The state is a dict of int32 / bool / fp32 tensors, updated
functionally, and matches the JAX package's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ExpertTieringConfig:
    num_layers: int
    num_experts: int
    bytes_per_expert: int
    ciw_threshold: int = 3
    ciw_max: int = 31
    promotion_target: float = 0.01
    miad_mult: float = 2.0
    miad_add: float = 1.0
    ct_min: float = 1.0
    ct_max: float = 16.0


def init(cfg: ExpertTieringConfig, device="cpu") -> Dict:
    le = (cfg.num_layers, cfg.num_experts)

    def zero():
        return torch.zeros((), dtype=torch.int32, device=device)
    return {
        "ciw": torch.zeros(le, dtype=torch.int32, device=device),
        "resident": torch.ones(le, dtype=torch.bool, device=device),
        "ct": torch.tensor(float(cfg.ciw_threshold), dtype=torch.float32,
                           device=device),
        "win_routed": zero(),
        "win_promos": zero(),      # tokens routed to demoted experts
        "total_faults": zero(),
    }


def observe(cfg: ExpertTieringConfig, state: Dict, counts: torch.Tensor
            ) -> Dict:
    """counts: [L, E] tokens routed per expert this step. Tokens that hit a
    non-resident expert are promotion events (its slab faults back)."""
    hit = counts > 0
    faulted = hit & ~state["resident"]
    return dict(
        state,
        resident=state["resident"] | faulted,                  # fault-in
        win_routed=state["win_routed"] + counts.sum(dtype=torch.int32),
        win_promos=state["win_promos"] + torch.where(
            faulted, counts, 0).sum(dtype=torch.int32),
        total_faults=state["total_faults"] + faulted.sum(dtype=torch.int32),
        _hits=hit)                          # the access bits for collect


def collect(cfg: ExpertTieringConfig, state: Dict) -> Tuple[Dict, Dict]:
    """CIW update, MIAD, and demotion of cold expert slabs: (state',
    report)."""
    hits = state.get("_hits")
    if hits is None:
        hits = torch.zeros_like(state["ciw"], dtype=torch.bool)
    ciw = torch.where(hits, 0, torch.clamp(state["ciw"] + 1,
                                           max=cfg.ciw_max))
    rate = state["win_promos"].float() / \
        torch.clamp(state["win_routed"].float(), min=1.0)
    hot = rate > cfg.promotion_target
    ct = torch.where(hot,
                     torch.clamp(state["ct"] * cfg.miad_mult, max=cfg.ct_max),
                     torch.clamp(state["ct"] - cfg.miad_add, min=cfg.ct_min))
    demote = ciw > torch.floor(ct).to(torch.int32)
    resident = state["resident"] & ~demote
    n_resident = resident.sum(dtype=torch.int32)
    report = {
        "promotion_rate": rate,
        "resident_experts": n_resident,
        "hbm_bytes": n_resident.float() * cfg.bytes_per_expert,
        "total_bytes": float(cfg.num_layers * cfg.num_experts *
                             cfg.bytes_per_expert),
        "ct": ct,
    }
    new_state = dict(state, ciw=ciw, resident=resident,
                     ct=ct, win_routed=torch.zeros_like(state["win_routed"]),
                     win_promos=torch.zeros_like(state["win_promos"]))
    new_state.pop("_hits", None)
    return new_state, report
