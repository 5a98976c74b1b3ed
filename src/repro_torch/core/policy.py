"""MIAD feedback control (paper §4, "Adaptive Workload Response"); port of
`repro/core/policy.py`.

The promotion rate — the fraction of window accesses that hit the COLD
heap — drives the demotion threshold C_t with a multiplicative increase /
additive decrease law:

    promo_rate > target  ->  C_t <- min(C_t * mult, C_max)
    promo_rate <= target ->  C_t <- max(C_t - add, C_min)

Proactive demotion unlocks after `calm_required` consecutive calm windows.
C_t stays float32, as in the JAX package, so the thresholds match bit for
bit.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MiadConfig:
    target: float = 0.01      # promotion-rate target (paper: ~1%)
    mult: float = 2.0         # multiplicative increase of C_t
    add: float = 1.0          # additive decrease of C_t
    c_min: float = 1.0
    c_max: float = 16.0
    calm_required: int = 2    # calm windows before PAGEOUT unlocks


def promotion_rate(win_promos, win_accesses) -> torch.Tensor:
    return win_promos.to(torch.float32) / torch.clamp(
        win_accesses.to(torch.float32), min=1.0)


def update(cfg: MiadConfig, ciw_threshold, calm_windows, win_promos,
           win_accesses):
    """One MIAD step. Returns (new_C_t, new_calm_windows, promo_rate,
    proactive_ok)."""
    rate = promotion_rate(win_promos, win_accesses)
    hot = rate > cfg.target
    new_ct = torch.where(hot, torch.clamp(ciw_threshold * cfg.mult,
                                          max=cfg.c_max),
                         torch.clamp(ciw_threshold - cfg.add, min=cfg.c_min))
    calm = torch.where(hot, 0, calm_windows + 1)
    return new_ct, calm, rate, calm >= cfg.calm_required
