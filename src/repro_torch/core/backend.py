"""Page-level reclamation backends (paper §3.3 / §5.2); port of
`repro/core/backend.py` with the `null`, `proactive` and `reactive`
backends.

Backends are object-oblivious: their only inputs are per-superblock
summaries (occupancy, referenced bit, region id, tier, evict state) plus
their own carried state. The protocol:

    backend = make(name, **params)          # unknown names rejected HERE
    bstate  = backend.init(geom)            # dict of tensors (may be {})
    bstate, tier, evict, telemetry = backend.step(
        geom, bstate, stats, tier, evict, signals)

`geom` exposes `.n_sbs` and `.sb_bytes` (`pool.PoolConfig` or
`PageGeometry`); `signals` holds `proactive_ok` (the MIAD calm gate) and
`epoch`; `telemetry` has the fixed keys `TELEMETRY_KEYS`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core import pool as pl

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class PageGeometry:
    """The only configuration a backend may read."""
    n_sbs: int
    sb_bytes: int


TELEMETRY_KEYS = ("be_demoted", "be_promoted")


def zero_telemetry(device=None) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), dtype=_I32, device=device)
            for k in TELEMETRY_KEYS}


_REGISTRY: Dict[str, type] = {}


def register(name: str):
    """Class decorator: register a Backend under `name`."""
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make(name: str, **params) -> "Backend":
    """Construct a backend by registered name; unknown names and params are
    rejected here, at construction time."""
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown backend {name!r}; registered: {list(names())}")
    return _REGISTRY[name](**params)


@dataclasses.dataclass(frozen=True)
class Backend:
    """Base of the backend protocol; subclasses override `step` (and `init`
    when they carry state)."""

    def init(self, geom, device=None) -> Dict[str, torch.Tensor]:
        return {}

    def step(self, geom, bstate, stats, tier, evict, signals):
        raise NotImplementedError

    def _resident(self, stats, tier) -> torch.Tensor:
        return (stats["occupancy"] > 0) & (tier == pl.HBM)

    def _target_sbs(self, geom, target_bytes: int) -> int:
        return max(target_bytes, 0) // geom.sb_bytes


def _take_k(victim_priority: torch.Tensor, k: torch.Tensor,
            min_prio: int = 0) -> torch.Tensor:
    """Boolean mask of the `k` highest-priority entries with priority >
    `min_prio`; a full STABLE sort, ties broken by index order (as
    `jnp.argsort`, which is stable by default)."""
    n = victim_priority.shape[0]
    order = torch.argsort(-victim_priority, stable=True)
    take = (torch.arange(n, device=order.device) < k) & \
        (victim_priority[order] > min_prio)
    out = torch.zeros(n, dtype=torch.bool, device=order.device)
    out[order] = take
    return out


def _demote(tier, evict, chosen):
    return (torch.where(chosen, pl.HOST, tier),
            torch.where(chosen, pl.PAGED_OUT, evict))


def _telemetry(demoted) -> Dict[str, torch.Tensor]:
    t = zero_telemetry(demoted.device)
    t["be_demoted"] = demoted.sum(dtype=_I32)
    return t


@register("null")
@dataclasses.dataclass(frozen=True)
class NullBackend(Backend):
    """Performance-first baseline: never reclaims."""

    def step(self, geom, bstate, stats, tier, evict, signals):
        return bstate, tier, evict, zero_telemetry(tier.device)


@register("proactive")
@dataclasses.dataclass(frozen=True)
class ProactiveBackend(Backend):
    """MADV_PAGEOUT analog: demote every MADV_COLD candidate once MIAD says
    it is safe (`signals["proactive_ok"]`)."""

    def step(self, geom, bstate, stats, tier, evict, signals):
        do = self._resident(stats, tier) & (evict == pl.CANDIDATE) \
            & signals["proactive_ok"]
        tier, evict = _demote(tier, evict, do)
        return bstate, tier, evict, _telemetry(do)


@register("reactive")
@dataclasses.dataclass(frozen=True)
class ReactiveBackend(Backend):
    """kswapd analog. Victim priority under pressure: MADV_COLD candidates
    (3) > unreferenced (2) > referenced (1); empty or host-resident
    excluded. `evict_referenced=False` never demotes referenced ones."""
    hbm_target_bytes: int = 0
    evict_referenced: bool = True

    def step(self, geom, bstate, stats, tier, evict, signals):
        resident = self._resident(stats, tier)
        k = torch.clamp(resident.sum(dtype=_I32)
                        - self._target_sbs(geom, self.hbm_target_bytes),
                        min=0)
        prio = torch.where(
            resident,
            torch.where(evict == pl.CANDIDATE, 3,
                        torch.where(~stats["referenced"], 2, 1)),
            0).to(_I32)
        chosen = _take_k(prio, k, min_prio=0 if self.evict_referenced else 1)
        tier, evict = _demote(tier, evict, chosen)
        return bstate, tier, evict, _telemetry(chosen)


def pressure_params(name: str, target_bytes: int) -> Dict[str, int]:
    """Map a generic pressure target onto the pressure field the registered
    backend declares (reactive: hbm_target_bytes; none for null and
    proactive)."""
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown backend {name!r}; registered: {list(names())}")
    if not target_bytes:
        return {}
    fields = {f.name for f in dataclasses.fields(_REGISTRY[name])}
    for field in ("hbm_target_bytes", "hbm_high_bytes"):
        if field in fields:
            return {field: target_bytes}
    return {}
