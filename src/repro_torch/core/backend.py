"""Page-level reclamation backends (paper §3.3 / §5.2); port of
`repro/core/backend.py` with all six of its registered backends (`null`,
`proactive`, `reactive`, `cap`, `mglru`, `promote`) and its deprecated
shims (`BackendConfig`, `as_backend`, `step`).

Backends are object-oblivious: their only inputs are per-superblock
summaries (occupancy, referenced bit, region id, tier, evict state) plus
their own carried state. The protocol:

    backend = make(name, **params)          # unknown names rejected HERE
    bstate  = backend.init(geom)            # dict of tensors (may be {})
    bstate, tier, evict, telemetry = backend.step(
        geom, bstate, stats, tier, evict, signals)

`geom` exposes `.n_sbs` and `.sb_bytes` (`pool.PoolConfig` or
`PageGeometry`); `signals` holds `proactive_ok` (the MIAD calm gate) and
`epoch`; `telemetry` has the fixed keys `TELEMETRY_KEYS`. Every step is
fixed-shape and reads no device value on the host, so it runs inside a
captured serve window; `bstate` rides the window's carry.
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


def _promote(tier, evict, chosen):
    return (torch.where(chosen, pl.HBM, tier),
            torch.where(chosen, pl.NORMAL, evict))


def _telemetry(demoted=None, promoted=None) -> Dict[str, torch.Tensor]:
    t = zero_telemetry((demoted if demoted is not None else promoted).device)
    if demoted is not None:
        t["be_demoted"] = demoted.sum(dtype=_I32)
    if promoted is not None:
        t["be_promoted"] = promoted.sum(dtype=_I32)
    return t


def _pressure_k(resident, target_sbs: int) -> torch.Tensor:
    """Superblocks to demote: resident ones over the target, at least 0."""
    return torch.clamp(resident.sum(dtype=_I32) - target_sbs, min=0)


def _kswapd_prio(resident, evict, referenced) -> torch.Tensor:
    """Victim priority: MADV_COLD candidates (3) > unreferenced (2) >
    referenced (1); not resident 0 (excluded)."""
    return torch.where(
        resident,
        torch.where(evict == pl.CANDIDATE, 3,
                    torch.where(~referenced, 2, 1)),
        0).to(_I32)


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
        return bstate, tier, evict, _telemetry(demoted=do)


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
        k = _pressure_k(
            resident, self._target_sbs(geom, self.hbm_target_bytes))
        prio = _kswapd_prio(resident, evict, stats["referenced"])
        chosen = _take_k(prio, k, min_prio=0 if self.evict_referenced else 1)
        tier, evict = _demote(tier, evict, chosen)
        return bstate, tier, evict, _telemetry(demoted=chosen)


@register("cap")
@dataclasses.dataclass(frozen=True)
class CapBackend(Backend):
    """cgroup cap: page-granular and hotness-blind; evicts resident
    superblocks in forward address order (priority n - index), referenced
    or not."""
    hbm_target_bytes: int = 0

    def step(self, geom, bstate, stats, tier, evict, signals):
        resident = self._resident(stats, tier)
        k = _pressure_k(
            resident, self._target_sbs(geom, self.hbm_target_bytes))
        n = tier.shape[0]
        prio = torch.where(resident, n - torch.arange(
            n, dtype=_I32, device=tier.device), 0).to(_I32)
        chosen = _take_k(prio, k)
        tier, evict = _demote(tier, evict, chosen)
        return bstate, tier, evict, _telemetry(demoted=chosen)


@register("mglru")
@dataclasses.dataclass(frozen=True)
class MglruBackend(Backend):
    """Multi-generational LRU. Carried state: `gen` [n_sbs] int32.
    Referenced resident superblocks join generation 0, idle resident ones
    age by one (saturating at `max_gen`), others keep theirs. Under
    pressure victims come from the oldest generation first; generations
    below `min_evict_gen` are protected (priority gen + 1, so gen 0 stays
    selectable when min_evict_gen is 0)."""
    hbm_target_bytes: int = 0
    max_gen: int = 3
    min_evict_gen: int = 1

    def init(self, geom, device=None):
        return {"gen": torch.zeros(geom.n_sbs, dtype=_I32, device=device)}

    def step(self, geom, bstate, stats, tier, evict, signals):
        resident = self._resident(stats, tier)
        g = bstate["gen"]
        gen = torch.where(
            resident & stats["referenced"], 0,
            torch.where(resident, torch.clamp(g + 1, max=self.max_gen),
                        g)).to(_I32)
        k = _pressure_k(
            resident, self._target_sbs(geom, self.hbm_target_bytes))
        prio = torch.where(resident & (gen >= self.min_evict_gen), gen + 1,
                           0).to(_I32)
        chosen = _take_k(prio, k)
        tier, evict = _demote(tier, evict, chosen)
        return {"gen": gen}, tier, evict, _telemetry(demoted=chosen)


@register("promote")
@dataclasses.dataclass(frozen=True)
class PromoteBackend(Backend):
    """Watermark promotion (TPP / AutoNUMA-like). Carried state:
    `host_refs` [n_sbs] int32, the streak of consecutive windows a HOST
    superblock was referenced, and `active` [] bool, the hysteresis flag.

    HOST superblocks referenced for >= `promote_after` windows return to
    HBM, longest streak first, never past the high watermark; promotion
    latches off once the residency a step leaves touches the high
    watermark and re-arms when residency dips to the low one. Above the
    high watermark, superblocks are demoted kswapd-style down to the LOW
    watermark. `hbm_high_bytes=0` means no cap (the whole pool);
    `hbm_low_bytes=0` collapses the band (low = high)."""
    hbm_high_bytes: int = 0
    hbm_low_bytes: int = 0
    promote_after: int = 2

    def _watermarks(self, geom) -> Tuple[int, int]:
        high = self._target_sbs(geom, self.hbm_high_bytes) \
            if self.hbm_high_bytes > 0 else geom.n_sbs
        low = self._target_sbs(geom, self.hbm_low_bytes) \
            if self.hbm_low_bytes > 0 else high
        return high, min(low, high)

    def init(self, geom, device=None):
        return {"host_refs": torch.zeros(geom.n_sbs, dtype=_I32,
                                         device=device),
                "active": torch.ones((), dtype=torch.bool, device=device)}

    def step(self, geom, bstate, stats, tier, evict, signals):
        high, low = self._watermarks(geom)
        occupied = stats["occupancy"] > 0
        ref = stats["referenced"]
        host_res = occupied & (tier == pl.HOST)
        n_res = (occupied & (tier == pl.HBM)).sum(dtype=_I32)

        # referenced-on-HOST streaks (reset on idle, fault-in or promote)
        refs = torch.where(host_res & ref, bstate["host_refs"] + 1,
                           0).to(_I32)
        # held from the previous window, or re-armed at the low watermark
        armed = bstate["active"] | (n_res <= low)

        # promote the hottest qualifying HOST superblocks, never past high
        k_up = torch.where(armed, torch.clamp(high - n_res, min=0), 0)
        up = _take_k(torch.where(host_res & (refs >= self.promote_after),
                                 refs, 0), k_up)
        tier, evict = _promote(tier, evict, up)
        refs = torch.where(up, 0, refs)

        # above high: reclaim down to LOW with kswapd's priorities
        resident = occupied & (tier == pl.HBM)
        n_res2 = resident.sum(dtype=_I32)
        k_down = torch.where(n_res2 > high, n_res2 - low, 0)
        down = _take_k(_kswapd_prio(resident, evict, ref), k_down)
        tier, evict = _demote(tier, evict, down)

        # latch off once the residency left behind touches high
        r_final = (occupied & (tier == pl.HBM)).sum(dtype=_I32)
        active = armed & (r_final < high)
        return ({"host_refs": refs, "active": active}, tier, evict,
                _telemetry(demoted=down, promoted=up))


def pressure_params(name: str, target_bytes: int) -> Dict[str, int]:
    """Map a generic pressure target onto the pressure field the registered
    backend declares (reactive, cap, mglru: hbm_target_bytes; promote:
    hbm_high_bytes; none for null and proactive)."""
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


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """Deprecated string-keyed config (use `make(name, **params)`); `kind`
    is checked against the registry at construction."""
    kind: str = "reactive"
    hbm_target_bytes: int = 0

    def __post_init__(self):
        if self.kind not in _REGISTRY:
            raise ValueError(
                f"unknown backend kind {self.kind!r}; "
                f"registered: {list(names())}")

    def build(self) -> Backend:
        """The registry backend, its pressure target set by
        `pressure_params`."""
        return make(self.kind,
                    **pressure_params(self.kind, self.hbm_target_bytes))


def as_backend(obj) -> Backend:
    """A Backend, BackendConfig or registered name as a Backend."""
    if isinstance(obj, Backend):
        return obj
    if isinstance(obj, BackendConfig):
        return obj.build()
    if isinstance(obj, str):
        return make(obj)
    raise TypeError(f"not a backend: {obj!r}")


def step(cfg, pool_cfg, stats: Dict[str, torch.Tensor], tier: torch.Tensor,
         evict: torch.Tensor, proactive_ok: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deprecated stateless entry point: one protocol step from fresh
    backend state at epoch 0; the carried state and telemetry are
    dropped."""
    b = as_backend(cfg)
    dev = tier.device
    _, tier, evict, _ = b.step(
        pool_cfg, b.init(pool_cfg, dev), stats, tier, evict,
        {"proactive_ok": proactive_ok,
         "epoch": torch.zeros((), dtype=_I32, device=dev)})
    return tier, evict
