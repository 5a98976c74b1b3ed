"""Selective state-space blocks (port of `repro/models/ssm.py`, mamba1
only): init, the causal depthwise conv, the full-sequence forward and the
O(1)-state decode step of falcon-mamba's layers.

The recurrence h_t = a_t * h_{t-1} + b_t runs in the `mamba_scan` kernel,
one call over the whole sequence (`kops.mamba_scan`, looked up on the
module at each call so that a caller can substitute the plain version).
The JAX package runs it as a chunked associative scan (`_m1_scan`) over
the same materialised a and b; the kernel needs no chunks, but `chunk`
keeps its contract (ValueError when S > chunk and S % chunk != 0).

Decode state per layer: {"h": [B, Din, N] fp32, "conv": [B, K-1, Din]}.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops


def _dt_rank(cfg) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def init_mamba1(cfg, dtype, generator: torch.Generator, device) -> dict:
    """Random mamba1 weights at the JAX package's shapes, dtypes and
    scales (the random values differ: torch's generator is not JAX's).
    A_log = log(1..N) per channel and D = 1 are deterministic; A_log is
    computed in float64 on the host and rounded once, so every device
    gets the correctly rounded value."""
    d = cfg.d_model
    din = d * cfg.ssm_expand
    n = cfg.ssm_state_dim
    r = _dt_rank(cfg)

    def nrm(shape, scale):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * scale).to(dtype)
    # softplus^-1 of dt drawn log-uniform in [1e-3, 1e-1]
    u = torch.rand(din, generator=generator, device=device,
                   dtype=torch.float32)
    log_dt = math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3))
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float64)).float()
    return {
        "in_proj": nrm((d, 2 * din), d ** -0.5),
        "conv_w": nrm((cfg.ssm_conv_dim, din), 0.2),
        "conv_b": torch.zeros(din, dtype=dtype, device=device),
        "x_proj": nrm((din, r + 2 * n), din ** -0.5),
        "dt_proj": nrm((r, din), r ** -0.5),
        "dt_bias": torch.log(torch.expm1(torch.exp(log_dt))),
        "A_log": a_log.to(device).expand(din, n).contiguous(),
        "D": torch.ones(din, dtype=torch.float32, device=device),
        "out_proj": nrm((din, d), din ** -0.5),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, C]; w: [K, C]; state: [B, K-1, C] (decode) or None (zero
    history). Returns (y [B, S, C], new_state [B, K-1, C])."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)                     # [B, S+K-1, C]
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i] for i in range(k)) + b
    new_state = xp[:, -(k - 1):] if k > 1 else state
    return y, new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0); torch's softplus turns into the
    # identity above its threshold, so it is not used
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba1_forward(p: dict, x: torch.Tensor, cfg, *, chunk: int = 256,
                   state: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, S, D]; state (decode continuation) or None (from zeros).
    Returns (y [B, S, D], new state {"h" [B, Din, N] fp32, "conv"
    [B, K-1, Din]})."""
    bsz, s, _ = x.shape
    n = cfg.ssm_state_dim
    r = _dt_rank(cfg)
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"seq {s} % chunk {c} != 0")

    xz = x @ p["in_proj"]
    xr, z = xz.chunk(2, dim=-1)                           # [B, S, Din] each
    conv_state = None if state is None else state["conv"]
    xr, new_conv = causal_conv(xr, p["conv_w"], p["conv_b"], conv_state)
    xr = F.silu(xr.float()).to(xz.dtype)
    xr32 = xr.float()

    proj = xr @ p["x_proj"]
    dt, bmat, cmat = proj.split([r, n, n], dim=-1)
    dt = (dt @ p["dt_proj"]).float()
    dt = _softplus(dt + p["dt_bias"])                     # [B, S, Din]
    a = -torch.exp(p["A_log"])                            # [Din, N]
    da = (dt[..., None] * a).exp_()                       # [B, S, Din, N]
    db = (dt * xr32)[..., None] * bmat.float()[:, :, None, :]

    h0 = (torch.zeros((bsz, xr.shape[-1], n), dtype=torch.float32,
                      device=x.device) if state is None else state["h"])
    h_all, h_last = kops.mamba_scan(da, db, h0)
    del da, db  # 8 GiB at falcon-mamba's prefill shape
    y = torch.einsum("bscn,bsn->bsc", h_all, cmat.float())  # [B, S, Din]
    y = y + xr32 * p["D"]
    y = y * F.silu(z.float())
    out = y.to(x.dtype) @ p["out_proj"]
    return out, {"h": h_last, "conv": new_conv}


def mamba1_step(p: dict, x: torch.Tensor, cfg,
                state: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode: x [B, 1, D] -> (y [B, 1, D], new state). O(1) in seq."""
    return mamba1_forward(p, x, cfg, chunk=1, state=state)


def mamba1_init_state(cfg, batch: int, dtype, device
                      ) -> Dict[str, torch.Tensor]:
    din = cfg.d_model * cfg.ssm_expand
    return {
        "h": torch.zeros((batch, din, cfg.ssm_state_dim), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_dim - 1, din), dtype=dtype,
                            device=device),
    }
