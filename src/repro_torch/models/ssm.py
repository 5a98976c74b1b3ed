"""Selective state-space blocks (port of `repro/models/ssm.py`): mamba1
(falcon-mamba) and mamba2 / SSD (zamba2): init, the causal depthwise conv,
the full-sequence forward and the O(1)-state decode step.

The recurrences run in the `mamba_scan` kernel (`kops.mamba_scan`, looked
up on the module at each call so that a caller can substitute the plain
version):
  * mamba1: h_t = a_t * h_{t-1} + b_t, one call over the whole sequence.
    The JAX package runs it as a chunked associative scan (`_m1_scan`)
    over the same materialised a and b; the kernel needs no chunks, but
    `chunk` keeps its contract (ValueError when S > chunk and S % chunk
    != 0).
  * mamba2 (SSD): the block decomposition into intra-chunk products and
    an inter-chunk state carry, h_z = exp(sum of the chunk's dt * A) *
    h_{z-1} + S_z, which the kernel runs over the chunks, one lane per
    (state, head, head channel): the JAX package's `lax.scan` body.

Decode state per layer: mamba1 {"h": [B, Din, N] fp32, "conv": [B, K-1,
Din]}; mamba2 {"h": [B, N, nh, 64] fp32, "conv": [B, K-1, Din + 2N]}.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models import spmd

MAMBA2_HEADDIM = 64


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


def init_mamba2(cfg, dtype, generator: torch.Generator, device) -> dict:
    """Random mamba2 weights at the JAX package's shapes, dtypes and scales
    (the random values differ: torch's generator is not JAX's). A_log is
    log U(1, 16) and dt_bias the inverse softplus of a dt drawn log-uniform
    in [1e-3, 1e-1], one per head; D = 1 and the norm's zero-centred scale
    are deterministic."""
    d = cfg.d_model
    din = d * cfg.ssm_expand
    n = cfg.ssm_state_dim
    nh = din // MAMBA2_HEADDIM
    conv_dim = din + 2 * n                # the conv runs over (x, B, C)

    def nrm(shape, scale):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    def uniform(lo, hi):
        return lo + torch.rand(nh, generator=generator, device=device,
                               dtype=torch.float32) * (hi - lo)
    log_dt = uniform(math.log(1e-3), math.log(1e-1))
    return {
        "in_proj": nrm((d, 2 * din + 2 * n + nh), d ** -0.5),
        "conv_w": nrm((cfg.ssm_conv_dim, conv_dim), 0.2),
        "conv_b": torch.zeros(conv_dim, dtype=dtype, device=device),
        "A_log": torch.log(uniform(1.0, 16.0)),
        "D": torch.ones(nh, dtype=torch.float32, device=device),
        "dt_bias": torch.log(torch.expm1(torch.exp(log_dt))),
        "norm": torch.zeros(din, dtype=torch.float32, device=device),
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

    # on DTensors the projection's gradient keeps its layout (its width
    # over "model"): without it the backward runs the block on the whole
    # batch on every data rank (the dry run's MODEL/HLO 0.23 for 0.81)
    xz = spmd.pin_grad(x @ p["in_proj"])
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
    h_all, h_last = spmd.scan(kops.mamba_scan, da, db, h0)
    del da, db  # 8 GiB at falcon-mamba's prefill shape
    y = torch.einsum("bscn,bsn->bsc", h_all, cmat.float())  # [B, S, Din]
    y = y + xr32 * p["D"]
    y = y * F.silu(z.float())
    # and so does out_proj's input (else the scan's inputs' gradients are
    # reduce-scattered over "model" at the whole batch: 42 GB a layer)
    out = spmd.pin_grad(y.to(x.dtype)) @ p["out_proj"]
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


def mamba2_forward(p: dict, x: torch.Tensor, cfg, *, chunk: int = 128,
                   state: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """SSD block decomposition. x: [B, S, D]; state (decode continuation)
    or None (from zeros). Returns (y [B, S, D], new state {"h" [B, N, nh,
    64] fp32, "conv" [B, K-1, Din + 2N]}). S must be <= chunk or a
    multiple of it (ValueError otherwise), as in JAX.

    Per chunk of L = min(chunk, S) steps: the intra-chunk outputs through
    the [L, L] decay mask, each chunk's final state S_z from zero, and the
    carry h_z = exp(sum of the chunk's dt * A) h_{z-1} + S_z across the
    NC chunks in `kops.mamba_scan` (a [B, NC, N, nh * 64], b = S_z, h0 the
    state's h); each chunk then reads the carry it starts from."""
    bsz, s, d = x.shape
    din = d * cfg.ssm_expand
    n = cfg.ssm_state_dim
    ph = MAMBA2_HEADDIM
    nh = din // ph
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"seq {s} % chunk {c} != 0")

    # on DTensors the projection's gradient keeps its layout (its width
    # over "model"), so the weight's gradient is a sharded product
    zxbcdt = spmd.pin_grad(x @ p["in_proj"])
    z, xbc, dt = zxbcdt.split([din, din + 2 * n, nh], dim=-1)
    conv_state = None if state is None else state["conv"]
    xbc, new_conv = causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = F.silu(xbc.float()).to(zxbcdt.dtype)
    xr, bmat, cmat = xbc.split([din, n, n], dim=-1)

    dt = _softplus(dt.float() + p["dt_bias"])             # [B, S, H]
    a = -torch.exp(p["A_log"])                            # [H]
    xh = xr.reshape(bsz, s, nh, ph)
    h0 = (torch.zeros((bsz, n, nh * ph), dtype=torch.float32,
                      device=x.device) if state is None
          else state["h"].reshape(bsz, n, nh * ph))
    # every head and every sequence on its own: on DTensors, each rank's
    # batch and head shard (bmat / cmat are shared by the heads)
    y, h_last = spmd.batch_heads(
        functools.partial(_ssd, chunk=c), nh,
        (xh, 0, 2), (dt, 0, 2), (bmat, 0, None), (cmat, 0, None),
        (a, None, 0), (p["D"], None, 0), (h0, 0, 2),
        out=((0, 2), (0, 2)))
    # the gated norm's inputs and output keep their layouts in the
    # backward too (`spmd.pin_grad`; plain tensors pass)
    y = spmd.pin_grad(y.reshape(bsz, s, din))
    # gated RMSNorm (mamba2's norm before out_proj)
    y = y * F.silu(spmd.pin_grad(z).float())
    y = y * torch.rsqrt(y.square().mean(dim=-1, keepdim=True) + 1e-5) \
        * (1.0 + p["norm"])
    out = spmd.pin_grad(y.to(x.dtype)) @ p["out_proj"]
    return out, {"h": h_last.reshape(bsz, n, nh, ph), "conv": new_conv}


def _ssd(xh: torch.Tensor, dt: torch.Tensor, bmat: torch.Tensor,
         cmat: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
         h0: torch.Tensor, *, chunk: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD core of `mamba2_forward` on xh [B, S, H, P], dt [B, S, H]
    fp32, B and C [B, S, N], a and D [H], h0 [B, N, H * P] fp32: (y [B, S,
    H, P] fp32 with the D skip, h_last [B, N, H * P] fp32)."""
    bsz, s, nh, ph = xh.shape
    n = bmat.shape[-1]
    c = chunk
    nc = s // c
    dtc = dt.reshape(bsz, nc, c, nh)
    xc = xh.reshape(bsz, nc, c, nh, ph).float()
    bc = bmat.float().reshape(bsz, nc, c, n)
    cc = cmat.float().reshape(bsz, nc, c, n)

    da = dtc * a                                          # [B, NC, L, H]
    cum = torch.cumsum(da, dim=2)                         # within a chunk
    dtx = dtc[..., None] * xc                             # [B, NC, L, H, P]
    # y_intra[l] = sum_{m <= l} (C_l . B_m) exp(cum_l - cum_m) dt_m x_m.
    # The mask goes on the exponent (-inf above the diagonal, where
    # cum_l - cum_m > 0 can overflow exp), not on exp's output as in the
    # JAX package: the same values, but a gradient that stays finite
    # where JAX's is inf * 0 = nan
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=xh.device))
    seg = torch.exp(torch.where(causal[None, None, :, :, None],
                                cum[:, :, :, None, :] - cum[:, :, None, :, :],
                                -math.inf))
    cb = torch.einsum("bzln,bzmn->bzlm", cc, bc)          # [B, NC, L, L]
    seg = seg * cb[..., None]                             # [B, NC, L, L, H]
    del cb
    y_intra = torch.einsum("bzlmh,bzmhp->bzlhp", seg, dtx)
    del seg  # 335 MB at zamba2's prefill shape

    # chunk-final states from zero: S_z = sum_m exp(cum_last - cum_m)
    # dt_m B_m x_m, [B, NC, N, H, P]
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)     # [B, NC, L, H]
    sstate = torch.einsum("bzmn,bzmhp->bznhp", bc,
                          decay_to_end[..., None] * dtx)
    del dtx, decay_to_end
    # the carry across chunks, one lane per (n, h, p)
    chunk_decay = torch.exp(da.sum(dim=2))                # [B, NC, H]
    a_c = chunk_decay[:, :, None, :, None].expand(bsz, nc, n, nh, ph) \
        .reshape(bsz, nc, n, nh * ph).contiguous()
    h_all, h_last = kops.mamba_scan(
        a_c, sstate.reshape(bsz, nc, n, nh * ph).contiguous(), h0)
    del a_c, sstate
    h_prevs = torch.cat([h0[:, None], h_all[:, :-1]], dim=1) \
        .reshape(bsz, nc, n, nh, ph)                      # each chunk's start
    del h_all

    y_inter = torch.einsum("bzln,bznhp->bzlhp", cc, h_prevs)
    y = y_intra + y_inter * torch.exp(cum)[..., None]
    del y_intra, y_inter, h_prevs
    y = y.reshape(bsz, s, nh, ph) + xh.float() * d_skip[:, None]
    return y, h_last


def mamba2_step(p: dict, x: torch.Tensor, cfg,
                state: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode: x [B, 1, D] -> (y [B, 1, D], new state). O(1) in seq."""
    return mamba2_forward(p, x, cfg, chunk=1, state=state)


def mamba2_init_state(cfg, batch: int, dtype, device
                      ) -> Dict[str, torch.Tensor]:
    din = cfg.d_model * cfg.ssm_expand
    n = cfg.ssm_state_dim
    return {
        "h": torch.zeros((batch, n, din // MAMBA2_HEADDIM, MAMBA2_HEADDIM),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_dim - 1, din + 2 * n),
                            dtype=dtype, device=device),
    }
