"""Core layers of the decoder (port of `repro/models/layers.py`): RMSNorm,
the MLP, 2d rotary embeddings, the embedding and the logits head.

Matmul weights keep the JAX layout ([in, out]) and the model dtype;
norm, activation and rotary math run in fp32 and cast back, as in the JAX
package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with a zero-centred scale: the multiplier is (1 + scale)."""
    orig = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(orig)


def mlp(p: dict, x: torch.Tensor, gated: bool) -> torch.Tensor:
    h = x @ p["wi"]
    if gated:
        g = x @ p["wg"]
        h = F.silu(g.float()).to(h.dtype) * h
    else:
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    return h @ p["wo"]


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for a rotary dim (must be even)."""
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate x [..., dim] by per-position angles [..., dim/2]."""
    orig = x.dtype
    x1, x2 = x.float().chunk(2, dim=-1)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(orig)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Standard RoPE. x: [B, S, H, D]; positions: [B, S] int."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * inv
    return _rotate(x, ang[:, :, None, :])


def apply_rope2d(x: torch.Tensor, positions: torch.Tensor,
                 theta: float) -> torch.Tensor:
    """ChatGLM-style partial rotary: rotate the first half of head_dim with
    the position stream, leave the second half unrotated."""
    half = x.shape[-1] // 2
    inv = rope_freqs(half, theta, x.device)
    ang = positions[..., None].float() * inv
    return torch.cat([_rotate(x[..., :half], ang[:, :, None, :]),
                      x[..., half:]], dim=-1)


def positional(cfg, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Dispatch on cfg.rope_style (the port runs rope, rope2d and none)."""
    if cfg.rope_style == "none":
        return x
    if cfg.rope_style == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    if cfg.rope_style == "rope2d":
        return apply_rope2d(x, positions, cfg.rope_theta)
    raise NotImplementedError(f"rope_style {cfg.rope_style!r} is not ported")


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def logits_head(table_out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x: [..., D]; table_out: [D, V] -> [..., V] in fp32."""
    return (x @ table_out).float()
