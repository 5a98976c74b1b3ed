"""Core layers of the decoder (port of `repro/models/layers.py`): RMSNorm,
the MLP, rotary embeddings (RoPE, 2d RoPE, M-RoPE), the embedding and the
logits head.

Matmul weights keep the JAX layout ([in, out]) and the model dtype;
norm, activation and rotary math run in fp32 and cast back, as in the JAX
package.
"""
from __future__ import annotations

from typing import Tuple

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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int] = (2, 1, 1)) -> torch.Tensor:
    """Qwen2-VL M-RoPE as the JAX package lays it out: the d/2 frequency
    lanes of `rope_freqs(d, theta)` split into (temporal, height, width)
    sections in the proportions `sections` (the first takes what rounding
    leaves), each rotated by its own position stream, over the whole head.
    x: [B, S, H, D]; positions: [3, B, S] (text tokens use t == h == w)."""
    lanes = x.shape[-1] // 2
    total = sum(sections)
    sizes = [lanes * s // total for s in sections]
    sizes[0] = lanes - sizes[1] - sizes[2]
    inv = rope_freqs(x.shape[-1], theta, x.device).split(sizes)
    pos = positions.float()
    # each section's lanes times its own stream (no index tensor: nothing
    # is copied from the host, so a CUDA graph can hold it)
    ang = torch.cat([pos[i][..., None] * inv[i] for i in range(3)], dim=-1)
    return _rotate(x, ang[:, :, None, :])


def positional(cfg, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Dispatch on cfg.rope_style. positions: [B, S], or [3, B, S] for
    mrope (2-D positions broadcast to t == h == w)."""
    if cfg.rope_style == "none":
        return x
    if cfg.rope_style == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    if cfg.rope_style == "rope2d":
        return apply_rope2d(x, positions, cfg.rope_theta)
    if cfg.rope_style == "mrope":
        if positions.dim() == 2:
            positions = positions[None].expand((3,) + positions.shape)
        return apply_mrope(x, positions, cfg.rope_theta)
    raise ValueError(f"rope_style {cfg.rope_style!r}")


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def logits_head(table_out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x: [..., D]; table_out: [D, V] -> [..., V] in fp32."""
    return (x @ table_out).float()
