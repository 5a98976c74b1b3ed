"""Token sampling inside the decode window (port of
`repro/runtime/sampling.py`).

Per-lane temperature (<= 0 -> greedy argmax) and top-k (<= 0 -> full
vocab), as a Gumbel-max draw over the kept logits. JAX draws its Gumbel
noise from a threefry key, which torch's generator cannot reproduce, so
`sample` takes the noise from a `torch.Generator` or, for tests that replay
the same draws into both packages, as an explicit tensor.
"""
from __future__ import annotations

from typing import Optional

import torch


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise drawn from `generator`."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    e = -torch.log(u.clamp(min=tiny))            # Exp(1)
    return -torch.log(e.clamp(min=tiny))


def sample(logits: torch.Tensor, temperature: torch.Tensor,
           top_k: torch.Tensor, *, generator: Optional[torch.Generator] = None,
           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One sampling step across the batch. logits [B, V]; temperature [B]
    float32; top_k [B] int32; noise [B, V] (drawn from `generator` when not
    given). Returns tok [B] int32."""
    b, v = logits.shape
    lg = logits.float()
    greedy_tok = torch.argmax(lg, -1).to(torch.int32)
    srt = torch.sort(lg, dim=-1, descending=True).values
    kth = torch.gather(srt, 1,
                       torch.clamp(top_k[:, None] - 1, 0, v - 1).long())
    keep = (top_k[:, None] <= 0) | (lg >= kth)
    if noise is None:
        noise = gumbel((b, v), generator, lg.device)
    scored = torch.where(
        keep, lg / torch.clamp(temperature, min=1e-6)[:, None] + noise,
        -torch.inf)
    sampled_tok = torch.argmax(scored, -1).to(torch.int32)
    return torch.where(temperature > 0, sampled_tok, greedy_tok)
