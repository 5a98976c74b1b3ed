"""Decode attention pieces the paged-attention plain version is built from
(port of `decode_attention_partial` / `combine_partials` in
`repro/models/attention.py`).

Shapes: q [B, 1, H, D]; k/v [B, S, KV, D] with H % KV == 0 (GQA groups
are expanded inside).
"""
from __future__ import annotations

import torch

NEG_INF = -2.3819763e38  # ~ -bf16 max; the TPU kernels' mask value


def _expand_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KV, D] -> [B, S, KV*n_rep, D] by repeating each kv head."""
    if n_rep == 1:
        return k
    b, s, kv, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, d) \
        .reshape(b, s, kv * n_rep, d)


def decode_attention_partial(q, k_part, v_part, valid_mask):
    """Flash-decoding partial over a shard of the KV sequence. Returns
    (unnormalized out [B,1,H,D] fp32, m [B,H,1], l [B,H,1]);
    valid_mask: [B, S_part] bool."""
    h, d = q.shape[2], q.shape[3]
    kv = k_part.shape[2]
    k = _expand_kv(k_part, h // kv)
    v = _expand_kv(v_part, h // kv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * d ** -0.5
    scores = torch.where(valid_mask[:, None, None, :], scores, NEG_INF)
    m = scores.amax(dim=-1)                       # [B,H,1]
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)                             # [B,H,1]
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out, m, l


def combine_partials(parts):
    """Merge flash-decoding partials [(out, m, l)] -> [B,1,H,D]."""
    m_all = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    tot_l = 0.0
    tot_o = 0.0
    for o, m, l in parts:
        scale = torch.exp(m - m_all)              # [B,H,1]
        tot_l = tot_l + l * scale
        tot_o = tot_o + o * scale.movedim(1, -1)[..., None]
    tot_l = torch.clamp(tot_l, min=1e-30)
    return tot_o / tot_l.movedim(1, -1)[..., None]
