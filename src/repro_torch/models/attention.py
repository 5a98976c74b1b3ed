"""Attention (port of `repro/models/attention.py`): full (the oracle),
blockwise (online softmax over KV chunks, never materialising [Sq, Sk]),
decode (one query token against a KV cache), the flash-decoding
partials the paged-attention plain version is built from, and cross
attention over an encoder's memory.

Shapes: q [B, S, H, D]; k/v [B, S_kv, KV, D] with H % KV == 0 (GQA groups
are expanded inside).

Called with DTensors, the full-sequence and cross attention run on each
rank's batch and head shard (`models/spmd.py`).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.models import spmd

NEG_INF = -2.3819763e38  # ~ -bf16 max; the TPU kernels' mask value


def _expand_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, KV, D] -> [B, S, KV*n_rep, D] by repeating each kv head."""
    if n_rep == 1:
        return k
    b, s, kv, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, d) \
        .reshape(b, s, kv * n_rep, d)


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """Additive mask bias [.., Sq, Sk] (fp32) from absolute positions."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    m = torch.ones(q_pos.shape[:-1] + (q_pos.shape[-1], k_pos.shape[-1]),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & (kp > qp - window)
    return torch.where(m, 0.0, NEG_INF)


def _positions(pos: Optional[torch.Tensor], b: int, s: int,
               device) -> torch.Tensor:
    if pos is not None:
        return pos
    return torch.arange(s, device=device)[None].expand(b, s)


@spmd.wrap
def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   q_pos: Optional[torch.Tensor] = None,
                   k_pos: Optional[torch.Tensor] = None,
                   softcap: float = 0.0) -> torch.Tensor:
    """Materialises the scores (tiny shapes only). The product runs in the
    inputs' dtype, the softmax in fp32, and the probabilities are cast to
    v's dtype for the second product, as in the JAX package."""
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    k = _expand_kv(k, h // kv)
    v = _expand_kv(v, h // kv)
    q_pos = _positions(q_pos, b, sq, q.device)
    k_pos = _positions(k_pos, b, sk, q.device)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * d ** -0.5
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    scores = scores + _mask_bias(q_pos, k_pos, causal, window)[:, None]
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


@spmd.wrap
def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        chunk: int = 512,
                        q_pos: Optional[torch.Tensor] = None,
                        k_pos: Optional[torch.Tensor] = None,
                        softcap: float = 0.0) -> torch.Tensor:
    """Online softmax over KV chunks of `chunk` keys, in fp32, keeping the
    running (max, denominator, weighted sum): live memory O(Sq * chunk).
    A key length that is not a multiple of the chunk is padded, the pad
    keys at position 2**30 (masked by causality)."""
    b, sq, h, d = q.shape
    _, sk, kv, _ = k.shape
    n_rep = h // kv
    if sk % chunk != 0:
        pad = chunk - sk % chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(_positions(k_pos, b, sk, q.device),
                                        (0, pad), value=2 ** 30)
        sk += pad
    q_pos = _positions(q_pos, b, sq, q.device)
    k_pos = _positions(k_pos, b, sk, q.device)
    qf = q.float() * d ** -0.5
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    for c0 in range(0, sk, chunk):
        kb = _expand_kv(k[:, c0:c0 + chunk], n_rep).float()
        vb = _expand_kv(v[:, c0:c0 + chunk], n_rep).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        s = s + _mask_bias(q_pos, k_pos[:, c0:c0 + chunk], causal,
                           window)[:, None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1)
        acc = acc * scale.movedim(1, -1)[..., None] + \
            torch.einsum("bhqk,bkhd->bqhd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30).movedim(1, -1)[..., None]
    return out.to(q.dtype)


def write_cache(cache: dict, slot: int, k: torch.Tensor, v: torch.Tensor,
                pos: int) -> None:
    """One token's k / v [B, 1, KV, D] and its position into slot `slot`
    of a layer's cache {"k", "v": [B, C, KV, D], "k_pos": [B, C]}, in
    place."""
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cache["k_pos"][:, slot] = pos


def decode_mask(s: int, cache_len: Union[int, torch.Tensor], *,
                window: int = 0, k_pos: Optional[torch.Tensor] = None,
                q_pos: Union[int, torch.Tensor, None] = None,
                device=None, first: int = 0) -> torch.Tensor:
    """[B or 1, s] bool: the cache slots first .. first + s - 1 that a
    decode query attends to: below cache_len (scalar or [B]) and, with a
    window, by absolute positions (k_pos [B, s] of those slots, else the
    slot index; q_pos, else cache_len - 1)."""
    idx = first + torch.arange(s, device=device)[None]        # [1, s]
    clen = torch.as_tensor(cache_len, device=device).reshape(-1, 1)
    valid = idx < clen
    if window > 0:
        qp = clen - 1 if q_pos is None else \
            torch.as_tensor(q_pos, device=device).reshape(-1, 1)
        kp = idx if k_pos is None else k_pos
        valid = valid & (kp > qp - window)
    return valid


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: Union[int, torch.Tensor], *, window: int = 0,
                     k_pos: Optional[torch.Tensor] = None,
                     q_pos: Union[int, torch.Tensor, None] = None
                     ) -> torch.Tensor:
    """q: [B, 1, H, D]; caches: [B, S, KV, D]; cache_len: scalar or [B]
    number of valid entries. Masked softmax over the cache in fp32, one
    pass. Window masking uses absolute positions when k_pos is given
    (ring-buffer caches)."""
    _, _, h, d = q.shape
    _, s, kv, _ = k_cache.shape
    k = _expand_kv(k_cache, h // kv)
    v = _expand_kv(v_cache, h // kv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * d ** -0.5
    valid = decode_mask(s, cache_len, window=window, k_pos=k_pos,
                        q_pos=q_pos, device=q.device)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


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


def rescale_partial(out, m, l, m_all):
    """A flash-decoding partial (out, m, l) brought to the common max
    m_all [B,H,1]: (out, l) scaled by exp(m - m_all)."""
    scale = torch.exp(m - m_all)                  # [B,H,1]
    return out * scale.movedim(1, -1)[..., None], l * scale


def normalise_partials(out, l):
    """The summed rescaled partials' out over their summed l."""
    return out / torch.clamp(l, min=1e-30).movedim(1, -1)[..., None]


def combine_partials(parts):
    """Merge flash-decoding partials [(out, m, l)] -> [B,1,H,D]."""
    m_all = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    tot_l = 0.0
    tot_o = 0.0
    for o, m, l in parts:
        o, l = rescale_partial(o, m, l, m_all)
        tot_l = tot_l + l
        tot_o = tot_o + o
    return normalise_partials(tot_o, tot_l)


@spmd.wrap
def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    enc_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [B, Sq, H, D] over encoder memory k/v: [B, Se, KV, D], no
    causal mask; enc_mask [B, Se] bool (True: attend) fills NEG_INF where
    it is False. Scores and softmax in fp32, the probabilities cast to
    v's dtype for the second product, as in the JAX package (which runs
    this outside any kernel)."""
    h, d = q.shape[2], q.shape[3]
    k = _expand_kv(k, h // k.shape[2])
    v = _expand_kv(v, h // v.shape[2])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * d ** -0.5
    if enc_mask is not None:
        scores = torch.where(enc_mask[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
