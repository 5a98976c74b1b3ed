"""The dense decoder's layer math (port of `init_attn_layer`, `_qkv`,
`decode_layer_step` and the dense branch of `init_lm` in
`repro/models/transformer.py`).

Parameters are a plain dict: {"embed" [V, D], "final_ln" [D], "out" [D, V]
(absent with tied embeddings), "layers": [one dict per layer]}. The JAX
package stacks the layer dicts on a leading [L] axis; the port keeps a
list, since its layers run as a Python loop (`convert.py` unstacks).
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.models import layers as L


def _normal(shape, scale: float, dtype, generator, device) -> torch.Tensor:
    return (torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32) * scale).to(dtype)


def init_attn_layer(cfg, dtype, generator, device) -> dict:
    if cfg.num_experts:
        raise NotImplementedError("MoE layers are not ported yet")
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    s = d ** -0.5

    def nrm(shape, scale):
        return _normal(shape, scale, dtype, generator, device)
    ffn = {"wi": nrm((d, cfg.d_ff), s),
           "wo": nrm((cfg.d_ff, d), cfg.d_ff ** -0.5)}
    if cfg.mlp_gated:
        ffn["wg"] = nrm((d, cfg.d_ff), s)
    return {
        "ln1": torch.zeros(d, dtype=torch.float32, device=device),
        "ln2": torch.zeros(d, dtype=torch.float32, device=device),
        "wq": nrm((d, nq), s), "wk": nrm((d, nkv), s),
        "wv": nrm((d, nkv), s), "wo": nrm((nq, d), nq ** -0.5),
        "ffn": ffn,
    }


def init_lm(cfg, generator: torch.Generator, device) -> dict:
    """Random weights for a dense decoder, at the JAX package's shapes and
    scales (the values differ: torch's generator is not JAX's)."""
    if cfg.family != "dense" or cfg.block_pattern or cfg.is_encoder_decoder:
        raise NotImplementedError(f"family {cfg.family!r} is not ported")
    dtype = getattr(torch, cfg.dtype)
    params = {
        "embed": _normal((cfg.vocab_size, cfg.d_model), 0.02, dtype,
                         generator, device),
        "final_ln": torch.zeros(cfg.d_model, dtype=torch.float32,
                                device=device),
    }
    if not cfg.tie_embeddings:
        params["out"] = _normal((cfg.vocab_size, cfg.d_model), 0.02, dtype,
                                generator, device).T.contiguous()
    layers: List[dict] = [init_attn_layer(cfg, dtype, generator, device)
                          for _ in range(cfg.num_layers)]
    params["layers"] = layers
    return params


def _qkv(p, x, cfg, positions):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = (x @ p["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
    return L.positional(cfg, q, positions), L.positional(cfg, k, positions), v


def decode_layer_step(p: dict, x: torch.Tensor, cfg, positions, attend_fn):
    """One decoder layer of single-token decode, with the KV mechanics
    supplied by the caller. x: [B,1,D]; positions: [B,1];
    attend_fn(q, k, v) -> (attention out reshapeable to [B,1,H*Dh], aux)
    with q [B,1,H,Dh] and k/v [B,1,KV,Dh]. Returns (x', aux)."""
    b = x.shape[0]
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(p, h, cfg, positions)
    o, aux = attend_fn(q, k, v)
    x = x + o.reshape(b, 1, -1) @ p["wo"]
    h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + L.mlp(p["ffn"], h2, cfg.mlp_gated), aux
