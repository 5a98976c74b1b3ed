"""Model composition (port of `repro/models/transformer.py`): init, the
full-sequence forward and loss (`attn_ffn_block`, `lm_forward`,
`lm_loss`), and single-token decode (`init_decode_state`,
`lm_decode_step`) over a dense ring cache (`decode_layer_step`,
`attn_block_decode`) or, for the ssm family (falcon-mamba: mamba1 layers,
`models/ssm.py`), an O(1) recurrent state. The hybrid family (zamba2) runs
G groups, each of `every - 1` mamba2 blocks followed by the one shared
attention block (`_hybrid_shape`): an O(1) state per mamba2 block and a
ring cache per occurrence of the shared block. The encoder-decoder
(seamless-m4t) runs a non-causal encoder over precomputed frame
embeddings (`encoder_forward`) and gives every decoder layer cross
attention over its output (`_enc_kv`, recomputed at every decode step, as
in JAX); the VLM (qwen2-vl) prepends precomputed patch embeddings to the
token stream (`extra_embeds`) under M-RoPE positions.

Parameters are a plain dict: {"embed" [V, D], "final_ln" [D], "out" [D, V]
(absent with tied embeddings), "layers": [one dict per layer]}; an
attention layer holds attention weights and "ffn" (dense) or "moe"
(`models/moe.py`), an ssm layer {"ln", "m"}. An encoder-decoder model
adds "enc_layers" (attention layers) and "enc_ln", and its decoder layers
hold the cross-attention weights "ln_x", "xq", "xk", "xv", "xo". A
hybrid model has no "layers" but "mamba": [G lists of `every - 1`
{"ln", "m"} dicts] and "shared_attn": one attention layer, used at every
occurrence. The JAX
package stacks the layer dicts on leading axes ([L], or [G, per]); the
port keeps lists, since its layers run as a Python loop (`convert.py`
unstacks).

The same code runs sharded on DTensor params, inputs and states laid
out by `launch/shardings.py` (under `implicit_replication()`): each
layer's weights enter its body through `spmd.gather_weights` (FSDP: the
data-axis shards gathered, the "model" shards kept; so too the embedding
table and the head), DTensor propagates the layouts, and
`models/spmd.py` takes over where it cannot (attention, the scan and the
embedding lookup on local shards, decode over a length-sharded cache,
the head and the loss on each rank's vocab shard) and pins the residual
stream's layout (`spmd.constrain`); the MoE block partitions its
dispatch itself (`models/moe.py`). On plain tensors the `spmd` calls do
nothing.
"""
from __future__ import annotations

import functools
from typing import Callable, List, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt_lib

from repro_torch import tree as tree_lib
from repro_torch.configs.base import MAMBA1, MAMBA2, SHARED_ATTN
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import spmd
from repro_torch.models import ssm as ssm_lib

ATTN_IMPLS = ("full", "blockwise", "flash")
REMAT_POLICIES = ("none", "full", "dots", "everything")
# the 2-D matrix products whose outputs the "dots" policy keeps (JAX's
# checkpoint_dots_with_no_batch_dims: products without batch dimensions)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _maybe_remat(fn: Callable, remat: str) -> Callable:
    """fn under a rematerialisation policy, JAX's `_maybe_remat`: "none"
    and "everything" (autograd keeps every intermediate without a
    checkpoint) run fn as it is; "full" keeps only fn's inputs and
    recomputes the rest in the backward pass; "dots" also keeps the
    outputs of fn's 2-D matrix products (`_DOTS`) and recomputes the rest.
    Without grad mode nothing is kept, so fn runs as it is."""
    if remat in ("none", "everything"):
        return fn
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt_lib.create_selective_checkpoint_contexts, list(_DOTS))

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return ckpt_lib.checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def _normal(shape, scale: float, dtype, generator, device) -> torch.Tensor:
    return (torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32) * scale).to(dtype)


def init_attn_layer(cfg, dtype, generator, device,
                    cross: bool = False) -> dict:
    """One attention layer; `cross` adds the cross-attention weights of an
    encoder-decoder's decoder layer."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    s = d ** -0.5

    def nrm(shape, scale):
        return _normal(shape, scale, dtype, generator, device)
    # the FFN (or MoE) draws from the generator before the attention
    if cfg.num_experts:
        ff = {"moe": moe_lib.init_moe(cfg, dtype, generator, device)}
    else:
        ffn = {"wi": nrm((d, cfg.d_ff), s),
               "wo": nrm((cfg.d_ff, d), cfg.d_ff ** -0.5)}
        if cfg.mlp_gated:
            ffn["wg"] = nrm((d, cfg.d_ff), s)
        ff = {"ffn": ffn}
    p = {
        "ln1": torch.zeros(d, dtype=torch.float32, device=device),
        "ln2": torch.zeros(d, dtype=torch.float32, device=device),
        "wq": nrm((d, nq), s), "wk": nrm((d, nkv), s),
        "wv": nrm((d, nkv), s), "wo": nrm((nq, d), nq ** -0.5),
        **ff,
    }
    if cross:
        p.update(ln_x=torch.zeros(d, dtype=torch.float32, device=device),
                 xq=nrm((d, nq), s), xk=nrm((d, nkv), s),
                 xv=nrm((d, nkv), s), xo=nrm((nq, d), nq ** -0.5))
    return p


def _check_ported(cfg) -> None:
    """The port runs the attention families (dense, MoE, the audio
    encoder-decoder and the VLM backbone), the ssm family of mamba1
    layers (falcon-mamba) and the hybrid family of mamba2 and shared
    attention blocks in whole groups (zamba2); every other family, and an
    encoder-decoder outside the attention families, raises."""
    attn = cfg.family in ("dense", "moe", "audio", "vlm") \
        and not cfg.block_pattern
    ssm = cfg.family == "ssm" and set(cfg.blocks) == {MAMBA1}
    hybrid = (cfg.family == "hybrid"
              and set(cfg.blocks) <= {MAMBA2, SHARED_ATTN}
              and cfg.shared_attn_every > 0
              and cfg.num_layers % cfg.shared_attn_every == 0)
    if not (attn or ((ssm or hybrid) and not cfg.is_encoder_decoder)):
        raise NotImplementedError(f"family {cfg.family!r} is not ported")


def _no_hiddens(cfg, return_hiddens: bool) -> None:
    if return_hiddens and cfg.family in ("ssm", "hybrid"):
        raise ValueError("return_hiddens: attn-family layers only")


def _hybrid_shape(cfg) -> Tuple[int, int]:
    """(mamba2 blocks per group, groups) of the hybrid pattern: each group
    is `shared_attn_every - 1` mamba2 blocks, then the shared block."""
    every = cfg.shared_attn_every
    return every - 1, cfg.num_layers // every


def init_lm(cfg, generator: torch.Generator, device,
            place: Optional[Callable] = None) -> dict:
    """Random weights at the JAX package's shapes and scales (the values
    differ: torch's generator is not JAX's). On the "meta" device nothing
    is allocated: the tree's shapes and dtypes only. `place(path, leaf)`,
    when given, replaces every leaf as soon as its layer (or top-level
    leaf) is drawn, e.g. by its shard (`launch.shardings.param_placer`):
    the whole tree then never exists on one device. The draws are the
    same either way."""
    _check_ported(cfg)
    dtype = getattr(torch, cfg.dtype)

    def put(prefix: str, sub):
        if place is None:
            return sub
        names, leaves = tree_lib.flatten_with_paths(sub)
        return tree_lib.unflatten(sub, [
            place(f"{prefix}/{n}" if n else prefix, x)
            for n, x in zip(names, leaves)])
    params = {
        "embed": put("embed", _normal((cfg.vocab_size, cfg.d_model), 0.02,
                                      dtype, generator, device)),
        "final_ln": put("final_ln", torch.zeros(
            cfg.d_model, dtype=torch.float32, device=device)),
    }
    if not cfg.tie_embeddings:
        params["out"] = put("out", _normal(
            (cfg.vocab_size, cfg.d_model), 0.02, dtype, generator,
            device).T.contiguous())

    def ssm_block(init):
        return {"ln": torch.zeros(cfg.d_model, dtype=torch.float32,
                                  device=device),
                "m": init(cfg, dtype, generator, device)}
    if cfg.family == "hybrid":
        per, groups = _hybrid_shape(cfg)
        params["mamba"] = [[put(f"mamba/{g}/{i}",
                                ssm_block(ssm_lib.init_mamba2))
                            for i in range(per)] for g in range(groups)]
        params["shared_attn"] = put("shared_attn", init_attn_layer(
            cfg, dtype, generator, device))
        return params
    if cfg.family == "ssm":
        layers: List[dict] = [put(f"layers/{i}",
                                  ssm_block(ssm_lib.init_mamba1))
                              for i in range(cfg.num_layers)]
    else:
        layers = [put(f"layers/{i}", init_attn_layer(
            cfg, dtype, generator, device, cross=cfg.is_encoder_decoder))
                  for i in range(cfg.num_layers)]
    params["layers"] = layers
    if cfg.is_encoder_decoder:
        params["enc_layers"] = [put(f"enc_layers/{i}", init_attn_layer(
            cfg, dtype, generator, device))
                                for i in range(cfg.num_encoder_layers)]
        params["enc_ln"] = put("enc_ln", torch.zeros(
            cfg.d_model, dtype=torch.float32, device=device))
    return params


def _qkv(p, x, cfg, positions):
    q = spmd.split_heads(x @ p["wq"], cfg.num_heads)
    k = spmd.split_heads(x @ p["wk"], cfg.num_kv_heads)
    v = spmd.split_heads(x @ p["wv"], cfg.num_kv_heads)
    return L.positional(cfg, q, positions), L.positional(cfg, k, positions), v


def _ffn(p: dict, h: torch.Tensor, cfg, decode: bool = False):
    """The FFN half of a layer on the normed stream h [B, S, D]: (out, aux
    loss, expert counts [E] int32) for a MoE layer — at decode the
    gathered variant when cfg.hades.expert_gather_decode and T*k < E, as in
    JAX, and with no aux loss (None), which decode discards — and (out,
    None, None) for a dense one."""
    if not cfg.num_experts:
        return L.mlp(p["ffn"], h, cfg.mlp_gated), None, None
    t = h.shape[0] * h.shape[1]
    if decode and cfg.hades.expert_gather_decode and \
            t * cfg.experts_per_token < cfg.num_experts:
        return moe_lib.moe_block_gathered(p["moe"], h, cfg)
    return moe_lib.moe_block(p["moe"], h, cfg, with_aux=not decode)


def _cross(p: dict, x: torch.Tensor, cfg, enc_kv, enc_mask=None):
    """x plus the cross-attention of x [B, S, D] over the encoder's
    (k, v), each [B, Se, KV, Dh] (`_enc_kv`)."""
    b, s, _ = x.shape
    hx = L.rms_norm(x, p["ln_x"], cfg.norm_eps)
    qx = spmd.split_heads(hx @ p["xq"], cfg.num_heads)
    ox = attn_lib.cross_attention(qx, enc_kv[0], enc_kv[1], enc_mask)
    return x + ox.reshape(b, s, -1) @ p["xo"]


def decode_layer_step(p: dict, x: torch.Tensor, cfg, positions, attend_fn,
                      enc_kv=None):
    """One decoder layer of single-token decode, with the KV mechanics
    supplied by the caller. x: [B,1,D]; positions: [B,1];
    attend_fn(q, k, v) -> (attention out reshapeable to [B,1,H*Dh], aux)
    with q [B,1,H,Dh] and k/v [B,1,KV,Dh]; enc_kv: the encoder's (k, v)
    for cross attention, or None. Returns (x', aux, expert counts): [E]
    int32 for a MoE layer, None for a dense one (JAX returns zeros there;
    no caller of the port reads them)."""
    b = x.shape[0]
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(p, h, cfg, positions)
    o, aux = attend_fn(q, k, v)
    x = spmd.constrain(x + o.reshape(b, 1, -1) @ p["wo"])
    if enc_kv is not None:
        x = spmd.constrain(_cross(p, x, cfg, enc_kv))
    f, _, counts = _ffn(p, L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg,
                        decode=True)
    return spmd.constrain(x + f), aux, counts


@spmd.wrap
def _flash(q, k, v, **kw):
    """The flash_attention kernel's wrapper, on local shards for DTensors
    (looked up at each call, so that a patched `kops.flash_attention`
    takes effect)."""
    return kops.flash_attention(q, k, v, **kw)


def attn_ffn_block(p: dict, x: torch.Tensor, cfg, positions, *,
                   causal: bool = True, attn_impl: str = "blockwise",
                   enc_kv=None, enc_mask=None):
    """Full-sequence block, causal (a decoder) or not (an encoder). x:
    [B, S, D]; positions: [B, S] (or mrope's [3, B, S]); enc_kv: the
    encoder's (k, v) for cross attention after the self attention, with
    the optional enc_mask [B, Se]. Returns (x', aux loss, (k, v), expert
    counts [E] int32); aux and counts are None for a dense layer. `flash`
    runs the flash_attention kernel, whose mask ignores `positions`, as
    the TPU kernel's does (the other two mask by the primary stream,
    `_pos2d`)."""
    b, s, _ = x.shape
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(p, h, cfg, positions)
    pos = _pos2d(positions)
    kwargs = dict(causal=causal, window=cfg.sliding_window, q_pos=pos,
                  k_pos=pos)
    if attn_impl == "full":
        o = attn_lib.full_attention(q, k, v, **kwargs)
    elif attn_impl == "blockwise":
        o = attn_lib.blockwise_attention(q, k, v, chunk=min(512, s),
                                         **kwargs)
    elif attn_impl == "flash":
        o = _flash(q, k, v, causal=causal, window=cfg.sliding_window)
    else:
        raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
    x = spmd.constrain(x + o.reshape(b, s, -1) @ p["wo"])
    if enc_kv is not None:
        x = spmd.constrain(_cross(p, x, cfg, enc_kv, enc_mask))
    f, aux, counts = _ffn(p, L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return spmd.constrain(x + f), aux, (k, v), counts


def _pos2d(positions):
    """Reduce mrope [3, B, S] to the primary stream for masking."""
    if positions is None:
        return None
    return positions[0] if positions.dim() == 3 else positions


def _check_forward(cfg, remat: str, enc_embeds) -> None:
    _check_ported(cfg)
    if cfg.is_encoder_decoder and enc_embeds is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: its forward "
                         "needs enc_embeds [B, S_enc, D]")
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat {remat!r} not in {REMAT_POLICIES}")


def _head(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """The logits; on DTensors with the vocab over "model" (split there
    by `spmd.shard_on_model` where the sharding rules leave it whole, a
    vocab the axis does not divide), and their gradient kept in that
    layout."""
    x = L.rms_norm(x, spmd.gather_weights(params["final_ln"]), cfg.norm_eps)
    out_t = spmd.gather_weights(params["embed"]).T if cfg.tie_embeddings \
        else spmd.gather_weights(params["out"])
    return spmd.pin_grad(L.logits_head(spmd.shard_on_model(out_t, 1), x))


def lm_forward(params: dict, cfg, tokens: torch.Tensor, *,
               positions: Optional[torch.Tensor] = None,
               extra_embeds=None, enc_embeds=None,
               attn_impl: str = "blockwise", remat: str = "none",
               return_cache: bool = False, return_hiddens: bool = False):
    """tokens: [B, S_txt] -> (logits [B, S, V] fp32, aux). extra_embeds
    (VLM patches) [B, P, D] are prepended, cast to the stream's dtype (S =
    P + S_txt); enc_embeds (an encoder-decoder's frames) [B, S_enc, D] run
    through `encoder_forward`, whose output every decoder layer attends
    to. The layers run as a Python loop over params["layers"].
    `return_cache` puts "kv_cache" = (k, v), each [L, B, S, KV, Dh] after
    rotary, in aux (None for the ssm family, as in JAX), and for the
    attention family "enc_out", the encoder's output (None without an
    encoder); `return_hiddens` puts "hiddens" [L, B, S, D], the
    post-layer residual stream (attn-family layers only). For the
    attention family aux also holds, as in JAX, "moe_aux_loss" (fp32, the
    sum over layers), "expert_counts" [E] and "expert_counts_per_layer"
    [L, E] int32 (zeros, with E = 1, for a dense config); for the hybrid
    family only "moe_aux_loss" (0) and "expert_counts" [1] (zeros), JAX's
    keys there, and "kv_cache" None with `return_cache`. ssm layers
    ignore `positions` and `attn_impl`. `remat` (`_maybe_remat`) applies
    per layer, and for the hybrid family per group, as in JAX."""
    _check_forward(cfg, remat, enc_embeds)
    _no_hiddens(cfg, return_hiddens)
    x = spmd.lookup(L.embed, spmd.gather_weights(params["embed"]), tokens)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    x = spmd.constrain(x)
    if cfg.family == "ssm":
        def ssm_body(h, lp):
            lp = spmd.gather_weights(lp)
            y, _ = ssm_lib.mamba1_forward(
                lp["m"], L.rms_norm(h, lp["ln"], cfg.norm_eps), cfg)
            return spmd.constrain(h + y)
        ssm_body = _maybe_remat(ssm_body, remat)
        for lp in params["layers"]:
            x = ssm_body(x, lp)
        return _head(params, cfg, x), (
            {"kv_cache": None} if return_cache else {})
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    if cfg.family == "hybrid":
        x = _hybrid_forward(params, cfg, x, positions, attn_impl, remat)
        aux = {"moe_aux_loss": torch.zeros((), device=x.device),
               "expert_counts": torch.zeros(1, dtype=torch.int32,
                                            device=x.device)}
        if return_cache:
            aux["kv_cache"] = None
        return _head(params, cfg, x), aux
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = encoder_forward(params, cfg, enc_embeds,
                                  attn_impl=attn_impl, remat=remat)

    def layer(lp, h, enc):
        lp = spmd.gather_weights(lp)
        return attn_ffn_block(
            lp, h, cfg, positions, attn_impl=attn_impl,
            enc_kv=None if enc is None else _enc_kv(lp, enc, cfg))
    kvs, hs, losses, counts = [], [], [], []
    body = _maybe_remat(layer, remat)
    for lp in params["layers"]:
        x, loss, kv, cnt = body(lp, x, enc_out)
        if return_cache:
            kvs.append(kv)
        if return_hiddens:
            hs.append(x)
        losses.append(loss)
        counts.append(cnt)
    if cfg.num_experts:
        per_layer = torch.stack(counts)
        aux = {"moe_aux_loss": torch.stack(losses).sum()}
    else:
        per_layer = torch.zeros((cfg.num_layers, 1), dtype=torch.int32,
                                device=x.device)
        aux = {"moe_aux_loss": torch.zeros((), device=x.device)}
    aux["expert_counts"] = per_layer.sum(0, dtype=torch.int32)
    aux["expert_counts_per_layer"] = per_layer
    if return_cache:
        aux["kv_cache"] = (torch.stack([k for k, _ in kvs]),
                           torch.stack([v for _, v in kvs]))
        aux["enc_out"] = enc_out
    if return_hiddens:
        aux["hiddens"] = torch.stack(hs)
    return _head(params, cfg, x), aux


def _enc_kv(lp: dict, enc_out: torch.Tensor, cfg):
    """Project the encoder's output [B, Se, D] to this decoder layer's
    cross-attention (k, v), each [B, Se, KV, Dh]."""
    return spmd.split_heads(enc_out @ lp["xk"], cfg.num_kv_heads), \
        spmd.split_heads(enc_out @ lp["xv"], cfg.num_kv_heads)


def encoder_forward(params: dict, cfg, enc_embeds: torch.Tensor, *,
                    attn_impl: str = "blockwise",
                    remat: str = "none") -> torch.Tensor:
    """The encoder: enc_embeds [B, Se, D] (any float dtype; cast to the
    model's) through params["enc_layers"], non-causal, then "enc_ln".
    `remat` applies per layer. Returns [B, Se, D] in the model's dtype."""
    b, s, _ = enc_embeds.shape
    positions = torch.arange(s, device=enc_embeds.device)[None].expand(b, s)
    x = enc_embeds.to(getattr(torch, cfg.dtype))

    def layer(lp, h):
        return attn_ffn_block(spmd.gather_weights(lp), h, cfg, positions,
                              causal=False,
                              attn_impl=attn_impl)[0]
    body = _maybe_remat(layer, remat)
    for lp in params["enc_layers"]:
        x = body(lp, x)
    return L.rms_norm(x, spmd.gather_weights(params["enc_ln"]), cfg.norm_eps)


def _hybrid_forward(params: dict, cfg, x: torch.Tensor, positions,
                    attn_impl: str, remat: str) -> torch.Tensor:
    """zamba2: each group's mamba2 blocks (x + mamba2(rms_norm(x))), then
    the shared attention block, the same weights at every occurrence;
    `remat` applies to a group as a whole."""
    def group_body(h, group):
        for lp in group:
            lp = spmd.gather_weights(lp)
            y, _ = ssm_lib.mamba2_forward(
                lp["m"], L.rms_norm(h, lp["ln"], cfg.norm_eps), cfg)
            h = spmd.constrain(h + y)
        return attn_ffn_block(spmd.gather_weights(params["shared_attn"]), h,
                              cfg, positions, attn_impl=attn_impl)[0]
    group_body = _maybe_remat(group_body, remat)
    for group in params["mamba"]:
        x = group_body(x, group)
    return x


def lm_loss(params: dict, cfg, tokens: torch.Tensor, labels: torch.Tensor,
            *, extra_embeds=None, enc_embeds=None,
            attn_impl: str = "blockwise", remat: str = "none"):
    """Next-token cross entropy (mean over labels != -100) on the text
    positions (the patch positions' logits are dropped), plus 0.01 x the
    MoE auxiliary loss for a MoE config."""
    logits, aux = lm_forward(params, cfg, tokens, extra_embeds=extra_embeds,
                             enc_embeds=enc_embeds, attn_impl=attn_impl,
                             remat=remat)
    if extra_embeds is not None:
        logits = logits[:, extra_embeds.shape[1]:]
    loss = token_loss(logits, labels)
    if cfg.num_experts:
        loss = loss + 0.01 * aux["moe_aux_loss"]
    return loss, aux


def token_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean next-token cross entropy of logits [B, S, V] over the
    labels [B, S] that are not -100 (0 when every label is -100). On
    DTensor logits with the vocab over "model" the log-probabilities are
    taken on each rank's vocab shard (`spmd.vocab_nll`): nothing gathers
    the logits or their gradient."""
    mask = labels != -100
    safe = torch.where(mask, labels, 0).long()
    nll = spmd.vocab_nll(logits, safe)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)


def init_decode_state(cfg, batch: int, max_len: int, device,
                      enc_out: Optional[torch.Tensor] = None) -> dict:
    """Dense (non-paged) decode state: {"pos": int, "kv": {"k", "v":
    [L, B, C, KV, Dh], "k_pos": [L, B, C] int32 (-1 empty)}}. C is max_len,
    clipped to the sliding window for windowed configs (ring buffer). For
    the ssm family: {"pos": int, "ssm": {"h": [L, B, Din, N] fp32, "conv":
    [L, B, K-1, Din]}}, the JAX package's layout; max_len is ignored. For
    the hybrid family (G groups of `per` mamba2 blocks): {"pos", "ssm":
    {"h": [G, per, B, N, nh, 64] fp32, "conv": [G, per, B, K-1, Din + 2N]},
    "kv": the ring caches above with G in place of L, one per occurrence
    of the shared block}. An encoder-decoder's state also holds "enc_out",
    the encoder's output [B, Se, D], which it requires."""
    _check_ported(cfg)
    if cfg.is_encoder_decoder and enc_out is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: its decode "
                         "state needs enc_out [B, S_enc, D]")
    dtype = getattr(torch, cfg.dtype)

    def stacked(st, lead):
        return {k: torch.zeros(lead + v.shape, dtype=v.dtype, device=device)
                for k, v in st.items()}
    if cfg.family == "ssm":
        return {"pos": 0, "ssm": stacked(ssm_lib.mamba1_init_state(
            cfg, batch, dtype, device), (cfg.num_layers,))}
    hd = cfg.resolved_head_dim
    c = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    n_caches = cfg.num_layers
    state = {"pos": 0}
    if cfg.family == "hybrid":
        per, n_caches = _hybrid_shape(cfg)
        state["ssm"] = stacked(ssm_lib.mamba2_init_state(
            cfg, batch, dtype, device), (n_caches, per))
    shape = (n_caches, batch, c, cfg.num_kv_heads, hd)
    state["kv"] = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "k_pos": torch.full(shape[:3], -1, dtype=torch.int32,
                            device=device)}
    if cfg.is_encoder_decoder:
        state["enc_out"] = enc_out
    return state


def attn_block_decode(p: dict, x: torch.Tensor, cfg, cache: dict, pos: int,
                      enc_kv=None):
    """x: [B, 1, D]; cache: one layer's {"k", "v": [B, C, KV, Dh], "k_pos":
    [B, C]}, UPDATED IN PLACE: the token goes to slot pos % C (a ring for
    sliding windows, linear otherwise), then attends; enc_kv: the
    encoder's (k, v) for cross attention, or None. Returns x'."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    c = cache["k"].shape[1]

    def attend(q, k, v):
        if spmd.is_dtensor(q):
            return spmd.decode_attention(q, cache, k, v, pos,
                                         min(pos + 1, c),
                                         cfg.sliding_window), None
        attn_lib.write_cache(cache, pos % c, k, v, pos)
        o = attn_lib.decode_attention(q, cache["k"], cache["v"],
                                      min(pos + 1, c),
                                      window=cfg.sliding_window,
                                      k_pos=cache["k_pos"], q_pos=pos)
        return o, None

    return decode_layer_step(p, x, cfg, positions, attend, enc_kv)[0]


def lm_decode_step(params: dict, cfg, state: dict, tokens: torch.Tensor, *,
                   return_hiddens: bool = False):
    """tokens: [B] -> (logits [B, V], state), one token per sequence. The
    caches (or ssm states) in `state` are updated in place (the JAX
    package returns new ones); the returned state carries pos + 1.
    `return_hiddens` (attn family only) appends the post-layer residual
    stream [L, B, 1, D]."""
    _check_ported(cfg)
    _no_hiddens(cfg, return_hiddens)
    x = spmd.lookup(L.embed, spmd.gather_weights(params["embed"]),
                    tokens)[:, None, :]
    pos = state["pos"]
    if cfg.family == "ssm":
        ssm = state["ssm"]
        for i, lp in enumerate(params["layers"]):
            lp = spmd.gather_weights(lp)
            y, new = ssm_lib.mamba1_step(
                lp["m"], L.rms_norm(x, lp["ln"], cfg.norm_eps), cfg,
                {k: v[i] for k, v in ssm.items()})
            for k, v in ssm.items():
                v[i] = new[k]
            x = x + y
        return _head(params, cfg, x)[:, 0], dict(state, pos=pos + 1)
    kv = state["kv"]
    if cfg.family == "hybrid":
        ssm = state["ssm"]
        shared = spmd.gather_weights(params["shared_attn"])
        for g, group in enumerate(params["mamba"]):
            for i, lp in enumerate(group):
                lp = spmd.gather_weights(lp)
                y, new = ssm_lib.mamba2_step(
                    lp["m"], L.rms_norm(x, lp["ln"], cfg.norm_eps), cfg,
                    {k: v[g, i] for k, v in ssm.items()})
                for k, v in ssm.items():
                    v[g, i] = new[k]
                x = x + y
            x = attn_block_decode(shared, x, cfg,
                                  {n: t[g] for n, t in kv.items()}, pos)
        return _head(params, cfg, x)[:, 0], dict(state, pos=pos + 1)
    hs = []
    enc_out = state.get("enc_out")
    for i, lp in enumerate(params["layers"]):
        lp = spmd.gather_weights(lp)
        x = attn_block_decode(lp, x, cfg, {n: t[i] for n, t in kv.items()},
                              pos, None if enc_out is None
                              else _enc_kv(lp, enc_out, cfg))
        if return_hiddens:
            hs.append(x)
    logits = _head(params, cfg, x)[:, 0]
    state = dict(state, pos=pos + 1)
    if return_hiddens:
        return logits, state, torch.stack(hs)
    return logits, state
