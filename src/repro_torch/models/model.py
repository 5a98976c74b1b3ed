"""Public model facade of the port (counterpart of `repro/models/model.py`
for all ten architectures: the dense and MoE decoders, the ssm family
(falcon-mamba), the hybrid family (zamba2), the encoder-decoder
(seamless-m4t) and the VLM (qwen2-vl)): the config, the device the
weights live on, a seeded random init, the step functions on the JAX
package's batch dicts ({"tokens"} for forward / prefill, {"tokens",
"labels"} for loss, which the trainer differentiates; plus "enc_embeds"
for an encoder-decoder and, optionally, "extra_embeds" for a VLM), and
`param_specs` / `input_specs` / `make_inputs` for the assigned shapes
(`configs/shapes.py`).

The modality frontends are stubs, as in the JAX package: an
encoder-decoder takes precomputed frame embeddings (the encoder's input),
a VLM precomputed patch embeddings (prepended to the text stream).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T

VLM_PATCHES = 256  # patch budget of the vision stub (full shapes)


def vlm_patches(seq_len: int) -> int:
    """Patch count for a cell: 256 for full shapes, scaled down for smoke."""
    return min(VLM_PATCHES, max(4, seq_len // 4))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


class Model:
    """attn_impl: "full", "blockwise" or "flash" (the flash_attention
    kernel, which has no gradient: train with "blockwise") for the
    full-sequence paths of attention layers, the hybrid family's shared
    block included (ssm layers ignore it and run the mamba_scan kernel);
    remat: "none", "full", "dots" or "everything" (`transformer.
    _maybe_remat`), per layer and, in the hybrid family, per group."""

    def __init__(self, cfg: ModelConfig, attn_impl: str = "blockwise",
                 remat: str = "none", device: Optional[str] = None):
        if attn_impl not in T.ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in "
                             f"{T.ATTN_IMPLS}")
        if remat not in T.REMAT_POLICIES:
            raise ValueError(f"remat {remat!r} not in {T.REMAT_POLICIES}")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.remat = remat
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator, place=None) -> dict:
        """Random weights from `generator` (which must live on
        self.device), at the JAX package's shapes and scales. `place(path,
        leaf)` replaces each leaf as its layer is drawn (`transformer.
        init_lm`; e.g. `launch.shardings.param_placer`)."""
        return T.init_lm(self.cfg, generator, self.device, place=place)

    def param_specs(self) -> dict:
        """The parameter tree as "meta" tensors: every leaf's shape and
        dtype, nothing allocated (JAX's `jax.eval_shape` of init)."""
        return T.init_lm(self.cfg, torch.Generator(), "meta")

    def input_specs(self, shape: ShapeSpec, for_decode_state: bool = True
                    ) -> Dict:
        """"meta" tensors standing in for every input of the step function
        that shape.mode selects, under the JAX package's names, shapes and
        dtypes: train {"tokens", "labels"}, prefill {"tokens"}, each with
        "extra_embeds" [B, P, D] for a VLM (S_txt = S - P) and
        "enc_embeds" [B, S_enc, D] fp32 for an encoder-decoder; decode
        {"tokens" [B]} and, with for_decode_state, "state" (its "pos" the
        Python int 0, where JAX keeps an int32 scalar)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        dtype = getattr(torch, cfg.dtype)
        if shape.mode in ("train", "prefill"):
            batch: Dict = {}
            s_txt = s
            if cfg.frontend == "vision":
                p = vlm_patches(s)
                s_txt = s - p
                batch["extra_embeds"] = _meta((b, p, cfg.d_model), dtype)
            if cfg.is_encoder_decoder:
                batch["enc_embeds"] = _meta(
                    (b, cfg.encoder_seq_len, cfg.d_model), torch.float32)
            batch["tokens"] = _meta((b, s_txt), torch.int32)
            if shape.mode == "train":
                batch["labels"] = _meta((b, s_txt), torch.int32)
            return batch
        if shape.mode == "decode":
            batch = {"tokens": _meta((b,), torch.int32)}
            if for_decode_state:
                enc = _meta((b, cfg.encoder_seq_len, cfg.d_model), dtype) \
                    if cfg.is_encoder_decoder else None
                batch["state"] = T.init_decode_state(cfg, b, s, "meta",
                                                     enc_out=enc)
            return batch
        raise ValueError(f"shape mode {shape.mode!r}")

    def make_inputs(self, shape: ShapeSpec,
                    generator: torch.Generator) -> Dict:
        """Concrete random inputs matching `input_specs` on self.device
        (`generator` must live there): integers in [0, vocab), floats
        N(0, 1) x 0.02 in the spec's dtype, and for decode a fresh state
        (with a random enc_out for an encoder-decoder)."""
        specs = self.input_specs(shape, for_decode_state=False)
        out = {}
        for name, spec in sorted(specs.items()):
            if spec.dtype.is_floating_point:
                out[name] = (torch.randn(spec.shape, generator=generator,
                                         device=self.device) * 0.02
                             ).to(spec.dtype)
            else:
                out[name] = torch.randint(
                    0, self.cfg.vocab_size, spec.shape, generator=generator,
                    device=self.device, dtype=spec.dtype)
        if shape.mode == "decode":
            enc = None
            if self.cfg.is_encoder_decoder:
                enc = (torch.randn(
                    (shape.global_batch, self.cfg.encoder_seq_len,
                     self.cfg.d_model), generator=generator,
                    device=self.device) * 0.02).to(getattr(torch,
                                                           self.cfg.dtype))
            out["state"] = self.init_decode_state(
                shape.global_batch, shape.seq_len, enc_out=enc)
        return out

    def forward(self, params, batch: Dict) -> Tuple[torch.Tensor, dict]:
        return T.lm_forward(params, self.cfg, batch["tokens"],
                            extra_embeds=batch.get("extra_embeds"),
                            enc_embeds=batch.get("enc_embeds"),
                            attn_impl=self.attn_impl, remat=self.remat)

    def loss(self, params, batch: Dict) -> Tuple[torch.Tensor, dict]:
        return T.lm_loss(params, self.cfg, batch["tokens"], batch["labels"],
                         extra_embeds=batch.get("extra_embeds"),
                         enc_embeds=batch.get("enc_embeds"),
                         attn_impl=self.attn_impl, remat=self.remat)

    def prefill(self, params, batch: Dict) -> torch.Tensor:
        return self.forward(params, batch)[0]

    def init_decode_state(self, batch: int, max_len: int,
                          enc_out: Optional[torch.Tensor] = None) -> dict:
        """The ssm family's state is O(1) in length: max_len is ignored;
        the hybrid family's ring caches (one per shared-block occurrence)
        hold max_len tokens. An encoder-decoder needs enc_out, the
        encoder's output [B, S_enc, D] (`transformer.encoder_forward`, or
        `lm_forward`'s aux["enc_out"] with return_cache)."""
        return T.init_decode_state(self.cfg, batch, max_len, self.device,
                                   enc_out=enc_out)

    def decode_step(self, params, state, tokens, **kw):
        return T.lm_decode_step(params, self.cfg, state, tokens, **kw)


def build(arch_id: str, reduced: bool = False, **kw) -> Model:
    from repro_torch.configs import get_config
    return Model(get_config(arch_id, reduced=reduced), **kw)
