"""Public model facade of the port (counterpart of `repro/models/model.py`
for the dense and MoE decoders, the ssm family (falcon-mamba) and the
hybrid family (zamba2: mamba2 blocks and a shared attention block)): the
config, the device the weights live on, a seeded random init, and the
step functions on the JAX package's batch dicts ({"tokens"} for forward /
prefill, {"tokens", "labels"} for loss, which the trainer differentiates).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


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

    def init(self, generator: torch.Generator) -> dict:
        """Random weights from `generator` (which must live on
        self.device), at the JAX package's shapes and scales."""
        return T.init_lm(self.cfg, generator, self.device)

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

    def init_decode_state(self, batch: int, max_len: int) -> dict:
        """The ssm family's state is O(1) in length: max_len is ignored;
        the hybrid family's ring caches (one per shared-block occurrence)
        hold max_len tokens."""
        return T.init_decode_state(self.cfg, batch, max_len, self.device)

    def decode_step(self, params, state, tokens, **kw):
        return T.lm_decode_step(params, self.cfg, state, tokens, **kw)


def build(arch_id: str, reduced: bool = False, **kw) -> Model:
    from repro_torch.configs import get_config
    return Model(get_config(arch_id, reduced=reduced), **kw)
