"""Public model facade of the port (counterpart of `repro/models/model.py`
for the dense decoder): the config, the device the weights live on, and a
seeded random init.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def resolve_device(device: Optional[str]) -> torch.device:
    """The entry points' device rule: `cuda` unless the caller asks for
    another device; asking for nothing without CUDA raises instead of
    silently running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU")
        device = "cuda"
    return torch.device(device)


class Model:
    def __init__(self, cfg: ModelConfig, device: Optional[str] = None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator) -> dict:
        """Random weights from `generator` (which must live on
        self.device), at the JAX package's shapes and scales."""
        return T.init_lm(self.cfg, generator, self.device)


def build(arch_id: str, reduced: bool = False,
          device: Optional[str] = None) -> Model:
    from repro_torch.configs import get_config
    return Model(get_config(arch_id, reduced=reduced), device=device)
