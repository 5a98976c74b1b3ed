"""The port's device rule and host-to-device uploads."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


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


def upload(host: np.ndarray, device) -> torch.Tensor:
    """A host array on `device`. On CUDA the copy goes through pinned
    memory without blocking: a copy from pageable memory would wait for
    the device."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
