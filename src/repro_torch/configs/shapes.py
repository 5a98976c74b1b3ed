"""Assigned input shapes and (arch x shape) applicability (the port's copy
of `repro.configs.shapes`: the same shapes, order and rule).

Shapes (LM transformer family — seq_len x global_batch):
  train_4k      seq_len=4096    global_batch=256   -> train_step
  prefill_32k   seq_len=32768   global_batch=32    -> serve prefill
  decode_32k    seq_len=32768   global_batch=128   -> serve_step (1 new token,
                                                      KV cache of seq_len)
  long_500k     seq_len=524288  global_batch=1     -> serve_step; requires
                                                      sub-quadratic attention
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

SHAPE_ORDER: Tuple[str, ...] = (
    "train_4k", "prefill_32k", "decode_32k", "long_500k")


def applicable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell is runnable; reason if not.

    Per assignment: long_500k needs sub-quadratic attention — skipped for
    pure full-attention archs (noted in DESIGN.md); runs for SSM/hybrid/SWA.
    Encoder-only archs would skip decode shapes; none are assigned.
    """
    spec = SHAPES[shape_name]
    if spec.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 524k decode is N/A (DESIGN.md §3.5)"
    return True, ""


def reduced_shape(shape_name: str) -> ShapeSpec:
    """Tiny analog of each shape for CPU smoke tests."""
    spec = SHAPES[shape_name]
    return ShapeSpec(spec.name + "_smoke", seq_len=min(spec.seq_len, 64),
                     global_batch=min(spec.global_batch, 2), mode=spec.mode)
