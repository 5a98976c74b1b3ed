"""AdamW with decoupled weight decay, global-norm clipping, and a cosine
schedule with linear warmup (port of `repro/optim/adamw.py`). The state is
a plain tree, {"m", "v": trees of fp32 tensors in the params' layout,
"step": int32 0-d tensor}, so it checkpoints with the trainer.

`adamw_update` runs in fp32 and casts back to each param's dtype, as in
JAX, but it writes the new params, m and v into the tensors it was given
under `torch.no_grad()`: the counterpart of the JAX trainer donating them
(`repro/runtime/trainer.py`). It still returns (params, state, metrics).
Plain torch ops, leaf by leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (a tensor), fp32."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: Any) -> Dict:
    """Zero fp32 m and v in each param's layout (a DTensor param's m and v
    are DTensors of its placements, the sharding rules' `opt_shardings`),
    and step 0."""
    def zeros32(p):
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
    device = tree_lib.leaves(params)[0].device
    return {"m": tree_lib.map_leaves(zeros32, params),
            "v": tree_lib.map_leaves(zeros32, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.stack([x.float().square().sum()
                        for x in tree_lib.leaves(tree)]).sum().sqrt()


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any, state: Dict
                 ) -> Tuple[Any, Dict, Dict]:
    """Returns (params, state, metrics {"lr", "grad_norm"}); the norm is
    the one before clipping. params, state["m"] and state["v"] are
    updated in place; state["step"] is a new tensor."""
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    for p, g, m, v in zip(tree_lib.leaves(params), tree_lib.leaves(grads),
                          tree_lib.leaves(state["m"]),
                          tree_lib.leaves(state["v"])):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        p32 = p.float()
        delta = (m / b1c) / ((v / b2c).sqrt() + cfg.eps) + \
            cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"lr": lr, "grad_norm": gn}
