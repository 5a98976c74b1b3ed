"""Convert the JAX package's parameter pytree into the port's parameters,
so that both compute the same function in the tests.

Input: the JAX params with every leaf already a numpy array (for example
`jax.tree.map(np.asarray, params)`). JAX stacks the per-layer dicts on a
leading [L] axis (its layers run under `vmap`/`scan`); the port keeps one
dict per layer. Matrices keep the JAX layout ([in, out]; `out` is
[D, V]). bfloat16 arrays arrive as numpy's `bfloat16` extension type and
are reinterpreted bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()) \
            .view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def _first_leaf(tree):
    return _first_leaf(next(iter(tree.values()))) if isinstance(tree, dict) \
        else tree


def from_jax(params: dict, device="cpu") -> dict:
    """JAX params (numpy leaves) -> the port's params on `device`."""
    out = {k: _convert(v, device) for k, v in params.items()
           if k != "layers"}
    stacked = _convert(params["layers"], device)
    n = len(_first_leaf(stacked))

    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return tree[i].contiguous()
    out["layers"] = [layer(stacked, i) for i in range(n)]
    return out
