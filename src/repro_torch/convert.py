"""Convert the JAX package's parameter pytree into the port's parameters
(`from_jax`), its AdamW state into the port's (`opt_from_jax`), a JAX
pool state into the port's (`pool_from_jax`) and a JAX tiered-embedding
state into the port's (`embedding_from_jax`), so that both packages
compute the same function, or continue the same run, in the tests.

Input: the JAX params with every leaf already a numpy array (for example
`jax.tree.map(np.asarray, params)`), or a tensor (as the port's
`checkpoint.ckpt.restore` returns a JAX checkpoint's leaves). JAX stacks the per-layer dicts on a
leading [L] axis (its layers run under `vmap`/`scan`), and a hybrid
model's mamba2 blocks on two, [G, per]; the port keeps one dict per layer
(per group, a list of one dict per block). Matrices keep the JAX layout
([in, out]; `out` is [D, V]). bfloat16 arrays arrive as numpy's
`bfloat16` extension type and are reinterpreted bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True).contiguous()
    a = np.array(a, order="C")       # a contiguous copy; 0-d stays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)) \
            .view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def _first_leaf(tree):
    return _first_leaf(next(iter(tree.values()))) if isinstance(tree, dict) \
        else tree


def _unstack(stacked) -> list:
    """A tree of tensors stacked on a leading axis -> a list of trees."""
    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return tree[i].contiguous()
    return [layer(stacked, i) for i in range(len(_first_leaf(stacked)))]


def from_jax(params: dict, device="cpu") -> dict:
    """JAX params (numpy leaves) -> the port's params on `device`:
    "layers" [L] and an encoder-decoder's "enc_layers" [L_enc] as lists of
    layer dicts, a hybrid model's "mamba" [G, per] as G lists of `per`
    block dicts; everything else ("shared_attn", "enc_ln" and the cross
    weights inside each layer included) leaf by leaf."""
    out = {k: _convert(v, device) for k, v in params.items()
           if k not in ("layers", "enc_layers", "mamba")}
    for k in ("layers", "enc_layers"):
        if k in params:
            out[k] = _unstack(_convert(params[k], device))
    if "mamba" in params:
        out["mamba"] = [_unstack(g) for g in
                        _unstack(_convert(params["mamba"], device))]
    return out


def opt_from_jax(state: dict, device="cpu") -> dict:
    """JAX's AdamW state {"m", "v": trees in the params' layout, "step"}
    (numpy or tensor leaves) -> the port's: m and v converted as
    `from_jax` converts params, step a 0-d int32 tensor."""
    return {"m": from_jax(state["m"], device),
            "v": from_jax(state["v"], device),
            "step": _tensor(state["step"], device).to(torch.int32)}


def _leaf(a: np.ndarray, device) -> torch.Tensor:
    """One pool leaf; uint32 words reinterpreted bit for bit as int32 (the
    port's table dtype)."""
    a = np.asarray(a)
    return _tensor(a.view(np.int32) if a.dtype == np.uint32 else a, device)


def pool_from_jax(state: dict, device="cpu") -> dict:
    """A JAX pool state (numpy leaves, e.g. `jax.tree.map(np.asarray,
    state)`) -> the port's pool state on `device`: the same keys, table
    words as int32 with the same bits, and the backend's carried state
    (`bstate`: {} or the mglru / promote arrays) leaf by leaf."""
    return {k: pool_from_jax(v, device) if isinstance(v, dict)
            else _leaf(v, device) for k, v in state.items()}


def embedding_from_jax(state: dict, device="cpu") -> dict:
    """A JAX tiered-embedding state (`models/embedding.py`; numpy leaves)
    -> the port's on `device`: the same keys and dtypes, bf16 tables bit
    for bit, the window counters as 0-d int32 tensors."""
    return {k: _tensor(v, device) for k, v in state.items()}
