"""Gradient compression for the cross-pod all-reduce (port of
`repro/optim/compression.py`): int8 block quantization with error
feedback.

On the multi-pod mesh the pod-axis gradient all-reduce crosses InfiniBand
(50 GB/s a GPU), an order of magnitude slower than NVLink (`launch/
mesh.py`); 4x compression (bf16 -> int8 with a scale per block) cuts that
term. Error feedback (the residual carried into the next step) keeps the
quantization unbiased in the long run (1-bit Adam / PowerSGD lineage).

Layout: per 256-element block, scale = max|g| / 127 (at least 1e-12);
payload int8, rounded half to even (`torch.round`, as `jnp.round`): q and
the scales equal the JAX package's bit for bit. The all-reduce sums the
decompressed fp32 values over the group (the compression targets the wire
format, as in JAX, whose psum runs over the decompressed values too).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree as tree_lib

BLOCK = 256


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """g: any shape -> (q int8 [ceil(n/B), B], scales fp32 [ceil(n/B)]),
    the JAX package's shapes."""
    flat = g.float().reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which rounds differently from the CPU and from JAX
    amax = flat.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    flat = (q.float().reshape(-1, BLOCK) * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def _group(group_or_mesh_dim):
    """A process group, or (mesh, axis name) -> that axis's group."""
    if isinstance(group_or_mesh_dim, tuple):
        mesh, axis = group_or_mesh_dim
        return mesh.get_group(axis)
    return group_or_mesh_dim


def compressed_allreduce(grads: Any, group_or_mesh_dim,
                         error: Any = None) -> Tuple[Any, Any]:
    """Quantize -> all-reduce (sum) -> dequantize with error feedback, leaf
    by leaf in `repro_torch.tree` order. group_or_mesh_dim: a process
    group, or (DeviceMesh, axis name), e.g. (mesh, "pod"). Returns
    (reduced grads in each leaf's dtype, new error in the error's dtype);
    the sum runs in fp32 with `torch.distributed.all_reduce`."""
    import torch.distributed as dist
    group = _group(group_or_mesh_dim)
    if error is None:
        error = tree_lib.map_leaves(torch.zeros_like, grads)

    def one(g, e):
        g32 = g.float() + e.float()
        q, scale = compress_int8(g32)
        local = decompress_int8(q, scale, g.shape, torch.float32)
        new_e = (g32 - local).to(e.dtype)              # residual feedback
        summed = local.clone()
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        return summed.to(g.dtype), new_e

    out = [one(g, e) for g, e in zip(tree_lib.leaves(grads),
                                     tree_lib.leaves(error), strict=True)]
    return (tree_lib.unflatten(grads, [o[0] for o in out]),
            tree_lib.unflatten(grads, [o[1] for o in out]))
