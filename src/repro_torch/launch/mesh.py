"""Production meshes on NVIDIA H100s (port of `repro/launch/mesh.py`), and
the card's constants, which the roofline, the dry run and `chip_smoke.py`
read from here.

Single pod: (16, 16) = 256 GPUs, axes (data, model).
Multi-pod:  (2, 16, 16) = 512 GPUs, axes (pod, data, model).

A pod stands for one NVLink domain of 256 H100 SXM5 GPUs: 32 eight-GPU
HGX H100 nodes joined by the NVLink Switch System (DGX H100 SuperPOD,
NVIDIA's reference architecture), so the data and model axes stay on
NVLink. The pod axis carries pure data parallelism (the gradient
all-reduce) between two such domains over InfiniBand NDR (400 Gb/s, 50
GB/s, a GPU), an order of magnitude slower: `optim/compression.py` targets
that link. The mesh shapes and axis names are the JAX package's, so the
sharding rules and the dry run's records compare one to one.

The meshes are `torch.distributed.device_mesh.DeviceMesh`es over the
default process group, built by FUNCTIONS: importing this module touches
no process group and no device. `AbstractMesh` carries the names and sizes
only, for the sharding rules and the analytic byte counts, which need no
process group (JAX's rules take its `AbstractMesh` the same way).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Tuple

# NVIDIA H100 SXM5 (per GPU), from NVIDIA's H100 Tensor Core GPU data
# sheet: dense rates without sparsity, at the 700 W power limit
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 / fp16 tensor cores
PEAK_OPS = {"bf16": 989e12,       # op/s by operand type: tensor cores,
            "fp32": 67e12,        # and fp32 / int32 outside them
            "int32": 67e12}
HBM_BW = 3.35e12                  # bytes/s, HBM3
LINK_BW = 450e9                   # bytes/s each way, NVLink 4 (900 GB/s
#                                   both ways): the data / model axes
POD_LINK_BW = 50e9                # bytes/s each way, a GPU's InfiniBand
#                                   NDR port (400 Gb/s): the pod axis
HBM_BYTES = 80e9                  # 80 GB of HBM3

POD_SHAPE, POD_AXES = (16, 16), ("data", "model")
MULTI_POD_SHAPE, MULTI_POD_AXES = (2, 16, 16), ("pod", "data", "model")


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names without devices or process groups,
    under DeviceMesh's attribute names (`shape`, `mesh_dim_names`)."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def production_shape(multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's shape and names, with no process group."""
    if multi_pod:
        return AbstractMesh(MULTI_POD_SHAPE, MULTI_POD_AXES)
    return AbstractMesh(POD_SHAPE, POD_AXES)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or an AbstractMesh."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _device_mesh(device_type: str, shape: Tuple[int, ...],
                 axes: Tuple[str, ...]):
    """A DeviceMesh of `shape` over the default process group, which must
    hold exactly prod(shape) ranks. On "cuda" the group's backend must be
    NCCL and this host must have a GPU for each of its local ranks."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call "
                           "torch.distributed.init_process_group first")
    want = 1
    for s in shape:
        want *= s
    world = dist.get_world_size()
    if world != want:
        raise ValueError(f"a {shape} mesh needs {want} ranks; the default "
                         f"process group has {world}")
    if device_type == "cuda":
        if dist.get_backend() != "nccl":
            raise RuntimeError(f"a cuda mesh needs the nccl backend, not "
                               f"{dist.get_backend()!r}")
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if local > torch.cuda.device_count():
            raise RuntimeError(f"{local} local ranks but "
                               f"{torch.cuda.device_count()} GPUs")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) pod mesh, or the (2, 16, 16) multi-pod one."""
    m = production_shape(multi_pod)
    return _device_mesh(device_type, m.shape, m.mesh_dim_names)


def make_host_mesh(model_axis: int = 1, device_type: str = "cuda"):
    """A ("data", "model") mesh over the ranks that exist, `model_axis`
    of them on the model axis (tests, the smoke run)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("no default process group: call "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"{n} ranks do not split into a model axis of "
                         f"{model_axis}")
    return _device_mesh(device_type, (n // model_axis, model_axis),
                        POD_AXES)


def link_bw(axes: str) -> float:
    """Bytes/s each way of the link a collective over `axes` (an axis
    name, or names joined by "+") crosses: InfiniBand if it spans the
    pod axis, NVLink inside a pod."""
    return POD_LINK_BW if "pod" in axes.split("+") else LINK_BW


def data_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
