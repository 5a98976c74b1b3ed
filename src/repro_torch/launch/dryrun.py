"""Multi-pod dry run (port of `repro/launch/dryrun.py`): run every
(arch x shape x mesh) cell's step function once on the production mesh,
with nothing allocated, and record its per-device cost for the roofline.

    python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
    python -m repro_torch.launch.dryrun --all              # 33 cells
    python -m repro_torch.launch.dryrun --all --multi-pod  # 512-rank mesh
    python -m repro_torch.launch.dryrun --arch zamba2-2.7b --shape train_4k \
        --host-mesh 2x2 --batch 2 --seq 4096 --remat full    # four cards

Where the JAX package lowers and compiles each cell for 512 fake host
devices, the port
  * starts a fake process group (`torch.testing._internal.distributed.
    fake_pg`: collectives return at once) of 256 or 512 ranks and builds
    the production DeviceMesh on it, device type "cpu" (the kernels'
    wrappers take their plain versions, as on any CPU tensor);
  * makes the full published config's parameters, optimizer state and
    inputs as fake tensors (`FakeTensorMode`: shapes and dtypes, no
    memory), laid out as DTensors by `launch/shardings.py`;
  * runs the step function once, as rank 0, under `cost_mode`, a dispatch
    mode that sees the operators each rank runs on its local shards:
    FLOPs (`torch.utils.flop_counter`'s formulas on the local shapes:
    what a device computes, replicated work counted in full, JAX's
    per-device `flops`), `bytes_accessed` (operand plus result bytes of
    every operator that is not a view: like XLA:CPU's count, an unfused
    upper bound) and the operand bytes of every collective DTensor issues
    (`_c10d_functional.*`), by kind (the counterpart of the HLO parse of
    `collective_bytes`) and, under `collective_axes`, by kind and the
    mesh axis of the collective's group ("all-gather over data",
    "all-reduce over model", ...). The mamba_scan kernel counts as the
    card runs it: one operator, its inputs read and its outputs written
    once (`scan_as_kernel`).

The port runs its layers in a Python loop, not a scan, so the full
config's operators are counted directly: the JAX package's rolled program
and its unrolled 1- and 2-unit probes with linear extrapolation
(`probe_config`, `set_scan_unroll`) have no counterpart, and a record has
no "probe". XLA's memory analysis has its counterpart in the same run:
the four `MEMORY_FIELDS` count the local storages the step's operators
allocate and free (`_fake_cost`), a lower bound on what a card's
allocator holds (no fragmentation, cuBLAS workspaces or NCCL buffers).
`arg_bytes_per_device_analytic` is JAX's formula (each argument leaf's
bytes over the product of the mesh axes its spec names). `--host-mesh
2x2 --batch 2 --seq 4096` models a run on four cards instead.

On the CPU process group DTensor turns a shard-to-shard redistribution
into an all-gather and a local chunk (it has no all-to-all there): such
moves count as all-gathers. The fake group lives inside `run_cell` and
is destroyed after it: importing this module does nothing.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import heapq
import json
import os
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

from repro_torch import tree as tree_lib
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.shapes import (SHAPES, SHAPE_ORDER, ShapeSpec,
                                        applicable)
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import (POD_AXES, AbstractMesh, axis_sizes,
                                     data_axes, production_shape)

OUT_DIR = os.path.join("build", "dryrun")
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")
_FUNCOL_KIND = (("all_gather", "all-gather"), ("reduce_scatter",
                                               "reduce-scatter"),
                ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
                ("permute", "collective-permute"),
                ("broadcast", "broadcast"))
# the functional-collective namespace's operators that move no data
_FUNCOL_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")
MEMORY_FIELDS = ("temp_size_in_bytes", "argument_size_in_bytes",
                 "output_size_in_bytes", "peak_memory_in_bytes")


def _tensor_bytes(x) -> int:
    return x.numel() * x.element_size()


def _tensors(tree) -> List[Any]:
    import torch
    out = []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for x in tree:
            out += _tensors(x)
    return out


def group_axes(mesh) -> Dict[str, str]:
    """{process group name: the mesh axis, or axes joined by "+", that it
    spans} for every dim of `mesh` and for the default group (all axes):
    what `cost_mode` labels a collective's group with."""
    import torch.distributed as dist
    from repro_torch.models.spmd import data_group
    names = tuple(mesh.mesh_dim_names)
    out = {dist.group.WORLD.group_name: "+".join(names)}
    for i, name in enumerate(names):
        out[mesh.get_group(i).group_name] = name
    group = data_group(mesh)[2]
    if group is not None and group.group_name not in out:
        # the data axes flattened (the MoE dispatch's all-to-all)
        out[group.group_name] = "+".join(data_axes(mesh))
    return out


def cost_mode(mesh=None):
    """A dispatch mode over the operators on local tensors: `flops`,
    `bytes_accessed`, collectives (`collective_kinds` operand bytes by
    kind, `collective_ops`, `collective_shapes` [(kind, first operand's
    shape, axis)] in issue order, and `collective_axes` {"<kind> over
    <axis>": {"ops", "bytes"}}, the axis of the collective's group on `mesh`
    (`group_axes`; without a mesh, or for a group of none of its dims, the
    group's name)) and live bytes (`live`, `peak_live`: the bytes of the
    storages that the operators created and that are still referenced,
    and the most of them at once; a storage is counted once, when an
    operator first returns it, and freed when Python lets go of it;
    `peak_largest`: the three largest storages held when the live bytes
    last rose 1 % past the previous such point, with the operator that
    made each, its shape and dtype).
    Operators on DTensors are let through (returning NotImplemented) so
    that DTensor runs them on the local shards, which come back through
    the mode. The operators DTensor's sharding propagation runs on
    whole-shape fake tensors to infer layouts are not counted (`pause`)."""
    import weakref
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry
    axes_of = group_axes(mesh) if mesh is not None else {}

    class _Mode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes_accessed = 0
            self.collective_kinds = {k: 0 for k in COLLECTIVES}
            self.collective_axes: Dict[str, Dict[str, int]] = {}
            self.collective_ops = 0
            self.collective_shapes: List[Tuple[str, list, str]] = []
            self.live = 0
            self.peak_live = 0
            self.peak_largest = []
            self.paused = 0
            self._seen = weakref.WeakSet()
            self._live = {}
            self._snap = 0

        @contextlib.contextmanager
        def pause(self):
            self.paused += 1
            try:
                yield
            finally:
                self.paused -= 1

        def _free(self, key: int, n: int):
            self.live -= n
            self._live.pop(key, None)

        def track(self, out, inputs=(), op: str = ""):
            """Count the storages of `out` that are new to the mode and
            not those of `inputs` (a view, an in-place result); `op` names
            the operator that made them."""
            old = {id(x.untyped_storage()) for x in _tensors(inputs)}
            for x in _tensors(out):
                st = x.untyped_storage()
                if id(st) in old or st in self._seen:
                    continue
                self._seen.add(st)
                n = st.nbytes()
                self.live += n
                self._live[id(st)] = (n, op, list(x.shape), str(x.dtype))
                weakref.finalize(st, self._free, id(st), n)
            if self.live > self.peak_live:
                self.peak_live = self.live
                if self.live > 1.01 * self._snap:
                    # the largest storages held at (within 1 % of) the peak
                    self._snap = self.live
                    self.peak_largest = [
                        dict(bytes=n, op=o, shape=sh, dtype=dt)
                        for n, o, sh, dt in heapq.nlargest(
                            3, self._live.values(), key=lambda v: v[0])]

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            if self.paused:
                return out
            name = func.namespace
            if name == "_c10d_functional":
                op = func.__name__
                if not op.startswith(_FUNCOL_NOT_COLLECTIVES):
                    self.track(out, (args, kwargs), op)
                    kind = next((k for key, k in _FUNCOL_KIND
                                 if key in op), None)
                    if kind is None:
                        raise NotImplementedError(
                            f"collective {func} has no kind")
                    group = kwargs.get("group_name", args[-1])
                    group = getattr(group, "group_name", group)
                    n = sum(_tensor_bytes(x) for x in _tensors(
                        (args, kwargs)))
                    self.collective_ops += 1
                    self.collective_kinds[kind] += n
                    axis = axes_of.get(group, group)
                    self.collective_shapes.append(
                        (kind, list(args[0].shape), axis))
                    rec = self.collective_axes.setdefault(
                        f"{kind} over {axis}", {"ops": 0, "bytes": 0})
                    rec["ops"] += 1
                    rec["bytes"] += n
                return out
            self.track(out, (args, kwargs), func.__name__)
            packet = func._overloadpacket
            if packet in flop_registry:
                self.flops += int(flop_registry[packet](
                    *args, **kwargs, out_val=out))
            if not func.is_view and isinstance(
                    func, torch._ops.OpOverload):
                self.bytes_accessed += sum(
                    _tensor_bytes(x) for x in _tensors(
                        (args, kwargs, out)))
            return out
    return _Mode()


@contextlib.contextmanager
def counting(mode):
    """`mode` entered, with DTensor's layout inference not counted."""
    from unittest import mock
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    real = ShardingPropagator._propagate_tensor_meta_non_cached

    def meta(self, op_schema):
        with mode.pause():
            return real(self, op_schema)
    with mock.patch.object(ShardingPropagator,
                           "_propagate_tensor_meta_non_cached", meta), mode:
        yield mode


@contextlib.contextmanager
def scan_as_kernel(mode):
    """The mamba_scan kernel and its backward run as the card runs them:
    one operator each, reading its inputs once and writing its outputs
    once (`mode` counts those bytes), with fake outputs of the kernel's
    shapes. On the CPU device type the wrappers would take their plain
    versions, a Python loop over the sequence (32768 steps a layer at
    prefill_32k), which is neither what the card runs nor fast to fake."""
    import torch
    from unittest import mock
    from repro_torch.kernels import ops

    def count(ins, outs):
        mode.bytes_accessed += sum(_tensor_bytes(x) for x in ins + outs)
        mode.track(outs)
        return outs

    def fwd(a, b, h0):
        with mode.pause():
            outs = (torch.empty(a.shape, dtype=torch.float32),
                    torch.empty(h0.shape, dtype=torch.float32))
        return count((a, b, h0), outs)

    def bwd(a, h0, h_all, dh_all, dh_last):
        with mode.pause():
            outs = (torch.empty(a.shape, dtype=a.dtype),
                    torch.empty(a.shape, dtype=a.dtype),
                    torch.empty(h0.shape, dtype=torch.float32))
        return count((a, h0, h_all, dh_all, dh_last), outs)
    with mock.patch.object(ops, "_mamba_scan_fwd", fwd), \
            mock.patch.object(ops, "mamba_scan_bwd", bwd):
        yield


def _shape(shape) -> ShapeSpec:
    """A shape's name (`SHAPES`) or a ShapeSpec, as a ShapeSpec."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def build_step(model, shape, mesh, variant: str = ""):
    """Returns (fn, arg_specs tuple, spec trees tuple): the step function
    of the shape's mode (`shape` a name or a ShapeSpec), its arguments as
    "meta" trees, and their specs on `mesh` (an AbstractMesh will do)."""
    from repro_torch.optim import adamw
    cfg = model.cfg
    spec = _shape(shape)
    params_shape = model.param_specs()
    p_sh = sh.param_shardings(mesh, params_shape, variant)

    if spec.mode == "train":
        import torch
        opt_shape = adamw.adamw_init(params_shape)
        o_sh = sh.opt_shardings(mesh, opt_shape, p_sh, params_shape,
                                variant)
        batch_shape = model.input_specs(spec)
        b_sh = sh.batch_shardings(mesh, batch_shape)
        opt_cfg = adamw.AdamWConfig()

        def train_step(params, opt_state, batch):
            leaves = tree_lib.leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            loss = model.loss(params, batch)[0]
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
            for p in leaves:
                p.requires_grad_(False)
            with torch.no_grad():
                params, opt_state, _ = adamw.adamw_update(
                    opt_cfg, params, tree_lib.unflatten(params, list(grads)),
                    opt_state)
            return params, opt_state, loss.detach()
        return train_step, (params_shape, opt_shape, batch_shape), \
            (p_sh, o_sh, b_sh)

    if spec.mode == "prefill":
        batch_shape = model.input_specs(spec)
        b_sh = sh.batch_shardings(mesh, batch_shape)

        def prefill_step(params, batch):
            return model.prefill(params, batch)
        return prefill_step, (params_shape, batch_shape), (p_sh, b_sh)

    # decode: one new token against a seq_len KV cache
    batch_shape = model.input_specs(spec)
    state_shape = batch_shape.pop("state")
    s_sh = sh.decode_state_shardings(mesh, state_shape, cfg, variant)
    b_sh = sh.batch_shardings(mesh, batch_shape)

    def serve_step(params, state, batch):
        return model.decode_step(params, state, batch["tokens"])
    return serve_step, (params_shape, state_shape, batch_shape), \
        (p_sh, s_sh, b_sh)


def n_units_of(cfg) -> int:
    """Repeating units: layers, zamba groups, or enc+dec layer pairs."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every
    return cfg.num_layers   # enc-dec: num_layers == num_encoder_layers


def spec_pairs(tree: Any, specs: Any) -> List[Tuple[Any, Any]]:
    """(leaf, spec) of every leaf of `tree`, in leaf order."""
    out: List[Tuple[Any, Any]] = []
    sh._map2(lambda t, s: out.append((t, s)), tree, specs)
    return out


def gathered_bytes_analytic(params, mesh) -> int:
    """Local bytes of the weights that `spmd.gather_weights` gathers over
    the data axes (each leaf whose placements by the sharding rules it
    changes, its bytes over the mesh dims sharding it): a prefill's
    all-gathers over "data" when each weight is gathered once."""
    from repro_torch.models.spmd import gathered_placements
    sizes = axis_sizes(mesh)
    total = 0
    for leaf, spec in spec_pairs(params, sh.param_shardings(mesh, params)):
        place = sh.placements(mesh, spec)
        if gathered_placements(mesh, place) == place:
            continue
        n = leaf.numel() * leaf.element_size()
        for name, p in zip(mesh.mesh_dim_names, place):
            n //= sizes[name] if p.is_shard() else 1
        total += n
    return total


def arg_bytes_analytic(arg_shapes, arg_specs, mesh) -> float:
    """Per-device argument bytes: each tensor leaf's bytes over the
    product of the mesh axes its spec names (JAX's formula)."""
    import torch
    sizes = axis_sizes(mesh)
    total = 0.0
    for tree, specs in zip(arg_shapes, arg_specs):
        for leaf, spec in spec_pairs(tree, specs):
            if not isinstance(leaf, torch.Tensor):
                continue     # the decode state's "pos", a Python int
            denom = 1
            for entry in spec or ():
                if entry is None:
                    continue
                for ax in ((entry,) if isinstance(entry, str) else entry):
                    denom *= sizes.get(ax, 1)
            total += leaf.numel() * leaf.element_size() / denom
    return total


def _hints(variant: str):
    """The MoE activation hints of the "moe_hints" variant."""
    if variant == "moe_hints":
        return {"dispatch": sh.P(None, "data", None),
                "hidden": sh.P(None, "data", "model")}
    return None


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake default process group of `world_size` ranks (this process
    is rank 0), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under `tree` (a DTensor's local
    shard's), what its tensors hold on one device."""
    from torch.distributed.tensor import DTensor
    seen = {}
    for x in _tensors(tree):
        if isinstance(x, DTensor):
            x = x.to_local()
        st = x.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _fake_cost(model, shape, mesh, variant: str) -> Dict:
    """Run the cell's step once on fake DTensors; its CostMode counts, and
    the memory fields: `argument_size_in_bytes` (the arguments' local
    shards), `output_size_in_bytes` (the result's local tensors, an
    argument updated in place included), `temp_size_in_bytes` (the most
    bytes that the step's operators allocated and still held at once:
    intermediates, gathered weights, saved activations, outputs) and
    `peak_memory_in_bytes` (their sum with the arguments). Counted on the
    local storages the operators return (`cost_mode`'s live bytes), as a
    caching allocator would see them with no fragmentation, no
    workspaces and no communication buffers."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import moe as moe_lib
    fn, arg_shapes, arg_specs = build_step(model, shape, mesh, variant)

    def fake(leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return torch.empty(leaf.shape, dtype=leaf.dtype)
    moe_lib.set_sharding_hints(_hints(variant))
    try:
        with FakeTensorMode(), implicit_replication():
            args = [sh.distribute(tree_lib.map_leaves(fake, tree), mesh,
                                  specs, src_data_rank=None)
                    for tree, specs in zip(arg_shapes, arg_specs)]
            arg_bytes = storage_bytes(args)
            with counting(cost_mode(mesh)) as cost, scan_as_kernel(cost):
                out = fn(*args)
                out_bytes = storage_bytes(out)
                del out
    finally:
        moe_lib.set_sharding_hints(None)
    return dict(flops=float(cost.flops),
                bytes_accessed=float(cost.bytes_accessed),
                collective_bytes=float(sum(cost.collective_kinds.values())),
                collective_ops=cost.collective_ops,
                collective_kinds={k: float(v) for k, v in
                                  cost.collective_kinds.items()},
                collective_axes=cost.collective_axes,
                temp_size_in_bytes=cost.peak_live,
                peak_largest=cost.peak_largest,
                argument_size_in_bytes=arg_bytes,
                output_size_in_bytes=out_bytes,
                peak_memory_in_bytes=arg_bytes + cost.peak_live)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             remat: str = "dots", out_dir: str = OUT_DIR,
             variant: str = "", expert_gather: bool = False,
             kv_bits: int = 16, cfg=None,
             host_mesh: Optional[Tuple[int, int]] = None,
             batch: Optional[int] = None, seq: Optional[int] = None
             ) -> Dict:
    """One (arch x shape x mesh) cell: the record, also written to
    out_dir/<cell>.json. `cfg` replaces the published config (tests cut
    its depth). `host_mesh` (data, model) replaces the production mesh
    (e.g. the four cards' (2, 2)), and `batch` / `seq` the shape's global
    batch and sequence length: the model of a run on cards one can hold
    against it. Raises if the step fails."""
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.models.model import Model
    cfg = cfg or get_config(arch)
    if expert_gather or kv_bits != 16:
        cfg = dataclasses.replace(cfg, hades=dataclasses.replace(
            cfg.hades, expert_gather_decode=expert_gather,
            kv_quant_bits=kv_bits))
    ok, why = applicable(cfg, shape_name)
    spec = SHAPES[shape_name]
    if batch or seq:
        b, s = batch or spec.global_batch, seq or spec.seq_len
        spec = ShapeSpec(f"{shape_name}_b{b}_s{s}", s, b, spec.mode)
    if host_mesh:
        abstract = AbstractMesh(tuple(host_mesh), POD_AXES)
        mesh_name = "host{}x{}".format(*host_mesh)
    else:
        abstract = production_shape(multi_pod)
        mesh_name = "pod512" if multi_pod else "pod256"
    tag = f"_{variant}" if variant else ""
    tag += "_eg" if expert_gather else ""
    tag += f"_kv{kv_bits}" if kv_bits != 16 else ""
    cell = f"{arch}_{spec.name}_{mesh_name}{tag}"
    if not ok:
        print(f"[skip] {cell}: {why}")
        return {"cell": cell, "skipped": why}
    t0 = time.time()
    mode = spec.mode
    model = Model(cfg, attn_impl="blockwise",
                  remat=remat if mode == "train" else "none", device="cpu")
    _, arg_shapes, arg_specs = build_step(model, spec, abstract, variant)
    arg_analytic = arg_bytes_analytic(arg_shapes, arg_specs, abstract)
    with fake_group(abstract.size):
        mesh = make_host_mesh(host_mesh[1], "cpu") if host_mesh else \
            make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        group_axes(mesh)      # makes any flattened group outside fake mode
        cost = _fake_cost(model, spec, mesh, variant)
    result = {
        "cell": cell, "arch": arch, "shape": shape_name,
        "mesh": list(abstract.shape),
        "mesh_axes": list(abstract.mesh_dim_names), "chips": abstract.size,
        "variant": variant, "expert_gather": expert_gather,
        "kv_bits": kv_bits, "mode": mode, "remat": model.remat,
        "global_batch": spec.global_batch, "seq_len": spec.seq_len,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "tokens": spec.global_batch * (spec.seq_len if mode != "decode"
                                       else 1),
        "arg_bytes_per_device_analytic": arg_analytic,
        "n_units": n_units_of(cfg), **cost,
        "run_s": round(time.time() - t0, 1),
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell + ".json"), "w") as f:
        json.dump(result, f, indent=1)
    print(f"[ok] {cell}: {result['run_s']}s, args "
          f"~{arg_analytic / 2 ** 30:.2f} GiB/dev, peak "
          f"{result['peak_memory_in_bytes'] / 2 ** 30:.2f} GiB/dev, flops "
          f"{result['flops']:.3e}, bytes {result['bytes_accessed']:.3e}, "
          f"coll {result['collective_bytes']:.3e}", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--variant", default="")
    ap.add_argument("--expert-gather", action="store_true")
    ap.add_argument("--kv-bits", type=int, default=16)
    ap.add_argument("--host-mesh", default=None, metavar="DxM",
                    help="a (data, model) mesh of D x M ranks in place of "
                    "the production one, e.g. 2x2 for four cards")
    ap.add_argument("--batch", type=int, default=None,
                    help="the shape's global batch in place of its own")
    ap.add_argument("--seq", type=int, default=None,
                    help="the shape's sequence length in place of its own")
    args = ap.parse_args(argv)
    host = tuple(int(x) for x in args.host_mesh.split("x")) \
        if args.host_mesh else None

    archs = list_archs() if (args.all or args.arch is None) \
        else [args.arch]
    shapes = SHAPE_ORDER if (args.all or args.shape is None) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    for mp in meshes:
        for arch in archs:
            for shp in shapes:
                try:
                    run_cell(arch, shp, multi_pod=mp, remat=args.remat,
                             out_dir=args.out, variant=args.variant,
                             expert_gather=args.expert_gather,
                             kv_bits=args.kv_bits, host_mesh=host,
                             batch=args.batch, seq=args.seq)
                except Exception as e:  # noqa: BLE001 -- counted, exit 1
                    failures.append((arch, shp, mp, repr(e)))
                    print(f"[FAIL] {arch} {shp} multi_pod={mp}: {e}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nall cells ran.")


if __name__ == "__main__":
    main()
