"""FSDP x TP in the port (`repro_torch.models.spmd.gather_weights`): each
layer's weights gathered over the data axes where the layer starts, their
"model" shards kept, as the sharding rules define the scheme ("2-D weight
sharding = FSDP over "data" x TP over "model"", `repro/launch/
shardings.py`).

  * The placements: for every architecture, mesh and variant, a leaf's
    gathered placements are JAX's spec with the data axes dropped from
    every entry that does not also name "model".
  * The counts: on a fake 256-rank group under FakeTensorMode
    (`dryrun.run_cell`), a 2-layer glm4-9b prefill gathers exactly the
    local bytes of its data-sharded weights over "data", all-reduces
    nothing over the data axes, and all-reduces over "model" twice a
    layer (the TP sums) and once for the vocab-parallel lookup, each at
    the local activation's bytes; its train step reduce-scatters the
    weights' gradients over "data".
  * The reference: the JAX package's layer, compiled on a (2, 2) mesh of
    four fake host devices (in a subprocess whose environment alone sets
    XLA_FLAGS) with its input and output in the batch layout (the layout
    the port pins with `spmd.constrain`), all-gathers exactly the weights
    the port gathers, at the same gathered shapes, and all-reduces twice
    over "model". (JAX's whole-model program has no such constraint:
    XLA then carries the embedding's "data"-sharded hidden dim into the
    residual stream and gathers no weight, all-reducing activations
    instead, as found at qwen2-vl-72b's and glm4-9b's widths.)
  * Four gloo ranks on the (2, 2) mesh: a train step of reduced glm4-9b
    and of reduced zamba2-2.7b in fp32, gradients and updated params
    against the one-process plain step, every gradient laid out as its
    AdamW state.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
import torch.distributed as dist  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.launch.mesh import production_shape  # noqa: E402
from repro_torch.models import spmd  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

MESHES = {"pod256": (production_shape(False),
                     JAbstractMesh((16, 16), ("data", "model"))),
          "pod512": (production_shape(True),
                     JAbstractMesh((2, 16, 16), ("pod", "data", "model")))}
VARIANTS = ("", "moe_zero", "serve_tp")
DATA = ("pod", "data")
WORLD = 4
GRAD_TOL = 1e-5     # of the plain step's largest |gradient| / |param|
LEAF_TOL = 1e-4     # of each gradient leaf's own largest magnitude


def _jax_path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


@pytest.fixture(scope="module")
def trees():
    """(port params shape, JAX params shape by path) of every arch."""
    out = {}
    for a in list_archs():
        jleaves = {}
        jax.tree_util.tree_map_with_path(
            lambda p, x: jleaves.__setitem__(_jax_path(p), x),
            JModel(jget_config(a)).param_specs())
        out[a] = (Model(get_config(a), device="cpu").param_specs(), jleaves)
    return out


def _drop_data(entry):
    """A spec entry without its data axes, unless it also names "model"
    (a dim split over ("data", "model") together stays)."""
    if entry is None:
        return None
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    if "model" in axes and len(axes) > 1:
        return entry
    kept = tuple(a for a in axes if a not in DATA)
    return kept[0] if len(kept) == 1 else (kept or None)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", list_archs())
def test_gathered_placements_are_jax_spec_without_data(trees, arch, variant,
                                                       mesh_name):
    mesh, jmesh = MESHES[mesh_name]
    params, jleaves = trees[arch]
    gathered = 0
    for name, leaf in zip(*tree_lib.flatten_with_paths(params)):
        parts = name.split("/")
        jpath = "/".join(p for p in parts if not p.isdigit())
        k = len(parts) - len(jpath.split("/"))
        jspec = tuple(jsh.param_spec(jmesh, jpath, jleaves[jpath].shape,
                                     variant))[k:]
        place = sh.placements(mesh, sh.param_spec(mesh, name,
                                                  tuple(leaf.shape),
                                                  variant))
        got = spmd.gathered_placements(mesh, place)
        assert got == sh.placements(mesh, tuple(_drop_data(e)
                                                for e in jspec)), name
        gathered += got != place
    if variant == "serve_tp":
        assert gathered == 0          # TP over ("data", "model"): no FSDP
    else:
        assert gathered > 0


def test_gathered_placements_raise_on_partial():
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = production_shape(False)
    assert spmd.gathered_placements(mesh, (Shard(0), Shard(1))) == \
        (Replicate(), Shard(1))
    assert spmd.gathered_placements(mesh, (Shard(1), Shard(1))) == \
        (Shard(1), Shard(1))
    with pytest.raises(ValueError, match="Partial"):
        spmd.gathered_placements(mesh, (Partial(), Shard(1)))


@pytest.fixture
def world1():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_gather_weights_is_the_identity_without_data_shards(world1):
    """Plain tensors, and DTensors on a (1, 1) mesh, come back as the same
    objects."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, "cpu")
    w = torch.randn(8, 4)
    d = sh.distribute_leaf(w, mesh, sh.P("data", "model"))
    tree = {"w": w, "layers": [{"d": d}]}
    out = spmd.gather_weights(tree)
    assert out["w"] is w and out["layers"][0]["d"] is d


def _cell(shape, tmp_path, remat="dots"):
    cfg = dataclasses.replace(get_config("glm4-9b"), num_layers=2)
    rec = dr.run_cell("glm4-9b", shape, multi_pod=False, remat=remat,
                      out_dir=str(tmp_path), cfg=cfg)
    mesh = production_shape(False)
    params = Model(cfg, device="cpu").param_specs()
    return cfg, rec, dr.gathered_bytes_analytic(params, mesh)


def _axes(rec, label):
    return rec["collective_axes"].get(label, {"ops": 0, "bytes": 0})


def test_prefill_gathers_the_weights_and_sums_over_model(tmp_path):
    """glm4-9b at 2 layers x prefill_32k on the fake (16, 16) mesh."""
    cfg, rec, gathered = _cell("prefill_32k", tmp_path)
    assert _axes(rec, "all-gather over data")["bytes"] == gathered
    assert not any(k.startswith("all-reduce over") and "data" in k
                   for k in rec["collective_axes"])
    local = 32 // 16 * 32768 * cfg.d_model * 2         # [B/16, S, D] bf16
    sums = 2 * cfg.num_layers + 1
    assert _axes(rec, "all-reduce over model") == \
        {"ops": sums, "bytes": sums * local}
    # GQA: k and v [B/16, S, KV * Dh / 16] gathered on "model" for their
    # 2 heads (`spmd.split_heads`), not weights
    kv = 32 // 16 * 32768 * cfg.num_kv_heads * cfg.head_dim // 16 * 2
    assert _axes(rec, "all-gather over model") == \
        {"ops": 2 * cfg.num_layers, "bytes": 2 * cfg.num_layers * kv}
    assert sum(c["bytes"] for c in rec["collective_axes"].values()) == \
        rec["collective_bytes"]


def test_train_step_reduce_scatters_the_weight_gradients(tmp_path):
    """glm4-9b at 2 layers x train_4k, remat "full": the layers' weights
    are gathered twice (forward and recompute), the head's and the
    embedding's once, and every data-sharded weight's gradient (bf16, in
    the gathered layout: 16 of its shards) is reduce-scattered over
    "data"; the only all-reduces over "data" are the replicated leaves'
    gradients (the norm scales, fp32) and scalars."""
    cfg, rec, gathered = _cell("train_4k", tmp_path, remat="full")
    mesh = production_shape(False)
    params = Model(cfg, device="cpu").param_specs()
    top = {k: v for k, v in params.items() if k != "layers"}
    top_bytes = dr.gathered_bytes_analytic(top, mesh)
    assert _axes(rec, "all-gather over data")["bytes"] == \
        2 * gathered - top_bytes
    assert _axes(rec, "reduce-scatter over data")["bytes"] == 16 * gathered
    replicated = sum(x.numel() * 4 for n, x in zip(
        *tree_lib.flatten_with_paths(params)) if n.split("/")[-1] in
        ("ln1", "ln2", "final_ln"))
    assert 0 < _axes(rec, "all-reduce over data")["bytes"] - replicated \
        < 1024


_JAX_LAYER = r"""
import json, re
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch import shardings as sh
from repro.models import transformer as T
mesh = jax.make_mesh((2, 2), ("data", "model"))
cfg = get_config("glm4-9b", reduced=True)
lp = jax.eval_shape(lambda k: T.init_attn_layer(k, cfg, jnp.dtype(cfg.dtype)),
                    jax.random.PRNGKey(0))
path = lambda p: "/".join(str(getattr(k, "key", k)) for k in p)
lsh = jax.tree_util.tree_map_with_path(lambda p, x: NamedSharding(
    mesh, sh.param_spec(mesh, "layers/" + path(p), x.shape)), lp)
batch = NamedSharding(mesh, P("data"))
x = jax.ShapeDtypeStruct((2, 64, cfg.d_model), jnp.dtype(cfg.dtype))
pos = jax.ShapeDtypeStruct((2, 64), jnp.int32)
f = jax.jit(lambda p, x, pos: T.attn_ffn_block(p, x, cfg, pos)[0],
            in_shardings=(lsh, batch, batch), out_shardings=batch)
hlo = f.lower(lp, x, pos).compile().as_text()
out = []
for line in hlo.splitlines():
    m = re.search(r"=\s*\w+\[([\d,]*)\]\S*\s+(all-gather|all-reduce|"
                  r"reduce-scatter|all-to-all)(?:-start)?\(.*?"
                  r"replica_groups=(.*?), ", line)
    if m:
        out.append([m.group(2), [int(d) for d in m.group(1).split(",")],
                    m.group(3)])
print(json.dumps(out))
"""


def test_jax_layer_gathers_what_the_port_gathers():
    """The JAX package's attention + FFN layer of reduced glm4-9b on a
    (2, 2) ("data", "model") mesh of four fake host devices, its input
    and output [B, S, D] batch-sharded over "data": one all-gather for
    each data-sharded weight, its result the weight gathered over
    "data" (the port's gathered local shape), and two all-reduces over
    "model", the TP sums ({0, 1}, {2, 3}: iota [2, 2] groups)."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
               "count=4", JAX_PLATFORMS="cpu")
    got = json.loads(subprocess.run(
        [sys.executable, "-c", _JAX_LAYER], env=env, check=True,
        capture_output=True, text=True, timeout=120).stdout)
    from repro_torch.launch.mesh import AbstractMesh
    mesh = AbstractMesh((2, 2), ("data", "model"))
    cfg = get_config("glm4-9b", reduced=True)
    layer = Model(cfg, device="cpu").param_specs()["layers"][0]
    want = []
    for name, leaf in zip(*tree_lib.flatten_with_paths(layer)):
        place = sh.placements(mesh, sh.param_spec(
            mesh, "layers/0/" + name, tuple(leaf.shape)))
        gathered = spmd.gathered_placements(mesh, place)
        if gathered != place:
            shape = list(leaf.shape)
            for size, p in zip(mesh.shape, gathered):
                if p.is_shard():
                    shape[p.dim] //= size
            want.append(shape)
    gathers = sorted(s for kind, s, _ in got if kind == "all-gather")
    assert len(want) == 7 and gathers == sorted(want)
    sums = [g for kind, _, g in got if kind == "all-reduce"]
    assert sums == ["[2,2]<=[4]"] * 2
    assert {kind for kind, _, _ in got} == {"all-gather", "all-reduce"}


def _train_case(mesh, arch, b=2, s=32):
    """One fp32 Trainer step (`loss_and_grads`, then `adamw_update`) of the
    reduced `arch` on plain tensors and on DTensors laid out by the
    sharding rules: (worst gradient error over the largest |gradient|,
    worst param error over the largest |param|, worst gradient error over
    its leaf's largest |gradient|, gradients not laid out as AdamW's
    state by `opt_shardings`). Params are not held leaf by leaf: AdamW's
    first step moves an element by lr * g / (|g| + eps), so where g is
    near zero rounding moves it by up to 2 lr, all of a zero-initialised
    leaf's (a norm scale's) magnitude."""
    import tempfile
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.data.lm import DataConfig
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    model = Model(cfg, attn_impl="blockwise", remat="full", device="cpu")
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(model, DataConfig(cfg.vocab_size, s, b, seed=0),
                     adamw.AdamWConfig(warmup_steps=5),
                     TrainerConfig(ckpt_dir=d))
    plain = model.init(torch.Generator().manual_seed(0))
    dparams = sh.distribute(tree_lib.map_leaves(torch.clone, plain), mesh,
                            sh.param_shardings(mesh, plain),
                            src_data_rank=None)
    batch = tr.data.batch_at(0)
    _, grads = tr.loss_and_grads(plain, batch)
    adamw.adamw_update(tr.opt_cfg, plain, grads, adamw.adamw_init(plain))
    with implicit_replication():
        _, dgrads = tr.loss_and_grads(dparams, sh.distribute(
            batch, mesh, sh.batch_shardings(mesh, batch),
            src_data_rank=None))
        adamw.adamw_update(tr.opt_cfg, dparams, dgrads,
                           adamw.adamw_init(dparams))
    o_sh = sh.opt_shardings(mesh, None, sh.param_shardings(mesh, plain))
    names = tree_lib.flatten_with_paths(plain)[0]
    misplaced = [n for n, (g, spec) in zip(names, dr.spec_pairs(
        dgrads, o_sh["m"])) if tuple(g.placements) != sh.placements(mesh,
                                                                     spec)]
    errs = []
    for ref, got in ((grads, dgrads), (plain, dparams)):
        pairs = [(r, g.full_tensor()) for r, g in
                 zip(tree_lib.leaves(ref), tree_lib.leaves(got))]
        top = max(r.abs().max().item() for r, _ in pairs)
        errs.append(max((g - r).abs().max().item() for r, g in pairs)
                    / top)
        errs.append(max((g - r).abs().max().item()
                        / max(r.abs().max().item(), 1e-30)
                        for r, g in pairs))
    return errs[0], errs[2], errs[1], misplaced


def _worker(rank, path):
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=WORLD)
    try:
        mesh = make_host_mesh(2, "cpu")
        for arch in ("glm4-9b", "zamba2-2.7b"):
            g, p, leaf, misplaced = _train_case(mesh, arch)
            assert not misplaced, (arch, misplaced)
            assert g <= GRAD_TOL and p <= GRAD_TOL, (arch, g, p)
            assert leaf <= LEAF_TOL, (arch, leaf)
    finally:
        dist.destroy_process_group()


def test_four_ranks_train_step_equals_the_plain_step(tmp_path):
    """4 gloo processes, the (2, 2) ("data", "model") mesh: one fp32 train
    step of reduced glm4-9b (dense) and of reduced zamba2-2.7b (mamba2
    blocks and the shared attention block) with FSDP x TP, against the
    same step of the plain params in each process: every gradient and
    updated param within 1e-5 of the plain step's largest |gradient| /
    |param|, each gradient within 1e-4 of its own leaf's largest; every
    gradient in its leaf's placements (`opt_shardings`: the weights'
    gradients reduce-scattered over "data", the replicated leaves'
    all-reduced)."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_worker, args=(str(tmp_path / "rdv"),),
                             nprocs=WORLD, join=False,
                             start_method="spawn")
    t0 = time.time()
    try:
        while not ctx.join(timeout=5):
            assert time.time() - t0 < 240, "the 4-rank run timed out"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in ctx.processes)
