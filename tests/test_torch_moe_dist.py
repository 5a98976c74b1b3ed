"""The MoE block on DTensors with its dispatch partitioned
(`repro_torch.models.moe._moe_block_sharded`), held against the plain
block and the JAX package's `moe_block`:

  * The reference: JAX's block of reduced olmoe-1b-7b, compiled on a
    (2, 2) ("data", "model") mesh of four fake host devices with the
    rules' layout (in a subprocess whose environment alone sets
    XLA_FLAGS), all-gathers over "data" only the routing, the gates
    [T, E] fp32 and the expert ids [T*k] s32; no [T, D] or [E, G, D].
  * Four gloo ranks on the (2, 2) mesh, fp32, at reduced olmoe-1b-7b and
    mixtral-8x7b (the experts split over "model"), at mixtral with 3
    experts (the experts' hidden dim split over "model" instead) and at
    olmoe with capacity drops: the counts, the kept mask and the sorted
    order bit for bit the plain block's and JAX's, the aux loss bit for
    bit the plain block's (within 1e-6 of JAX's, as for the plain), the
    output within 1e-5 of the largest |output|, the gradients of the
    input and the weights likewise, and no collective of a [T, D] or
    [E, G, D] tensor; with the "moe_hints" activation hints too.
  * One fp32 train step of reduced olmoe-1b-7b on the four ranks, against
    the plain step, built and held as `test_torch_fsdp`'s.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
import torch.distributed as dist  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

WORLD = 4
B, S = 4, 50                         # T = 200 tokens, 50 a data rank
TOL = 1e-5                           # of the largest |output| / |gradient|
# (case, arch, experts (None: the config's), capacity factor, hints)
CASES = [("olmoe", "olmoe-1b-7b", None, 1.25, False),
         ("mixtral", "mixtral-8x7b", None, 1.25, False),
         ("mixtral_ffn", "mixtral-8x7b", 3, 1.25, False),
         ("olmoe_drops", "olmoe-1b-7b", None, 0.8, False),
         ("olmoe_hints", "olmoe-1b-7b", None, 1.25, True),
         ("mixtral_ffn_hints", "mixtral-8x7b", 3, 1.25, True)]
NAMES = [c[0] for c in CASES]


def _cfgs(arch, experts):
    jc, tc = jget_config(arch, reduced=True), get_config(arch, reduced=True)
    if experts:
        jc = dataclasses.replace(jc, num_experts=experts)
        tc = dataclasses.replace(tc, num_experts=experts)
    return jc, tc


def _inputs(tc):
    rng = np.random.default_rng(0)
    d, e = tc.d_model, tc.num_experts
    f = tc.moe_d_ff or tc.d_ff
    return dict(x=rng.normal(size=(B, S, d)).astype(np.float32),
                router=(rng.normal(size=(d, e)) * d ** -0.5)
                .astype(np.float32),
                wi=(rng.normal(size=(e, d, f)) * d ** -0.5).astype(np.float32),
                wg=(rng.normal(size=(e, d, f)) * d ** -0.5).astype(np.float32),
                wo=(rng.normal(size=(e, f, d)) * f ** -0.5).astype(np.float32))


def _jax_routing(jc, arrays, cf):
    """JAX's `moe_block` (out, aux, counts) and its dispatch bookkeeping
    (the sorted order and the kept mask), the latter by the block's own
    lines (`repro/models/moe.py:83-111`) in JAX."""
    p = {k: jnp.asarray(arrays[k]) for k in ("router", "wi", "wg", "wo")}
    x = jnp.asarray(arrays["x"])
    out, aux, counts = jmoe.moe_block(p, x, jc, capacity_factor=cf)
    k, t = jc.experts_per_token, B * S
    gates = jax.nn.softmax(jnp.einsum("td,de->te", x.reshape(t, -1),
                                      p["router"]), axis=-1)
    _, topk_e = jax.lax.top_k(gates, k)
    flat_e = topk_e.reshape(t * k)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(counts)[:-1]])
    rank = jnp.arange(t * k, dtype=jnp.int32) - starts[se]
    keep = rank < jmoe.capacity(t, jc, cf)
    return dict(out=np.asarray(out), aux=np.asarray(aux),
                counts=np.asarray(counts), order=np.asarray(order),
                keep=np.asarray(keep))


class _Recorder:
    """A CommDebugMode that also keeps every collective's operand shape."""

    def __new__(cls):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.debug import CommDebugMode

        class Mode(CommDebugMode):
            def __init__(self):
                super().__init__()
                self.shapes = []

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if not any(t == DTensor for t in types) and \
                        getattr(func, "namespace", "") == "_c10d_functional" \
                        and not func.__name__.startswith(
                            ("wait_tensor", "_wrap_tensor_autograd")):
                    self.shapes.append([func.__name__.split(".")[0],
                                        list(args[0].shape)])
                return super().__torch_dispatch__(func, types, args, kwargs)
        return Mode()


def _slots_recorded(record):
    """`moe._slots` recording (order, keep) of each call."""
    real = tmoe._slots

    def slots(*a):
        out = real(*a)
        record.append((out[1].numpy().copy(), out[6].numpy().copy()))
        return out
    return mock.patch.object(tmoe, "_slots", slots)


def _grads(p, x, cot, rec, tc, cf, wrt):
    """The block's (out, aux, counts) and the gradients of sum(out * cot)
    + aux with respect to `wrt`, (order, keep) recorded."""
    with _slots_recorded(rec):
        out, aux, counts = tmoe.moe_block(p, x, tc, capacity_factor=cf)
    return out, aux, counts, torch.autograd.grad((out * cot).sum() + aux,
                                                 wrt)


def _block_case(mesh, arch, experts, cf, hinted):
    """The block of `arch` (reduced, fp32) on these inputs, plain and on
    DTensors laid out by the rules (the weights FSDP-gathered as a
    layer's body gathers them): outputs, aux, counts, (order, keep) of
    each path, the gradients of x and of the weights' leaves, and the
    sharded forward's and backward's collectives."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import dryrun
    from repro_torch.launch import shardings as sh
    from repro_torch.models import spmd
    _, tc = _cfgs(arch, experts)
    arrays = _inputs(tc)
    cot = torch.from_numpy(np.random.default_rng(1).normal(
        size=(B, S, tc.d_model)).astype(np.float32))
    names = ("router", "wi", "wg", "wo")
    prec, drec = [], []
    plain = {k: torch.from_numpy(arrays[k]).requires_grad_(True)
             for k in names}
    x = torch.from_numpy(arrays["x"]).requires_grad_(True)
    out, aux, counts, grads = _grads(plain, x, cot, prec, tc, cf,
                                     [x] + [plain[k] for k in names])
    leaves = {k: torch.from_numpy(arrays[k]) for k in names}
    dp = sh.distribute(leaves, mesh, sh._with_paths(
        lambda path, leaf: sh.param_spec(mesh, "layers/0/moe/" + path,
                                         tuple(leaf.shape)), leaves),
        src_data_rank=None)
    for v in dp.values():
        v.requires_grad_(True)

    def batch(a):
        return sh.distribute_leaf(a, mesh, sh.P("data"), src_data_rank=None)
    dx = batch(torch.from_numpy(arrays["x"])).requires_grad_(True)
    tmoe.set_sharding_hints(dryrun._hints("moe_hints") if hinted else None)
    try:
        with implicit_replication():
            gathered = spmd.gather_weights(dp)
        with implicit_replication(), _Recorder() as comm:
            dout, daux, dcounts, dgrads = _grads(
                gathered, dx, batch(cot), drec, tc, cf,
                [dx] + [dp[k] for k in names])
            split = tmoe._expert_split(gathered["wi"], mesh)
    finally:
        tmoe.set_sharding_hints(None)
    return dict(
        out=out.detach().numpy(), dout=dout.detach().full_tensor().numpy(),
        aux=aux.detach().numpy(), daux=daux.detach().full_tensor().numpy(),
        counts=counts.numpy(), dcounts=dcounts.full_tensor().numpy(),
        order=prec[0][0], dorder=drec[0][0], keep=prec[0][1],
        dkeep=drec[0][1],
        **{f"g_{k}": g.numpy() for k, g in zip(("x",) + names, grads)},
        **{f"dg_{k}": g.full_tensor().numpy()
           for k, g in zip(("x",) + names, dgrads)},
        shapes=comm.shapes, split=split, g=tmoe.capacity(B * S, tc, cf))


def _worker(rank, path, out):
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=WORLD)
    try:
        mesh = make_host_mesh(2, "cpu")
        res, arrays = {}, {}
        for name, arch, experts, cf, hinted in CASES:
            got = _block_case(mesh, arch, experts, cf, hinted)
            res[name] = {k: v for k, v in got.items()
                         if not isinstance(v, np.ndarray)}
            arrays.update({f"{name}/{k}": v for k, v in got.items()
                           if isinstance(v, np.ndarray)})
        from test_torch_fsdp import _train_case
        g, p, leaf, misplaced = _train_case(mesh, "olmoe-1b-7b")
        res["train"] = dict(grad=g, param=p, leaf=leaf, misplaced=misplaced)
        if rank == 0:
            np.savez(out + ".npz", **arrays)
            with open(out + ".json", "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The four-rank run, once: (json records, arrays) of rank 0."""
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("moe_dist")
    out = str(d / "res")
    ctx = mp.start_processes(_worker, args=(str(d / "rdv"), out),
                             nprocs=WORLD, join=False, start_method="spawn")
    t0 = time.time()
    try:
        while not ctx.join(timeout=5):
            assert time.time() - t0 < 240, "the 4-rank run timed out"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in ctx.processes)
    with open(out + ".json") as f:
        res = json.load(f)
    return res, dict(np.load(out + ".npz"))


def _whole_shapes(cfg, g):
    """The shapes no collective of a partitioned block moves: every
    token's hidden vector ([T, D], [B, S, D]) and the whole [E, G, D]."""
    t, d, e = B * S, cfg.d_model, cfg.num_experts
    return [[t, d], [B, S, d], [e, g, d], [e * g, d]]


def _case(name):
    return next(c for c in CASES if c[0] == name)


@pytest.mark.parametrize("name", NAMES)
def test_routing_equals_plain_and_jax_bit_for_bit(four_ranks, name):
    """The counts, the kept mask and the sorted order: the sharded
    block's (every rank computes them from the gathered routing) equal to
    the plain block's and to JAX's, bit for bit; the aux loss bit for bit
    the plain block's, and within 1e-6 of JAX's, as
    `test_torch_moe.py` holds the plain block (torch and XLA sum the gates'
    mean in different orders: one ulp apart at mixtral)."""
    _, arrays = four_ranks
    _, arch, experts, cf, _ = _case(name)
    jc, tc = _cfgs(arch, experts)
    want = _jax_routing(jc, _inputs(tc), cf)
    a = {k.split("/", 1)[1]: v for k, v in arrays.items()
         if k.startswith(name + "/")}
    for key in ("counts", "order", "keep"):
        assert np.array_equal(a[key], want[key]), key
        assert np.array_equal(a["d" + key], want[key]), key
    assert a["daux"].tobytes() == a["aux"].tobytes()
    assert abs(float(a["aux"]) - float(want["aux"])) < 1e-6


def test_drop_case_drops_as_jax_does(four_ranks):
    res, arrays = four_ranks
    g = res["olmoe_drops"]["g"]
    counts = arrays["olmoe_drops/dcounts"]
    assert (counts > g).any()                  # some slots are dropped
    assert arrays["olmoe_drops/dkeep"].sum() == np.minimum(counts, g).sum()


@pytest.mark.parametrize("name", NAMES)
def test_output_and_gradients_equal_plain_and_jax(four_ranks, name):
    _, arrays = four_ranks
    _, arch, experts, cf, _ = _case(name)
    jc, tc = _cfgs(arch, experts)
    want = _jax_routing(jc, _inputs(tc), cf)["out"]
    a = {k.split("/", 1)[1]: v for k, v in arrays.items()
         if k.startswith(name + "/")}
    top = np.abs(a["out"]).max()
    assert np.abs(a["dout"] - a["out"]).max() <= TOL * top
    assert np.abs(a["dout"] - want).max() <= TOL * top
    for k in ("x", "router", "wi", "wg", "wo"):
        ref, got = a[f"g_{k}"], a[f"dg_{k}"]
        assert np.abs(got - ref).max() <= TOL * np.abs(ref).max(), k


@pytest.mark.parametrize("name", NAMES)
def test_no_rank_gathers_tokens_or_expert_rows(four_ranks, name):
    """The collectives of the sharded block's forward and backward: the
    all-gathers are the routing's (the gates [T/2, E] and the ids
    [T/2, k] of each data rank) and, where the experts' hidden dim is
    split on "model" (every model rank runs every expert), the slot rows'
    halves of the hidden width gathered over "model"; the all-to-alls move
    slot rows (at most k * T/2 of a rank's own tokens, or the rows it
    owns; half the width in the forward where the hidden dim is split);
    nothing moves a [T, D] or [E, G, D] tensor (the weights' FSDP gathers
    happen before, as a layer's body starts)."""
    res, _ = four_ranks
    r = res[name]
    _, arch, experts, _, hinted = _case(name)
    _, tc = _cfgs(arch, experts)
    t, d, e, k = B * S, tc.d_model, tc.num_experts, tc.experts_per_token
    ffn = experts == 3
    assert r["split"] == ("ffn" if ffn else "experts")
    # a rank's experts (all of them where the hidden dim is split) x its
    # half of the capacity: the most rows it owns
    owned = (e if ffn else e // 2) * r["g"] // 2
    routing = [[t // 2, e], [t // 2, k]]
    gathers = [shape for op, shape in r["shapes"]
               if op.startswith("all_gather") and shape not in routing]
    if not hinted:
        assert sorted(shape for op, shape in r["shapes"]
                      if op.startswith("all_gather") and shape in routing
                      ) == sorted(routing)
        assert len(gathers) == (1 if ffn else 0)
        assert all(rows <= owned and cols == d // 2 for rows, cols in
                   gathers)
    whole = _whole_shapes(tc, r["g"])
    for op, shape in r["shapes"]:
        if op.startswith("all_to_all"):
            # slot rows: a rank's own tokens' (k * T/2 at most; with k = 2
            # on two data ranks as many rows as T, of slots, not tokens),
            # or the filled rows it owns
            assert shape[0] <= max(k * t // 2, owned), shape
            assert shape[1] in ((d, d // 2) if ffn else (d,)), shape
        else:
            assert shape not in whole, (op, shape)


def test_four_ranks_train_step_equals_the_plain_step(four_ranks):
    """One fp32 train step of reduced olmoe-1b-7b on the (2, 2) mesh
    (`test_torch_fsdp._train_case`): every gradient and updated param
    within 1e-5 of the plain step's largest, each gradient within 1e-4 of
    its leaf's largest, every gradient in its AdamW state's placements."""
    from test_torch_fsdp import GRAD_TOL, LEAF_TOL
    res, _ = four_ranks
    r = res["train"]
    assert not r["misplaced"]
    assert r["grad"] <= GRAD_TOL and r["param"] <= GRAD_TOL, r
    assert r["leaf"] <= LEAF_TOL, r


_JAX_MOE = r"""
import json, re
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch import shardings as sh
from repro.models import moe as M
mesh = jax.make_mesh((2, 2), ("data", "model"))
cfg = get_config("olmoe-1b-7b", reduced=True)
p = jax.eval_shape(lambda k: M.init_moe(k, cfg, jnp.float32),
                   jax.random.PRNGKey(0))
psh = {k: NamedSharding(mesh, sh.param_spec(mesh, "layers/moe/" + k,
                                            v.shape)) for k, v in p.items()}
batch = NamedSharding(mesh, P("data"))
f = jax.jit(lambda p, x: M.moe_block(p, x, cfg)[0], in_shardings=(psh, batch),
            out_shardings=batch)
hlo = f.lower(p, jax.ShapeDtypeStruct((%d, %d, cfg.d_model), jnp.float32)
              ).compile().as_text()
out = []
for line in hlo.splitlines():
    m = re.search(r"=\s*(\w+)\[([\d,]*)\]\S*\s+(all-gather|all-reduce|"
                  r"reduce-scatter|all-to-all|collective-permute)"
                  r"(?:-start)?\(.*?replica_groups=(.*?), ", line)
    if m:
        out.append([m.group(3), m.group(1),
                    [int(d) for d in m.group(2).split(",") if d],
                    m.group(4)])
print(json.dumps(out))
""" % (B, S)


def test_jax_block_gathers_only_the_routing():
    """JAX's block of reduced olmoe-1b-7b (E=8, k=2) on four fake host
    devices, the rules' layout (experts over "model", x's batch over
    "data"): its all-gathers, all over "data" (the transposed iota
    groups), are the gates [T, E] f32 and the ids [T*k] s32; no
    collective moves [T, D] or [E, G, D]."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
               "count=4", JAX_PLATFORMS="cpu")
    got = json.loads(subprocess.run(
        [sys.executable, "-c", _JAX_MOE], env=env, check=True,
        capture_output=True, text=True, timeout=120).stdout)
    cfg = get_config("olmoe-1b-7b", reduced=True)
    t, e, k = B * S, cfg.num_experts, cfg.experts_per_token
    g = tmoe.capacity(t, cfg)
    gathers = sorted([dt, shape, groups] for kind, dt, shape, groups in got
                     if kind == "all-gather")
    assert gathers == sorted([["f32", [t, e], "[2,2]<=[2,2]T(1,0)"],
                              ["s32", [t * k], "[2,2]<=[2,2]T(1,0)"]])
    whole = _whole_shapes(cfg, g)
    assert not [shape for _, _, shape, _ in got if shape in whole]


@pytest.mark.parametrize("g,shape", [(24, (16, 16)), (24, (2, 16, 16)),
                                     (40, (2, 2)), (168, (16, 16))])
def test_capacity_shares_tile_the_capacity(g, shape):
    """Each capacity position is held by exactly one data rank, at a local
    row below its share's size, the shares as large as DTensor's shards of
    G over the data axes (every nd-th position where nd divides G, else
    `torch.chunk`'s chunks, nested over ("pod", "data"), empty ones
    included)."""
    from repro_torch.launch.mesh import AbstractMesh, MULTI_POD_AXES
    from repro_torch.models import spmd
    mesh = AbstractMesh(shape, MULTI_POD_AXES[-len(shape):])
    nd = int(np.prod(shape[:-1]))
    held = tmoe._capacity_shares(g, nd, mesh)
    owner, local = tmoe._capacity_owners(held, g, "cpu")
    assert len(held) == nd
    assert sorted(p for r in held for p in r) == list(range(g))
    for p in range(g):
        r = held[int(owner[p])]
        assert r[int(local[p])] == p
    chunks = [hi - lo for lo, hi in spmd.chunk_ranges(g, mesh)]
    assert [len(r) for r in held] == chunks
    whole = torch.arange(g)
    for name, size in zip(mesh.mesh_dim_names[:-1], shape[:-1]):
        whole = [c for w in ([whole] if torch.is_tensor(whole) else whole)
                 for c in list(torch.chunk(w, size))
                 + [w[:0]] * (size - len(torch.chunk(w, size)))]
    assert [len(c) for c in whole] == chunks
