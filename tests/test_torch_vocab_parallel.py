"""The loss and the LM head on each rank's vocab shard
(`repro_torch.models.spmd.vocab_nll`, `spmd.shard_on_model`,
`transformer.token_loss` / `_head`), held against the plain port and the
JAX package:

  * The reference: JAX's `lm_loss` with its gradient, compiled on a (2, 2)
    ("data", "model") mesh of four fake host devices over logits
    [B("data"), S, V("model")] (in a subprocess whose environment alone
    sets XLA_FLAGS), gathers nothing: it all-reduces [B/2, S] over "model"
    (the max and the sum of the log-sum-exp) and scalars over "data".
  * Four gloo ranks on the (2, 2) mesh, fp32: the vocab-parallel loss of
    the same numpy logits within 1e-5 (relative) of the plain loss and of
    JAX's, its gradient within 1e-5 of the plain gradient's largest
    magnitude, and no collective of a [B, S, V]-sized tensor in what a
    CommDebugMode records; every label at -100 gives 0, as in JAX; at an
    odd vocab (257) the head splits its vocab over "model" unevenly
    (129 + 128) and the head, the loss and a decode step equal the plain
    ones.
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
from repro.models import transformer as jT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402

WORLD = 4
B, S, V = 4, 16, 256
ODD_V = 257
TOL = 1e-5          # relative: the loss; of the largest |gradient|: grads


def _logits(v=V, seed=0):
    return np.random.default_rng(seed).normal(
        scale=3.0, size=(B, S, v)).astype(np.float32)


def _labels(v=V, seed=1, masked=0.25):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, v, size=(B, S)).astype(np.int32)
    lab[rng.random((B, S)) < masked] = -100
    return lab


def _jax_loss(logits, labels):
    """JAX's `lm_loss` on these logits (its forward replaced by them)."""
    cfg = jget_config("glm4-9b", reduced=True)
    with mock.patch.object(jT, "lm_forward", lambda *a, **k: (
            jnp.asarray(logits), {"moe_aux_loss": jnp.zeros(())})):
        return float(jT.lm_loss(None, cfg, None, jnp.asarray(labels))[0])


class _Recorder:
    """A CommDebugMode that also keeps the shape of every collective's
    operand (the functional collectives DTensor and the port issue)."""

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


def _loss_case(mesh, logits, labels):
    """(plain loss, plain grad, sharded loss, sharded grad, collectives)."""
    from repro_torch.launch import shardings as sh
    from repro_torch.models import transformer as T
    lg = torch.from_numpy(logits).requires_grad_(True)
    lb = torch.from_numpy(labels)
    loss = T.token_loss(lg, lb)
    grad, = torch.autograd.grad(loss, lg)
    dlg = sh.distribute_leaf(torch.from_numpy(logits), mesh,
                             sh.P("data", None, "model"),
                             src_data_rank=None).requires_grad_(True)
    dlb = sh.distribute_leaf(lb, mesh, sh.P("data"), src_data_rank=None)
    with _Recorder() as rec:
        dloss = T.token_loss(dlg, dlb)
        dgrad, = torch.autograd.grad(dloss, dlg)
    counts = {str(k): v for k, v in rec.get_comm_counts().items()}
    return (loss.item(), grad.numpy(), dloss.full_tensor().item(),
            dgrad.full_tensor().numpy(), dict(shapes=rec.shapes,
                                              counts=counts,
                                              grad_placements=str(
                                                  dgrad.placements)))


def _head_case(mesh, tie: bool):
    """The head and the loss of reduced glm4-9b at vocab ODD_V (its vocab
    left whole on "model" by the rules), plain and sharded: logits, loss,
    and the gradients of the stream and of the head's weight."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import shardings as sh
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config("glm4-9b", reduced=True),
                              dtype="float32", vocab_size=ODD_V,
                              tie_embeddings=tie)
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    head = {k: params[k] for k in ("final_ln", "embed", "out") if k in params}
    w = "embed" if tie else "out"
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(B, S, cfg.d_model)).astype(np.float32))
    lab = torch.from_numpy(_labels(ODD_V))

    def run(p, xx, lb):
        leaf = p[w].requires_grad_(True)
        xx = xx.requires_grad_(True)
        logits = T._head(p, cfg, xx)
        loss = T.token_loss(logits, lb)
        gx, gw = torch.autograd.grad(loss, (xx, leaf))
        return logits, loss, gx, gw
    logits, loss, gx, gw = run({k: v.clone() for k, v in head.items()},
                               x.clone(), lab)
    dhead = sh.distribute({k: v.clone() for k, v in head.items()}, mesh,
                          sh.param_shardings(mesh, head), src_data_rank=None)
    with implicit_replication():
        dlogits, dloss, dgx, dgw = run(
            dhead, sh.distribute_leaf(x.clone(), mesh, sh.P("data"),
                                      src_data_rank=None),
            sh.distribute_leaf(lab, mesh, sh.P("data"), src_data_rank=None))
    return dict(
        logits=logits.detach().numpy(),
        dlogits=dlogits.detach().full_tensor().numpy(),
        logit_placements=str(dlogits.placements),
        local_vocab=int(dlogits.to_local().shape[-1]),
        loss=loss.item(), dloss=dloss.full_tensor().item(),
        gx=gx.numpy(), dgx=dgx.full_tensor().numpy(),
        gw=gw.numpy(), dgw=dgw.full_tensor().numpy(),
        weight_placements=str(dhead[w].placements),
        grad_placements=str(dgw.placements))


def _decode_case(mesh):
    """Two decode steps of reduced glm4-9b at vocab ODD_V, plain and on
    DTensors laid out by the rules (the head split unevenly): logits."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import shardings as sh
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config("glm4-9b", reduced=True),
                              dtype="float32", vocab_size=ODD_V)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, ODD_V, size=(B, 2)).astype(np.int32))
    st = model.init_decode_state(B, 8)
    plain = []
    with torch.no_grad():
        for i in range(2):
            lg, st = model.decode_step(params, st, toks[:, i])
            plain.append(lg.numpy())
        dparams = sh.distribute({k: v for k, v in params.items()}, mesh,
                                sh.param_shardings(mesh, params),
                                src_data_rank=None)
        st = model.init_decode_state(B, 8)
        st = sh.distribute(st, mesh, sh.decode_state_shardings(mesh, st, cfg),
                           src_data_rank=None)
        sharded = []
        with implicit_replication():
            for i in range(2):
                tok = sh.distribute_leaf(toks[:, i].contiguous(), mesh,
                                         sh.P("data"), src_data_rank=None)
                lg, st = model.decode_step(dparams, st, tok)
                sharded.append(lg.full_tensor().numpy())
    return dict(plain=np.stack(plain), sharded=np.stack(sharded))


def _worker(rank, path, out):
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=WORLD)
    try:
        torch.manual_seed(0)
        mesh = make_host_mesh(2, "cpu")
        res, arrays = {}, {}
        for name, labels in (("even", _labels()),
                             ("all_masked", np.full((B, S), -100, np.int32))):
            loss, grad, dloss, dgrad, rec = _loss_case(mesh, _logits(),
                                                       labels)
            res[name] = dict(loss=loss, dloss=dloss, **rec)
            arrays[f"{name}_grad"], arrays[f"{name}_dgrad"] = grad, dgrad
        for tie in (False, True):
            got = _head_case(mesh, tie)
            key = "head_tied" if tie else "head"
            res[key] = {k: v for k, v in got.items()
                        if not isinstance(v, np.ndarray)}
            arrays.update({f"{key}_{k}": v for k, v in got.items()
                           if isinstance(v, np.ndarray)})
        arrays.update({f"decode_{k}": v
                       for k, v in _decode_case(mesh).items()})
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
    d = tmp_path_factory.mktemp("vocab_parallel")
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


def test_loss_equals_plain_and_jax(four_ranks):
    res, _ = four_ranks
    r = res["even"]
    want = _jax_loss(_logits(), _labels())
    assert abs(r["loss"] - want) <= TOL * abs(want)
    assert abs(r["dloss"] - r["loss"]) <= TOL * abs(r["loss"])
    assert abs(r["dloss"] - want) <= TOL * abs(want)


def test_loss_gradient_equals_plain(four_ranks):
    res, arrays = four_ranks
    g, dg = arrays["even_grad"], arrays["even_dgrad"]
    assert np.abs(dg - g).max() <= TOL * np.abs(g).max()
    # the gradient stays in the logits' layout: batch over "data", vocab
    # over "model"
    assert res["even"]["grad_placements"] == "(Shard(dim=0), Shard(dim=2))"


def test_loss_gathers_no_logits(four_ranks):
    """What a CommDebugMode records over the loss's forward and backward:
    all-reduces of [B/2, S] over "model" (three: max, sum, the label's
    logit) and scalars; nothing of the logits' size, and no all-gather."""
    res, _ = four_ranks
    rec = res["even"]
    assert not any("all_gather" in k for k in rec["counts"])
    assert all(int(np.prod(shape)) < B * S * V // 4
               for _, shape in rec["shapes"])
    rows = [shape for op, shape in rec["shapes"] if shape == [B // 2, S]]
    assert len(rows) == 3
    assert {op for op, _ in rec["shapes"]} == {"all_reduce"}


def test_all_masked_loss_is_zero_as_in_jax(four_ranks):
    res, arrays = four_ranks
    labels = np.full((B, S), -100, np.int32)
    assert _jax_loss(_logits(), labels) == 0.0
    assert res["all_masked"]["loss"] == 0.0
    assert res["all_masked"]["dloss"] == 0.0
    assert not np.any(arrays["all_masked_dgrad"])


@pytest.mark.parametrize("key", ["head", "head_tied"])
def test_odd_vocab_head_is_split_unevenly_on_model(four_ranks, key):
    """Vocab 257: the rules leave the head's vocab whole on "model"
    (Replicate: 257 does not divide 2); `_head` splits it there before the
    product, so each model rank computes 129 or 128 of the logits."""
    res, _ = four_ranks
    r = res[key]
    assert "Shard(dim=" not in r["weight_placements"].split(",")[-1]
    assert r["logit_placements"] == "(Shard(dim=0), Shard(dim=2))"
    assert r["local_vocab"] == 129          # rank 0's chunk of 257 over 2


@pytest.mark.parametrize("key", ["head", "head_tied"])
def test_odd_vocab_head_and_loss_equal_plain_and_jax(four_ranks, key):
    res, arrays = four_ranks
    r = res[key]
    lg, dlg = arrays[f"{key}_logits"], arrays[f"{key}_dlogits"]
    assert np.abs(dlg - lg).max() <= TOL * np.abs(lg).max()
    assert (dlg.argmax(-1) == lg.argmax(-1)).all()
    want = _jax_loss(lg, _labels(ODD_V))
    assert abs(r["loss"] - want) <= TOL * abs(want)
    assert abs(r["dloss"] - want) <= TOL * abs(want)
    for g in ("gx", "gw"):
        ref, got = arrays[f"{key}_{g}"], arrays[f"{key}_d{g}"]
        assert np.abs(got - ref).max() <= TOL * np.abs(ref).max(), g
    # the weight's gradient comes back in its leaf's placements
    assert r["grad_placements"] == r["weight_placements"]


def test_odd_vocab_decode_logits_equal_plain(four_ranks):
    _, arrays = four_ranks
    plain, sharded = arrays["decode_plain"], arrays["decode_sharded"]
    assert plain.shape == (2, B, ODD_V)
    assert np.abs(sharded - plain).max() <= TOL * np.abs(plain).max()
    assert (sharded.argmax(-1) == plain.argmax(-1)).all()


_JAX_LOSS = r"""
import json, re
from unittest import mock
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models import transformer as T
mesh = jax.make_mesh((2, 2), ("data", "model"))
cfg = get_config("glm4-9b", reduced=True)
B, S, V = %d, %d, %d


def loss(lg, lb):
    with mock.patch.object(T, "lm_forward", lambda *a, **k: (
            lg, {"moe_aux_loss": jnp.zeros(())})):
        return T.lm_loss(None, cfg, None, lb)[0]


f = jax.jit(jax.value_and_grad(loss), in_shardings=(
    NamedSharding(mesh, P("data", None, "model")),
    NamedSharding(mesh, P("data"))))
hlo = f.lower(jax.ShapeDtypeStruct((B, S, V), jnp.float32),
              jax.ShapeDtypeStruct((B, S), jnp.int32)).compile().as_text()
out = []
for line in hlo.splitlines():
    m = re.search(r"=\s*\w+\[([\d,]*)\]\S*\s+(all-gather|all-reduce|"
                  r"reduce-scatter|all-to-all|collective-permute)"
                  r"(?:-start)?\(.*?replica_groups=(.*?), ", line)
    if m:
        out.append([m.group(2), [int(d) for d in m.group(1).split(",")
                                 if d], m.group(3)])
print(json.dumps(out))
""" % (B, S, V)


def test_jax_loss_gathers_no_logits():
    """JAX's loss and gradient over [B("data"), S, V("model")] logits on
    four fake host devices: two all-reduces of [B/2, S] over "model"
    ({0, 1}, {2, 3}: iota [2, 2] groups), scalars over "data" (the
    transposed groups), and no all-gather. The port's loss issues the
    same [B/2, S] reductions (and a third, the label's logit, which XLA
    folds into the sum's) and no gather."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
               "count=4", JAX_PLATFORMS="cpu")
    got = json.loads(subprocess.run(
        [sys.executable, "-c", _JAX_LOSS], env=env, check=True,
        capture_output=True, text=True, timeout=120).stdout)
    assert {kind for kind, _, _ in got} == {"all-reduce"}
    over_model = [shape for _, shape, g in got if g == "[2,2]<=[4]"]
    assert over_model == [[B // 2, S]] * 2
    assert all(shape == [] for _, shape, g in got if g != "[2,2]<=[4]")


def test_dry_run_train_step_holds_no_gathered_logits(tmp_path):
    """chatglm3-6b x train_4k at 2 layers on the fake (16, 16) mesh
    (`dryrun.run_cell`): the largest storages the step holds at its
    modelled peak are activation shards, none as large as the logits
    gathered over "model" ([B/16, S, V] fp32, 17 GB), let alone the global
    [B, S, V] (273 GB) the loss's gradient once wrote on every rank."""
    from repro_torch.launch import dryrun as dr
    cfg = dataclasses.replace(get_config("chatglm3-6b"), num_layers=2)
    rec = dr.run_cell("chatglm3-6b", "train_4k", multi_pod=False,
                      out_dir=str(tmp_path), cfg=cfg)
    gathered = 256 // 16 * 4096 * cfg.vocab_size * 4
    assert rec["peak_largest"]
    assert all(t["bytes"] < gathered // 8 for t in rec["peak_largest"])
    assert rec["peak_memory_in_bytes"] < 256 * 4096 * cfg.vocab_size * 4 // 8
