"""The port's checkpoints (`repro_torch.checkpoint.ckpt`): atomic commit,
stale .tmp dirs ignored, keep_last pruning, the async save's host
snapshot, a bf16 round trip, and the on-disk format shared with the JAX
package both ways: a checkpoint that JAX's trainer state wrote restores
through the port (a `like` tree of JAX's layout with numpy leaves), and
`convert.from_jax` / `opt_from_jax` of it equal the conversion of JAX's
own tree bit for bit; a checkpoint the port wrote restores through JAX's
`restore`."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.checkpoint import ckpt as jckpt
from repro.models.model import Model as JModel
from repro.configs import get_config as jget_config
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import ckpt as tckpt


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _tree():
    return {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": {"c": torch.linspace(-3, 3, 5).to(torch.bfloat16)},
            "layers": [{"w": torch.full((2,), float(i))} for i in range(3)],
            "step": torch.tensor(7, dtype=torch.int32)}


def _equal(x, y) -> bool:
    return x.dtype == y.dtype and x.shape == y.shape and \
        np.array_equal(_bits(x), _bits(y))


def test_atomic_commit_prunes_and_round_trips(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    for step in (1, 2, 3, 4):
        out = tckpt.save(d, step, tree, extra={"step": step}, keep_last=2)
        assert out == os.path.join(d, f"step_{step}")
    assert tckpt.latest_step(d) == 4
    assert sorted(tckpt.latest_steps(d)) == [3, 4]
    assert not [n for n in os.listdir(d) if n.endswith(".tmp")]
    back = tckpt.restore(d, 4, tree)
    assert all(_equal(x, y) for x, y in zip(tree_lib.leaves(back),
                                            tree_lib.leaves(tree)))
    assert back["b"]["c"].dtype == torch.bfloat16
    assert tckpt.restore_extra(d, 4) == {"step": 4}
    with open(os.path.join(d, "step_4", "manifest.json")) as f:
        man = json.load(f)
    assert man["names"][:3] == ["a", "b/c", "layers/0/w"]
    assert man["dtypes"][1] == "bfloat16" and man["shapes"][1] == [5]
    # a stale .tmp dir (a crash mid-write) is never listed as a checkpoint
    os.makedirs(os.path.join(d, "step_9.tmp"))
    assert tckpt.latest_step(d) == 4
    # a tree of another structure is refused
    with pytest.raises(ValueError, match="structure"):
        tckpt.restore(d, 4, {"a": tree["a"]})


def test_async_save_snapshots_before_returning(tmp_path):
    d = str(tmp_path)
    ck = tckpt.Checkpointer(d, keep_last=3)
    tree = _tree()
    want = [t.clone() for t in tree_lib.leaves(tree)]
    ck.save_async(5, tree, extra={"step": 5})
    for t in tree_lib.leaves(tree):      # the train loop updates in place
        t.zero_()
    ck.wait()
    assert tckpt.latest_step(d) == 5
    back = tckpt.restore(d, 5, tree)
    assert all(_equal(x, y) for x, y in zip(tree_lib.leaves(back), want))
    # a write that fails surfaces at the next wait
    ck.path = os.path.join(d, "missing", "\0bad")
    ck.save_async(6, tree)
    with pytest.raises(ValueError):
        ck.wait()


def test_jax_checkpoint_restores_through_the_port(tmp_path):
    """The JAX trainer's {"params", "opt"} tree of reduced chatglm3-6b
    (bf16 params, fp32 m/v, int32 step), written by JAX's `save`."""
    d = str(tmp_path)
    jm = JModel(jget_config("chatglm3-6b", reduced=True))
    jp = jm.init(jax.random.PRNGKey(0))
    opt = jadamw.adamw_init(jp)
    g = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), jp)
    _, opt, _ = jadamw.adamw_update(jadamw.AdamWConfig(), jp, g, opt)
    jtree = {"params": jp, "opt": opt}
    jckpt.save(d, 3, jtree, extra={"step": 3})
    like = jax.tree.map(np.asarray, jtree)
    back = tckpt.restore(d, 3, like)
    assert int(back["opt"]["step"]) == 1
    got = convert.from_jax(back["params"])
    want = convert.from_jax(like["params"])
    assert got["embed"].dtype == torch.bfloat16
    gl, wl = tree_lib.flatten_with_paths(got), tree_lib.flatten_with_paths(want)
    assert gl[0] == wl[0]
    assert all(_equal(x, y) for x, y in zip(gl[1], wl[1]))
    got_opt = convert.opt_from_jax(back["opt"])
    want_opt = convert.opt_from_jax(like["opt"])
    assert got_opt["step"].dtype == torch.int32
    assert all(_equal(x, y) for x, y in zip(tree_lib.leaves(got_opt),
                                            tree_lib.leaves(want_opt)))
    assert tree_lib.flatten_with_paths(got_opt["m"])[0] == gl[0]


def test_port_checkpoint_restores_through_jax(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    tckpt.save(d, 2, tree)
    like = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else t.numpy().dtype),
        tree)
    back = jckpt.restore(d, 2, like)
    for x, y in zip(jax.tree.leaves(back), tree_lib.leaves(tree)):
        x = np.asarray(x)
        if y.dtype == torch.bfloat16:
            assert x.dtype.name == "bfloat16"
            assert np.array_equal(x.view(np.int16), _bits(y))
        else:
            assert np.array_equal(x, y.numpy())


@pytest.fixture
def host_mesh():
    """The port's host mesh over a world-1 gloo group (destroyed after)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_host_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_restore_with_shardings_equals_jax(tmp_path, host_mesh):
    """The elastic re-shard point: a checkpoint restored with a spec tree
    (or one spec for every leaf) on the port's (1, 1) host mesh gives
    DTensors laid out by the specs whose values equal the saved leaves
    and JAX's `restore(shardings=)` on its host mesh, bit for bit."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro.launch.mesh import make_host_mesh as jmake_host_mesh
    from repro_torch.launch import shardings as sh
    d = str(tmp_path)
    tree = _tree()
    tckpt.save(d, 1, tree)
    jmesh = jmake_host_mesh()
    jlike = jax.tree.map(np.asarray, {
        "a": jnp.zeros((2, 3), jnp.int32), "b": {"c": jnp.zeros(
            5, jnp.bfloat16)}, "layers": [{"w": jnp.zeros(2)}] * 3,
        "step": jnp.zeros((), jnp.int32)})
    port_specs = {"a": sh.P("data", None), "b": {"c": sh.P("model")},
                  "layers": [{"w": sh.P()}] * 3, "step": sh.P()}
    jax_sh = {"a": JP("data", None), "b": {"c": JP("model")},
              "layers": [{"w": JP()}] * 3, "step": JP()}
    jax_sh = jax.tree.map(lambda x: NamedSharding(jmesh, x), jax_sh,
                          is_leaf=lambda x: isinstance(x, JP))
    for port_sh, jsh_ in ((port_specs, jax_sh),
                          (sh.P(), NamedSharding(jmesh, JP()))):
        back = tckpt.restore(d, 1, tree, shardings=port_sh, mesh=host_mesh)
        jback = jckpt.restore(d, 1, jlike, shardings=jsh_)
        for x, y, j in zip(tree_lib.leaves(back), tree_lib.leaves(tree),
                           jax.tree.leaves(jback)):
            assert isinstance(x, DTensor)
            assert _equal(x.full_tensor(), y)
            assert np.array_equal(np.asarray(j).view(_bits(y).dtype)
                                  if y.dtype == torch.bfloat16
                                  else np.asarray(j), _bits(y))
    back = tckpt.restore(d, 1, tree, shardings=port_specs, mesh=host_mesh)
    assert back["a"].placements == (Shard(0), Replicate())
    assert back["b"]["c"].placements == (Replicate(), Shard(0))
    assert back["step"].placements == (Replicate(), Replicate())
    with pytest.raises(ValueError):
        tckpt.restore(d, 1, tree, shardings=sh.P())
