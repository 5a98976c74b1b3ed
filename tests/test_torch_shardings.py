"""The port's sharding rules (`repro_torch.launch.shardings`) against the
JAX package's: for all ten archs at the published config, on both
production meshes (abstract: no devices) and for the variants "",
"moe_zero" and "serve_tp", every parameter leaf's spec equals JAX's
`param_spec` with the stacked leading entries dropped (the port keeps one
dict per layer: `layers/3/wq` [D, E] where JAX has `layers/wq` [L, D, E]);
the optimizer, batch and decode-state specs likewise; and the conversion
of a spec to DTensor placements."""
import jax
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import get_config as jget_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch import shardings as jsh
from repro.models.model import Model as JModel
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import (AbstractMesh, data_axes,
                                     production_shape)
from repro_torch.models.model import Model

MESHES = {"pod256": (production_shape(False),
                     JAbstractMesh((16, 16), ("data", "model"))),
          "pod512": (production_shape(True),
                     JAbstractMesh((2, 16, 16), ("pod", "data", "model")))}
VARIANTS = ("", "moe_zero", "serve_tp")


def _jax_path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _jax_leaves(tree):
    """{path: leaf} of a JAX tree (eval_shape leaves)."""
    out = {}
    jax.tree_util.tree_map_with_path(
        lambda p, x: out.__setitem__(_jax_path(p), x), tree)
    return out


def _unstacked(path: str):
    """A port leaf path -> (JAX's path, the number of stacked dims)."""
    parts = path.split("/")
    keep = [p for p in parts if not p.isdigit()]
    return "/".join(keep), len(parts) - len(keep)


def _expected(jspec, k: int) -> tuple:
    """JAX's spec of a stacked leaf with its k leading entries dropped (a
    replicated P() stays empty)."""
    return tuple(jspec)[k:] if len(jspec) else ()


@pytest.fixture(scope="module")
def trees():
    """(port params shape, JAX params shape by path) of every arch."""
    return {a: (Model(get_config(a), device="cpu").param_specs(),
                _jax_leaves(JModel(jget_config(a)).param_specs()))
            for a in list_archs()}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_jax(trees, arch, variant, mesh_name):
    mesh, jmesh = MESHES[mesh_name]
    params, jleaves = trees[arch]
    names, leaves = tree_lib.flatten_with_paths(params)
    specs = [sh.param_spec(mesh, n, tuple(x.shape), variant)
             for n, x in zip(names, leaves)]
    seen = set()
    for name, leaf, spec in zip(names, leaves, specs):
        jpath, k = _unstacked(name)
        jleaf = jleaves[jpath]
        assert tuple(jleaf.shape[k:]) == tuple(leaf.shape), name
        jspec = jsh.param_spec(jmesh, jpath, jleaf.shape, variant)
        assert isinstance(spec, sh.P)
        assert tuple(spec) == _expected(jspec, k), (name, spec, jspec)
        seen.add(jpath)
    assert seen == set(jleaves)


def test_param_shardings_tree_matches_param_spec(trees):
    mesh = production_shape(False)
    params = trees["olmoe-1b-7b"][0]
    tree = sh.param_shardings(mesh, params)
    for (leaf, spec), name in zip(_pairs(params, tree),
                                  tree_lib.flatten_with_paths(params)[0]):
        assert spec == sh.param_spec(mesh, name, tuple(leaf.shape))


def _pairs(tree, specs):
    out = []
    sh._map2(lambda t, s: out.append((t, s)), tree, specs)
    return out


@pytest.mark.parametrize("variant", ("", "moe_zero"))
@pytest.mark.parametrize("arch", ("mixtral-8x7b", "olmoe-1b-7b",
                                  "glm4-9b"))
def test_opt_shardings_equal_jax(trees, arch, variant):
    """m and v take the param specs (the baseline 2-D ones under
    "moe_zero"), step is replicated: JAX's `opt_shardings` leaf by leaf."""
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw
    mesh, jmesh = MESHES["pod256"]
    params, _ = trees[arch]
    jparams = JModel(jget_config(arch)).param_specs()
    jopt = jax.eval_shape(jadamw.adamw_init, jparams)
    want = _jax_leaves(jsh.opt_shardings(
        jmesh, jopt, jsh.param_shardings(jmesh, jparams, variant), jparams,
        variant))
    opt = adamw.adamw_init(params)
    osh = sh.opt_shardings(mesh, opt, sh.param_shardings(mesh, params,
                                                         variant),
                           params, variant)
    assert osh["step"] == sh.P() and tuple(want["step"].spec) == ()
    names = tree_lib.flatten_with_paths(params)[0]
    for which in ("m", "v"):
        for name, (_, spec) in zip(names, _pairs(opt[which], osh[which])):
            jpath, k = _unstacked(name)
            assert tuple(spec) == _expected(
                want[f"{which}/{jpath}"].spec, k), (which, name)


def test_batch_spec_pod_axis():
    for mesh, jmesh in MESHES.values():
        for nd in (1, 2, 3):
            assert tuple(sh.batch_spec(mesh, nd)) == \
                tuple(jsh.batch_spec(jmesh, nd))
    assert sh.batch_spec(production_shape(True), 2)[0] == ("pod", "data")
    assert data_axes(production_shape(True)) == ("pod", "data")
    assert data_axes(production_shape(False)) == ("data",)


def test_batch_shardings_of_inputs():
    """Batch leaves shard their leading dim over (pod, data) when it
    divides (train_4k's 256 rows), and stay whole otherwise (long_500k's
    one row)."""
    m = Model(get_config("qwen2-vl-72b"), device="cpu")
    mesh = production_shape(True)
    b = sh.batch_shardings(mesh, m.input_specs(SHAPES["train_4k"]))
    assert b["tokens"] == sh.P(("pod", "data"), None)
    assert b["extra_embeds"] == sh.P(("pod", "data"), None, None)
    z = Model(get_config("zamba2-2.7b"), device="cpu")
    bz = sh.batch_shardings(mesh, z.input_specs(
        SHAPES["long_500k"], for_decode_state=False))
    assert bz["tokens"] == sh.P()


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", [("glm4-9b", "decode_32k"),
                                        ("granite-34b", "decode_32k"),
                                        ("zamba2-2.7b", "long_500k"),
                                        ("zamba2-2.7b", "decode_32k"),
                                        ("seamless-m4t-large-v2",
                                         "decode_32k")])
def test_decode_state_shardings_equal_jax(arch, shape, mesh_name):
    """Every state leaf's spec equals JAX's entry for entry (the states
    are stacked alike; zamba2's h [G, per, B, N, nh, 64] in both); the
    port's "pos" is a Python int and has none."""
    mesh, jmesh = MESHES[mesh_name]
    cfg = get_config(arch)
    state = Model(cfg, device="cpu").input_specs(SHAPES[shape])["state"]
    jstate = JModel(jget_config(arch)).input_specs(JSHAPES[shape])["state"]
    jspecs = _jax_leaves(jsh.decode_state_shardings(jmesh, jstate,
                                                    jget_config(arch)))
    jshapes = _jax_leaves(jstate)
    got = sh.decode_state_shardings(mesh, state, cfg)
    names = tree_lib.flatten_with_paths(state)[0]
    for name, (leaf, spec) in zip(names, _pairs(state, got)):
        if name == "pos":
            assert spec is None and isinstance(leaf, int)
            continue
        assert tuple(leaf.shape) == tuple(jshapes[name].shape), name
        assert tuple(spec) == tuple(jspecs[name].spec), name
    if cfg.is_encoder_decoder:
        assert got["enc_out"] == sh.P("data")


def test_serve_tp_decode_cache_over_both_axes():
    mesh, jmesh = MESHES["pod256"]
    cfg = get_config("glm4-9b")
    state = Model(cfg, device="cpu").input_specs(
        SHAPES["decode_32k"])["state"]
    got = sh.decode_state_shardings(mesh, state, cfg, "serve_tp")
    assert got["kv"]["k"] == sh.P(None, None, ("data", "model"), None,
                                  None)


def test_placements():
    """One placement per mesh dim: Shard(d) where tensor dim d names the
    axis, a tuple entry on both mesh dims (major first), Replicate
    elsewhere; an axis out of mesh order, twice, or off the mesh raises."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert sh.placements(mesh, sh.P()) == (Replicate(),) * 3
    assert sh.placements(mesh, sh.P("data", "model")) == \
        (Replicate(), Shard(0), Shard(1))
    assert sh.placements(mesh, sh.P(None, ("data", "model"))) == \
        (Replicate(), Shard(1), Shard(1))
    assert sh.placements(mesh, sh.P(("pod", "data"), None)) == \
        (Shard(0), Shard(0), Replicate())
    for bad in (sh.P(("model", "data")), sh.P("data", "data"),
                sh.P("expert")):
        with pytest.raises(ValueError):
            sh.placements(mesh, bad)


def test_every_spec_divides(trees):
    """A spec only names axes that divide its dim (the rules' contract,
    which `distribute` relies on for even shards)."""
    for mesh, _ in MESHES.values():
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        for arch, (params, _) in trees.items():
            for variant in VARIANTS:
                for leaf, spec in _pairs(params, sh.param_shardings(
                        mesh, params, variant)):
                    for dim, entry in zip(leaf.shape, spec):
                        axes = () if entry is None else (
                            (entry,) if isinstance(entry, str) else entry)
                        n = 1
                        for a in axes:
                            n *= sizes[a]
                        assert dim % n == 0, (arch, variant, spec)


def test_meshes_raise_rather_than_fall_back():
    """No process group, a world that is not the mesh's size, a cuda mesh
    over a group that is not NCCL, a model axis that does not divide the
    world: each raises. A world-1 gloo group gives the (1, 1) host mesh."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    with pytest.raises(RuntimeError):
        M.make_host_mesh(device_type="cpu")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError):
            M.make_production_mesh(device_type="cpu")
        with pytest.raises(RuntimeError):
            M.make_host_mesh(device_type="cuda")
        with pytest.raises(ValueError):
            M.make_host_mesh(model_axis=2, device_type="cpu")
        mesh = M.make_host_mesh(device_type="cpu")
        assert tuple(mesh.shape) == (1, 1)
        assert M.axis_sizes(mesh) == {"data": 1, "model": 1}
    finally:
        dist.destroy_process_group()
