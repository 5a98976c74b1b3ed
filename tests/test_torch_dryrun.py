"""The port's dry run (`repro_torch.launch.dryrun`): its analytic
per-device argument bytes equal the JAX package's formula over JAX's own
sharding rules and `Model.param_specs` / `input_specs` for every
applicable cell on both production meshes (and fit the H100's memory on
the pod), the per-device FLOP count is pinned on one 2-D sharded product,
and `run_cell` completes on a fake 256-rank group for glm4-9b x
decode_32k, olmoe-1b-7b x prefill_32k and zamba2-2.7b x long_500k at the
published configs, and for chatglm3-6b x train_4k at 2 of its 28 layers
(the whole depth takes ~50 s alone, past this file's budget).

`repro.launch.dryrun` is not imported: its import sets XLA_FLAGS to 512
host devices, which could reach a test worker's JAX."""
import dataclasses
import functools
import json
import os

import jax
import pytest
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import PartitionSpec as JP

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.shapes import SHAPE_ORDER, SHAPES, applicable
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch.mesh import HBM_BYTES, production_shape
from repro_torch.models.model import Model  # noqa: E402

JMESH = {False: JAbstractMesh((16, 16), ("data", "model")),
         True: JAbstractMesh((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(a, s) for a in list_archs() for s in SHAPE_ORDER
         if applicable(get_config(a), s)[0]]


def _jax_arg_bytes(arch, shape, multi_pod):
    """JAX's `run_cell` formula: each argument leaf's bytes over the
    product of the mesh axes in its spec, from JAX's rules on JAX's
    shapes; batch leaves by `batch_shardings`' rule (leading dim over
    (pod, data) when it divides, written out here because JAX's reads a
    concrete mesh's devices). JAX keeps the decode state's "pos" as an
    int32 scalar, 4 bytes the port holds as a Python int: not counted."""
    jmesh = JMESH[multi_pod]
    sizes = dict(jmesh.shape)
    cfg = jget_config(arch)
    model = _jax_model(arch)
    spec = JSHAPES[shape]
    params = model.param_specs()
    trees = [(params, jsh.param_shardings(jmesh, params))]
    batch = model.input_specs(spec)
    if spec.mode == "train":
        opt = jax.eval_shape(jadamw.adamw_init, params)
        trees.append((opt, jsh.opt_shardings(jmesh, opt, trees[0][1],
                                             params)))
    if spec.mode == "decode":
        state = batch.pop("state")
        state = {k: v for k, v in state.items() if k != "pos"}
        trees.append((state, jsh.decode_state_shardings(jmesh, state, cfg)))
    rows = sizes.get("pod", 1) * sizes["data"]
    trees.append((batch, jax.tree.map(
        lambda x: jsh.batch_spec(jmesh, x.ndim)
        if x.ndim and x.shape[0] % rows == 0 else JP(), batch)))
    total = 0.0
    for tree, shs in trees:
        specs = jax.tree.leaves(shs, is_leaf=lambda x: isinstance(x, JP)
                                or hasattr(x, "spec"))
        for leaf, s in zip(jax.tree.leaves(tree), specs):
            s = getattr(s, "spec", s)
            n = leaf.size * leaf.dtype.itemsize
            for entry in s:
                for ax in (() if entry is None else (
                        (entry,) if isinstance(entry, str) else entry)):
                    n /= sizes[ax]
            total += n
    return total


@functools.lru_cache(maxsize=None)
def _model(arch):
    """The port's Model of `arch`, its param_specs tree drawn once."""
    m = Model(get_config(arch), device="cpu")
    m.param_specs = functools.lru_cache()(m.param_specs)
    return m


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    m = JModel(jget_config(arch))
    m.param_specs = functools.lru_cache()(m.param_specs)
    return m


def _port_arg_bytes(arch, shape, multi_pod):
    mesh = production_shape(multi_pod)
    _, args, specs = dr.build_step(_model(arch), shape, mesh)
    return dr.arg_bytes_analytic(args, specs, mesh)


@pytest.mark.parametrize("multi_pod", (False, True))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_arg_bytes_equal_jax_formula(arch, shape, multi_pod):
    got = _port_arg_bytes(arch, shape, multi_pod)
    assert got == _jax_arg_bytes(arch, shape, multi_pod)
    if not multi_pod:
        assert got < HBM_BYTES, f"{arch} {shape}: {got / 2 ** 30} GiB"


def test_applicable_cells():
    assert len(CELLS) == 33


def test_n_units_of():
    want = {"chatglm3-6b": 28, "falcon-mamba-7b": 64, "glm4-9b": 40,
            "granite-20b": 52, "granite-34b": 88, "mixtral-8x7b": 32,
            "olmoe-1b-7b": 16, "qwen2-vl-72b": 80,
            "seamless-m4t-large-v2": 24, "zamba2-2.7b": 9}
    assert {a: dr.n_units_of(get_config(a)) for a in list_archs()} == want


def test_flops_per_device_on_a_sharded_product():
    """[256, 4096] @ [4096, 11008] with the rows over "data" and the
    weight over ("data", "model") of a fake 16 x 16 mesh: the count is
    what one rank's shards compute, 2 * 256 * 4096 * 11008 / 256 (a
    FLOP counter around the DTensor op would count the global product,
    256 times more); DTensor's layout inference is not counted, and the
    operand moved between the shards shows as a collective."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_production_mesh
    with dr.fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        with FakeTensorMode():
            a = sh.distribute_leaf(torch.empty(256, 4096), mesh,
                                   sh.P("data", None), src_data_rank=None)
            b = sh.distribute_leaf(torch.empty(4096, 11008), mesh,
                                   sh.P("data", "model"),
                                   src_data_rank=None)
            with dr.counting(dr.cost_mode()) as cost:
                out = a @ b
            assert tuple(out.shape) == (256, 11008)
    assert cost.flops == 2 * 256 * 4096 * 11008 // 256
    assert cost.collective_ops >= 1
    assert sum(cost.collective_kinds.values()) > 0


def _check_record(rec, arch, shape, tmp_path):
    assert rec["cell"] == f"{arch}_{shape}_pod256"
    assert rec["chips"] == 256 and rec["mesh"] == [16, 16]
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["collective_bytes"] == sum(rec["collective_kinds"].values())
    assert "probe" not in rec
    assert all(rec[k] > 0 for k in dr.MEMORY_FIELDS)
    with open(os.path.join(tmp_path, rec["cell"] + ".json")) as f:
        assert json.load(f) == rec


@pytest.mark.parametrize("arch,shape", [("glm4-9b", "decode_32k"),
                                        ("olmoe-1b-7b", "prefill_32k"),
                                        ("zamba2-2.7b", "long_500k")])
def test_run_cell_full_config(arch, shape, tmp_path):
    rec = dr.run_cell(arch, shape, multi_pod=False, out_dir=str(tmp_path))
    _check_record(rec, arch, shape, tmp_path)
    assert rec["arg_bytes_per_device_analytic"] == \
        _port_arg_bytes(arch, shape, False)
    assert rec["params"] == get_config(arch).param_count()


def test_run_cell_train_reduced_depth(tmp_path):
    """chatglm3-6b x train_4k at the published width and 2 layers: loss,
    gradient and AdamW update on the fake mesh; the decode / prefill cells
    above cover the published depth."""
    cfg = dataclasses.replace(get_config("chatglm3-6b"), num_layers=2)
    rec = dr.run_cell("chatglm3-6b", "train_4k", multi_pod=False,
                      out_dir=str(tmp_path), cfg=cfg)
    _check_record(rec, "chatglm3-6b", "train_4k", tmp_path)
    assert rec["mode"] == "train" and rec["tokens"] == 256 * 4096
    # a step of 2 layers computes at least the layers' share of 6 N T / 256
    n_layer = (cfg.param_count() - 2 * cfg.vocab_size * cfg.d_model)
    assert rec["flops"] > 6 * n_layer * rec["tokens"] / 256


def test_skipped_cell_and_main_counts_failures(tmp_path, monkeypatch,
                                               capsys):
    rec = dr.run_cell("glm4-9b", "long_500k", multi_pod=False,
                      out_dir=str(tmp_path))
    assert "skipped" in rec
    assert not os.listdir(tmp_path)

    def boom(*a, **k):
        raise RuntimeError("no rule")
    monkeypatch.setattr(dr, "run_cell", boom)
    with pytest.raises(SystemExit) as e:
        dr.main(["--arch", "glm4-9b", "--shape", "decode_32k", "--out",
                 str(tmp_path)])
    assert e.value.code == 1
    assert "1 FAILURES" in capsys.readouterr().out


def test_shapes_are_jax_shapes():
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
