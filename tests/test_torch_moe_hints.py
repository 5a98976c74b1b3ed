"""The port's MoE sharding hints (`models/moe.py` `set_sharding_hints`),
the counterpart of the JAX package's
`test_perf_variants.py::test_moe_sharding_hints_do_not_change_math`: on
plain tensors the hints do nothing; on DTensors of a (1, 1) mesh (a
world-1 gloo group) a hint redistributes to the hinted placements, and
the hinted `moe_block` equals the unhinted one, and the plain one, bit
for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402

HINTS = {"dispatch": sh.P(None, "data", None),
         "hidden": sh.P(None, "data", "model")}


def _case():
    cfg = get_config("mixtral-8x7b", reduced=True)
    p = moe_lib.init_moe(cfg, torch.float32, torch.Generator()
                         .manual_seed(0), "cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 8, cfg.d_model)).astype(np.float32))
    return cfg, p, x


@pytest.fixture
def hints():
    moe_lib.set_sharding_hints(HINTS)
    try:
        yield HINTS
    finally:
        moe_lib.set_sharding_hints(None)


@pytest.fixture
def mesh11():
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_host_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_hints_do_nothing_on_plain_tensors(hints):
    cfg, p, x = _case()
    t = torch.ones(4, 3, 2)
    assert moe_lib._hint(t, "dispatch") is t
    hinted = moe_lib.moe_block(p, x, cfg)
    moe_lib.set_sharding_hints(None)
    base = moe_lib.moe_block(p, x, cfg)
    for a, b in zip(hinted, base):
        assert torch.equal(a, b)


def test_hinted_moe_block_bit_for_bit_on_a_1x1_mesh(mesh11):
    from torch.distributed.tensor.experimental import implicit_replication
    cfg, p, x = _case()
    base, base_aux, base_counts = moe_lib.moe_block(p, x, cfg)
    dp = sh.distribute(p, mesh11, sh._with_paths(
        lambda path, leaf: sh.param_spec(mesh11, "layers/0/moe/" + path,
                                         tuple(leaf.shape)), p),
                       src_data_rank=None)
    dx = sh.distribute_leaf(x, mesh11, sh.P("data"), src_data_rank=None)
    outs = []
    for h in (None, HINTS):
        moe_lib.set_sharding_hints(h)
        try:
            with implicit_replication():
                out, aux, counts = moe_lib.moe_block(dp, dx, cfg)
        finally:
            moe_lib.set_sharding_hints(None)
        outs.append(out.full_tensor())
        assert torch.equal(aux.full_tensor(), base_aux)
        assert torch.equal(counts.full_tensor(), base_counts)
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[1], base)


def test_a_hint_redistributes_to_its_placements(mesh11, hints):
    t = sh.distribute_leaf(torch.ones(4, 8, 6), mesh11, sh.P(),
                           src_data_rank=None)
    for name, spec in HINTS.items():
        assert moe_lib._hint(t, name).placements == \
            sh.placements(mesh11, spec)
