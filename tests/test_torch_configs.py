"""The port's configs against the JAX package's, and the dense configs that
run on the ported dense path.

Every registered config of the port, full and reduced, equals the JAX
package's field for field (`dataclasses.asdict`), and the registries list
the same ten names. The reduced glm4-9b, granite-20b and
granite-34b (granite: a GELU MLP, `mlp_gated=False`, and H=4 over one KV
head) give JAX's `lm_forward` logits within 1e-4 in float32 on converted
weights, and granite-20b's greedy `Server.generate` gives JAX's tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.models import transformer as JT
from repro.models.model import Model as JModel
from repro.runtime.server import Server as JServer
from repro.runtime.server import ServerConfig as JServerConfig
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import list_archs
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model as TModel
from repro_torch.runtime.server import Server as TServer
from repro_torch.runtime.server import ServerConfig as TServerConfig
from test_torch_pool import assert_state_equal
from test_torch_server import KW

PORTED = ["chatglm3-6b", "falcon-mamba-7b", "glm4-9b", "granite-20b",
          "granite-34b", "mixtral-8x7b", "olmoe-1b-7b", "qwen2-vl-72b",
          "seamless-m4t-large-v2", "zamba2-2.7b"]
DENSE = ["glm4-9b", "granite-20b", "granite-34b"]


def test_registry_lists_the_ported_configs():
    """The port registers all ten of the JAX registry's architectures."""
    assert list(list_archs()) == PORTED == list(jlist_archs())


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", PORTED)
def test_config_fields_match_jax(arch, reduced):
    want = dataclasses.asdict(jget_config(arch, reduced=reduced))
    got = dataclasses.asdict(tget_config(arch, reduced=reduced))
    assert got == want


def _models(arch):
    jm = JModel(dataclasses.replace(jget_config(arch, reduced=True),
                                    dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = TModel(dataclasses.replace(tget_config(arch, reduced=True),
                                    dtype="float32"), device="cpu")
    return jm, jp, tm, convert.from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("arch", DENSE)
def test_dense_lm_forward_matches_jax(arch):
    jm, jp, tm, tp = _models(arch)
    assert sorted(tp["layers"][0]["ffn"]) == sorted(jp["layers"]["ffn"])
    toks = np.random.default_rng(0).integers(0, 256, (2, 16)) \
        .astype(np.int32)
    jl, jaux = JT.lm_forward(jp, jm.cfg, jnp.asarray(toks))
    tl, taux = TT.lm_forward(tp, tm.cfg, torch.from_numpy(toks))
    assert np.abs(np.asarray(jl) - tl.numpy()).max() < 1e-4
    # a dense config's MoE outputs are JAX's zeros
    for key in ("moe_aux_loss", "expert_counts", "expert_counts_per_layer"):
        assert np.array_equal(np.asarray(jaux[key]), taux[key].numpy()), key
        assert taux[key].dtype == {"moe_aux_loss": torch.float32}.get(
            key, torch.int32)


def test_granite_generate_matches_jax():
    """granite-20b reduced: greedy `Server.generate` over the paged pool,
    identical tokens, reports and pool metadata."""
    jm, jp, tm, tp = _models("granite-20b")
    js, ts = JServer(jm, JServerConfig(**KW)), TServer(tm, TServerConfig(**KW))
    prompts = np.random.default_rng(1).integers(0, 256, (KW["batch"], 5)) \
        .astype(np.int32)
    jout = js.generate(jp, jnp.asarray(prompts), max_new=8)
    tout = ts.generate(tp, prompts, max_new=8)
    assert np.array_equal(np.asarray(jout), tout.numpy())
    assert js.reports == ts.reports
    assert_state_equal(js.state, ts.state, data_tol=1e-5)
