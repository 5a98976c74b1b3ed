"""The MoE family as a whole (olmoe-1b-7b and mixtral-8x7b, reduced): the
port's `lm_forward` / `Model.loss` / `decode_step` against the JAX
package's on weights converted from the JAX init and the same numpy
tokens (`Server.serve` on MoE: tests/test_torch_moe_serve.py).

float32 (both sides `dataclasses.replace(cfg, dtype="float32")`): logits
within 1e-4, the MoE aux loss within 1e-6, the per-layer expert counts
exactly; bfloat16 logits within 3e-2. The port reproduces the reference's
decode-vs-prefill divergence, which olmoe's prefill capacity drops cause
(tests/test_arch_smoke.py xfails on it)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro.models.model import Model as JModel
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model as TModel
from test_torch_pool import to_np

ARCHS = ["olmoe-1b-7b", "mixtral-8x7b"]
B, S = 2, 8

_CACHE = {}


def _models(arch, dtype="float32"):
    """(jax model, jax params, port model, port params)."""
    if (arch, dtype) not in _CACHE:
        jm = JModel(dataclasses.replace(jget_config(arch, reduced=True),
                                        dtype=dtype))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = TModel(dataclasses.replace(tget_config(arch, reduced=True),
                                        dtype=dtype), device="cpu")
        tp = convert.from_jax(jax.tree.map(np.asarray, jp))
        _CACHE[arch, dtype] = (jm, jp, tm, tp)
    return _CACHE[arch, dtype]


def _toks(seed, s=S):
    return np.random.default_rng(seed).integers(0, 256, (B, s)) \
        .astype(np.int32)


def _err(got, want) -> float:
    return float(np.abs(to_np(got) - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_converted_moe_leaves_keep_jax_shapes_and_dtypes(arch):
    """`convert.from_jax` unstacks the [L, ...] `moe` leaves; the port's
    own init gives the same shapes and dtypes."""
    jm, jp, tm, tp = _models(arch, "bfloat16")
    own = tm.init(torch.Generator().manual_seed(0))
    for i in range(jm.cfg.num_layers):
        for name, leaf in jp["layers"]["moe"].items():
            got = tp["layers"][i]["moe"][name]
            assert tuple(got.shape) == leaf.shape[1:], name
            assert str(got.dtype)[6:] == str(leaf.dtype), name
            assert np.array_equal(to_np(got), to_np(leaf[i]))
            assert own["layers"][i]["moe"][name].shape == got.shape
            assert own["layers"][i]["moe"][name].dtype == got.dtype
        assert "ffn" not in tp["layers"][i]
    e, d = jm.cfg.num_experts, jm.cfg.d_model
    assert tp["layers"][0]["moe"]["router"].dtype == torch.float32
    assert tuple(tp["layers"][0]["moe"]["wo"].shape) == (e, jm.cfg.moe_d_ff,
                                                         d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_matches_jax(arch, dtype):
    jm, jp, tm, tp = _models(arch, dtype)
    toks = _toks(0)
    jl, jaux = JT.lm_forward(jp, jm.cfg, jnp.asarray(toks))
    tl, taux = TT.lm_forward(tp, tm.cfg, torch.from_numpy(toks))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    assert _err(tl, jl) < (1e-4 if dtype == "float32" else 3e-2)
    per = taux["expert_counts_per_layer"]
    assert per.dtype == torch.int32
    assert tuple(per.shape) == (jm.cfg.num_layers, jm.cfg.num_experts)
    assert torch.equal(taux["expert_counts"], per.sum(0, dtype=torch.int32))
    if dtype == "float32":   # bf16 roundings may route a token elsewhere
        assert np.array_equal(np.asarray(jaux["expert_counts_per_layer"]),
                              per.numpy())
        assert abs(float(jaux["moe_aux_loss"])
                   - float(taux["moe_aux_loss"])) < 1e-6
    assert float(taux["moe_aux_loss"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_with_aux_matches_jax(arch):
    jm, jp, tm, tp = _models(arch)
    toks = _toks(1)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -2:] = -100
    jloss, jaux = jm.loss(jp, {"tokens": jnp.asarray(toks),
                               "labels": jnp.asarray(labels)})
    tloss, taux = tm.loss(tp, {"tokens": torch.from_numpy(toks),
                               "labels": torch.from_numpy(labels)})
    assert abs(float(jloss) - float(tloss)) < 1e-4
    # the loss carries 0.01 x the aux loss, as in JAX
    none = np.full_like(labels, -100)
    tz, _ = tm.loss(tp, {"tokens": torch.from_numpy(toks),
                         "labels": torch.from_numpy(none)})
    assert abs(float(tz) - 0.01 * float(taux["moe_aux_loss"])) < 1e-7


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    """Teacher-forced decode over the dense ring cache (mixtral's reduced
    sliding window of 32 wraps) from a fresh state on both sides."""
    jm, jp, tm, tp = _models(arch)
    steps = 36 if tm.cfg.sliding_window else 6
    toks = _toks(2, s=steps)
    jst, tst = jm.init_decode_state(B, steps), tm.init_decode_state(B, steps)
    step = jax.jit(jm.decode_step)
    for t in range(steps):
        jlog, jst = step(jp, jst, jnp.asarray(toks[:, t]))
        tlog, tst = tm.decode_step(tp, tst, torch.from_numpy(toks[:, t]))
        assert _err(tlog, jlog) < 1e-4, t
    assert tst["kv"]["k"].shape[2] == (tm.cfg.sliding_window or steps)
    assert np.array_equal(tst["kv"]["k_pos"].numpy(),
                          np.asarray(jst["kv"]["k_pos"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_vs_prefill_divergence_matches_jax(arch):
    """tests/test_arch_smoke.py's decode-vs-prefill comparison at B=2 x
    S=8 on both packages: the port's gap between teacher-forced decode and
    the prefill equals JAX's within 1e-4. olmoe's prefill drops tokens
    over capacity (G = 8 for 16 tokens), decode never does, so the gap
    there is far above float32 noise on both sides."""
    jm, jp, tm, tp = _models(arch)
    toks = _toks(3)
    jfull, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tfull, taux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    jst, tst = jm.init_decode_state(B, S), tm.init_decode_state(B, S)
    jd, td = [], []
    step = jax.jit(jm.decode_step)
    for t in range(S):
        lg, jst = step(jp, jst, jnp.asarray(toks[:, t]))
        jd.append(np.asarray(lg))
        lg, tst = tm.decode_step(tp, tst, torch.from_numpy(toks[:, t]))
        td.append(lg)
    jgap = np.abs(np.stack(jd, 1) - np.asarray(jfull)).max()
    tgap = (torch.stack(td, 1) - tfull).abs().max().item()
    assert abs(jgap - tgap) < 1e-4, (jgap, tgap)
    g = tmoe.capacity(B * S, tm.cfg)
    drops = (taux["expert_counts_per_layer"] - g).clamp(min=0).sum().item()
    # without drops decode reproduces the prefill; with them it cannot
    assert (tgap > 1e-2) if drops else (tgap < 1e-4), (drops, tgap)
    assert drops > 0 if arch == "olmoe-1b-7b" else drops == 0
