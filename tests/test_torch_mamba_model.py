"""The slice as a whole for the ssm family: falcon-mamba-7b reduced (2
mamba1 layers) through the port's `Model.forward` / `prefill` / `loss`
and `init_decode_state` / `decode_step`, against the JAX package's, with
weights converted from the JAX model by `repro_torch.convert` and the same
numpy tokens on both sides.

Tolerances: float32 (both sides `dataclasses.replace(cfg, dtype=
"float32")`) logits, loss and decode state within 1e-4 (the same math in
another summation order), greedy argmax identical. bfloat16 logits and
states within two bf16 ulps of the tensor's largest magnitude (2**-6 *
max|x|): the two frameworks round products and casts at different places;
the bf16 loss, an fp32 mean of log-softmaxes, within 1e-4 as well. The port's teacher-forced
decode against its own prefill within 0.15, the bound
tests/test_arch_smoke.py sets for the JAX package."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import get_config as jget_config
from repro.models.model import Model as JModel
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model as TModel

ARCH = "falcon-mamba-7b"
B, S = 2, 16
_CACHE = {}


def _models(dtype):
    """(jax model, jax params, port model, port params)."""
    if dtype not in _CACHE:
        jm = JModel(dataclasses.replace(jget_config(ARCH, reduced=True),
                                        dtype=dtype))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = TModel(dataclasses.replace(tget_config(ARCH, reduced=True),
                                        dtype=dtype), device="cpu")
        _CACHE[dtype] = (jm, jp, tm,
                         convert.from_jax(jax.tree.map(np.asarray, jp)))
    return _CACHE[dtype]


def _toks(seed=0, s=S):
    return np.random.default_rng(seed).integers(0, 256, (B, s)) \
        .astype(np.int32)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tol(dtype, want) -> float:
    return 1e-4 if dtype == "float32" else 2 ** -6 * np.abs(_np(want)).max()


def test_convert_unstacks_ssm_layers():
    jm, jp, tm, tp = _models("bfloat16")
    assert len(tp["layers"]) == jm.cfg.num_layers
    for i, lp in enumerate(tp["layers"]):
        assert set(lp) == {"ln", "m"}
        for k, v in lp["m"].items():
            want = np.asarray(jp["layers"]["m"][k][i])
            assert tuple(v.shape) == want.shape and v.is_contiguous()
            assert np.array_equal(v.view(torch.int16).numpy()
                                  if v.dtype == torch.bfloat16 else v.numpy(),
                                  want.view(np.int16)
                                  if v.dtype == torch.bfloat16 else want)
    assert set(tp) == {"embed", "final_ln", "out", "layers"}
    # the port's own init has the converted weights' structure
    own = tm.init(torch.Generator().manual_seed(0))
    assert set(own) == set(tp)
    for got, want in zip(own["layers"], tp["layers"]):
        assert {k: (v.shape, v.dtype) for k, v in got["m"].items()} == \
            {k: (v.shape, v.dtype) for k, v in want["m"].items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_loss_match_jax(dtype):
    jm, jp, tm, tp = _models(dtype)
    toks = _toks()
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    assert np.abs(_np(tl) - _np(jl)).max() < _tol(dtype, jl)
    assert aux == {}
    if dtype == "float32":
        assert np.array_equal(_np(tl).argmax(-1), _np(jl).argmax(-1))
    assert torch.equal(tm.prefill(tp, {"tokens": torch.from_numpy(toks)}),
                       tl)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -2:] = -100
    jloss, _ = jm.loss(jp, {"tokens": jnp.asarray(toks),
                            "labels": jnp.asarray(labels)})
    tloss, _ = tm.loss(tp, {"tokens": torch.from_numpy(toks),
                            "labels": torch.from_numpy(labels)})
    assert tloss.shape == ()
    assert abs(float(tloss) - float(jloss)) < 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(dtype):
    """Teacher-forced decode from a fresh state: logits every step, and the
    recurrent and conv states after the last."""
    jm, jp, tm, tp = _models(dtype)
    toks = _toks(seed=1)
    jst = jm.init_decode_state(B, S)
    tst = tm.init_decode_state(B, S)
    assert set(tst) == {"pos", "ssm"}
    for k, v in jst["ssm"].items():
        assert tuple(tst["ssm"][k].shape) == v.shape
        assert str(tst["ssm"][k].dtype) == f"torch.{v.dtype}"
    for t in range(S):
        jlog, jst = jm.decode_step(jp, jst, jnp.asarray(toks[:, t]))
        tlog, tst = tm.decode_step(tp, tst, torch.from_numpy(toks[:, t]))
        assert np.abs(_np(tlog) - _np(jlog)).max() < _tol(dtype, jlog)
    assert tst["pos"] == int(jst["pos"]) == S
    for k, v in jst["ssm"].items():
        assert np.abs(_np(tst["ssm"][k]) - _np(v)).max() < _tol(dtype, v)


def test_init_decode_state_ignores_max_len():
    _, _, tm, _ = _models("float32")
    a, b = tm.init_decode_state(B, 4), tm.init_decode_state(B, 4096)
    assert all(a["ssm"][k].shape == b["ssm"][k].shape for k in a["ssm"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_reproduces_prefill(dtype):
    """The port's teacher-forced decode against its own prefill (the
    recurrent-state check of tests/test_arch_smoke.py)."""
    _, _, tm, tp = _models(dtype)
    toks = torch.from_numpy(_toks(seed=2))
    full = tm.prefill(tp, {"tokens": toks})
    state = tm.init_decode_state(B, S)
    logits = []
    for t in range(S):
        lg, state = tm.decode_step(tp, state, toks[:, t])
        logits.append(lg)
    assert (torch.stack(logits, 1) - full).abs().max().item() < 0.15


def test_unported_options_raise():
    _, _, tm, tp = _models("float32")
    toks = torch.from_numpy(_toks())
    with pytest.raises(ValueError, match="attn-family layers only"):
        TT.lm_forward(tp, tm.cfg, toks, return_hiddens=True)
    with pytest.raises(ValueError, match="attn-family layers only"):
        TT.lm_decode_step(tp, tm.cfg, tm.init_decode_state(B, S), toks[:, 0],
                          return_hiddens=True)
    _, aux = TT.lm_forward(tp, tm.cfg, toks, return_cache=True)
    assert aux == {"kv_cache": None}
    # every remat policy of JAX's runs (tests/test_torch_train_grads.py);
    # another name raises
    with pytest.raises(ValueError, match="remat"):
        TT.lm_forward(tp, tm.cfg, toks, remat="nothing_saveable")
    # mamba1 blocks in the hybrid family, and mamba2 blocks in the ssm
    # family, are not ported
    for bad in (dataclasses.replace(tm.cfg, family="hybrid"),
                dataclasses.replace(tm.cfg, block_pattern=("mamba2",) * 2)):
        with pytest.raises(NotImplementedError, match="not ported"):
            TModel(bad, device="cpu").init(torch.Generator().manual_seed(0))
