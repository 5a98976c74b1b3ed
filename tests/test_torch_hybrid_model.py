"""The slice as a whole for the hybrid family: zamba2-2.7b reduced (two
groups of one mamba2 block and the shared attention block) through the
port's `Model.forward` / `prefill` / `loss` and `init_decode_state` /
`decode_step`, against the JAX package's, with weights converted from the
JAX model by `repro_torch.convert` and the same numpy tokens on both
sides.

Tolerances, as tests/test_torch_mamba_model.py states them: float32 (both
sides `dataclasses.replace(cfg, dtype="float32")`) logits, loss and decode
states within 1e-4, greedy argmax identical; bfloat16 logits, caches and
states within two bf16 ulps of the tensor's largest magnitude (2**-6 *
max|x|), the loss within 1e-4 in float32 and within twice the logits'
bound in bfloat16 (a log-softmax moves by at most twice the largest
change of its logits). attn_impl "flash" (the kernel's plain version on
the CPU) against "blockwise" within 1e-4 in float32. The port's
teacher-forced decode against its own prefill within 0.15, the bound
tests/test_arch_smoke.py sets for the JAX package."""
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
from repro_torch.configs.base import MAMBA2, SHARED_ATTN
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model as TModel
from repro_torch.models.model import build

ARCH = "zamba2-2.7b"
B, S = 2, 16
DECODE_S = 8       # teacher-forced steps against JAX's decode_step
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


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def test_convert_nests_the_groups_and_ties_the_shared_block():
    jm, jp, tm, tp = _models("bfloat16")
    per, groups = TT._hybrid_shape(tm.cfg)
    assert (per, groups) == JT._hybrid_shape(jm.cfg) == (1, 2)
    assert set(tp) == set(jp) == {"embed", "final_ln", "out", "mamba",
                                  "shared_attn"}
    assert len(tp["mamba"]) == groups
    for g, group in enumerate(tp["mamba"]):
        assert len(group) == per
        for i, lp in enumerate(group):
            assert set(lp) == {"ln", "m"}
            for k, v in lp["m"].items():
                want = np.asarray(jp["mamba"]["m"][k][g, i])
                assert tuple(v.shape) == want.shape and v.is_contiguous()
                assert np.array_equal(_bits(v), _bits(want)), k
    for k, v in convert._convert(jax.tree.map(np.asarray, jp["shared_attn"]),
                                 "cpu").items():
        got = tp["shared_attn"][k]
        for name, leaf in (v.items() if isinstance(v, dict) else [(k, v)]):
            mine = got[name] if isinstance(v, dict) else got
            assert np.array_equal(_bits(mine), _bits(leaf)), name
    # the port's own init has the converted weights' structure
    own = tm.init(torch.Generator().manual_seed(0))

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [layout(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)
    assert layout(own) == layout(tp)


def test_build_and_the_families_check():
    m = build(ARCH, reduced=True, device="cpu", attn_impl="flash")
    assert m.cfg.family == "hybrid" and m.attn_impl == "flash"
    cfg = m.cfg
    assert set(cfg.blocks) == {MAMBA2, SHARED_ATTN}
    # a group count that does not divide the layers, or a foreign block,
    # is refused
    for bad in (dataclasses.replace(cfg, num_layers=5),
                dataclasses.replace(cfg, block_pattern=("mamba1",) * 4),
                dataclasses.replace(cfg, shared_attn_every=0)):
        with pytest.raises(NotImplementedError, match="not ported"):
            TModel(bad, device="cpu").init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("dtype,s", [("float32", S), ("bfloat16", S),
                                     ("float32", 256)])
def test_forward_prefill_loss_match_jax(dtype, s):
    """S = 256 runs two SSD chunks of 128 in every mamba2 block."""
    jm, jp, tm, tp = _models(dtype)
    toks = _toks(s=s)
    jl, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    assert np.abs(_np(tl) - _np(jl)).max() < _tol(dtype, jl)
    assert set(aux) == set(jaux) == {"moe_aux_loss", "expert_counts"}
    for k in aux:
        assert tuple(aux[k].shape) == jaux[k].shape
        assert str(aux[k].dtype) == f"torch.{jaux[k].dtype}"
        assert np.array_equal(aux[k].numpy(), np.asarray(jaux[k]))
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
    tol = 1e-4 if dtype == "float32" else 2 * _tol(dtype, jl)
    assert abs(float(tloss) - float(jloss)) < tol


def test_init_decode_state_layout_matches_jax():
    for dtype in ("float32", "bfloat16"):
        jm, _, tm, _ = _models(dtype)
        jst = jm.init_decode_state(B, 24)
        tst = tm.init_decode_state(B, 24)
        assert set(tst) == set(jst) == {"pos", "ssm", "kv"}
        assert tst["pos"] == int(jst["pos"]) == 0
        for part in ("ssm", "kv"):
            assert set(tst[part]) == set(jst[part])
            for k, v in jst[part].items():
                got = tst[part][k]
                assert tuple(got.shape) == v.shape, (part, k)
                assert str(got.dtype) == f"torch.{v.dtype}", (part, k)
                assert np.array_equal(_np(got), _np(v)), (part, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(dtype):
    """Teacher-forced decode from a fresh state: logits every step, then
    the mamba2 states, the shared block's caches and pos after the last."""
    jm, jp, tm, tp = _models(dtype)
    toks = _toks(seed=1, s=DECODE_S)
    jst = jm.init_decode_state(B, DECODE_S)
    tst = tm.init_decode_state(B, DECODE_S)
    for t in range(DECODE_S):
        jlog, jst = jm.decode_step(jp, jst, jnp.asarray(toks[:, t]))
        tlog, tst = tm.decode_step(tp, tst, torch.from_numpy(toks[:, t]))
        assert np.abs(_np(tlog) - _np(jlog)).max() < _tol(dtype, jlog)
    assert tst["pos"] == int(jst["pos"]) == DECODE_S
    for part in ("ssm", "kv"):
        for k, v in jst[part].items():
            if k == "k_pos":
                assert np.array_equal(tst[part][k].numpy(), np.asarray(v))
            else:
                assert np.abs(_np(tst[part][k]) - _np(v)).max() < \
                    _tol(dtype, v), (part, k)


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


@pytest.mark.parametrize("s", [S, 256])
def test_flash_matches_blockwise(s):
    """The shared block through `kops.flash_attention` (its plain version
    on the CPU) against blockwise attention, and against JAX's flash path
    (its Pallas kernel in interpret mode) at the short length."""
    jm, jp, tm, tp = _models("float32")
    toks = _toks(seed=3, s=s)
    flash = TModel(tm.cfg, attn_impl="flash", device="cpu")
    lf, _ = flash.forward(tp, {"tokens": torch.from_numpy(toks)})
    lb, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert (lf - lb).abs().max().item() < 1e-4
    if s == S:
        jl, _ = JT.lm_forward(jp, jm.cfg, jnp.asarray(toks),
                              attn_impl="flash")
        assert np.abs(_np(lf) - _np(jl)).max() < 1e-4


def test_unported_options_raise():
    _, _, tm, tp = _models("float32")
    toks = torch.from_numpy(_toks())
    with pytest.raises(ValueError, match="attn-family layers only"):
        TT.lm_forward(tp, tm.cfg, toks, return_hiddens=True)
    with pytest.raises(ValueError, match="attn-family layers only"):
        TT.lm_decode_step(tp, tm.cfg, tm.init_decode_state(B, S), toks[:, 0],
                          return_hiddens=True)
    _, aux = TT.lm_forward(tp, tm.cfg, toks, return_cache=True)
    assert aux["kv_cache"] is None
    # every remat policy of JAX's runs (tests/test_torch_train_grads.py);
    # another name raises
    with pytest.raises(ValueError, match="remat"):
        TT.lm_forward(tp, tm.cfg, toks, remat="nothing_saveable")
    # S past the SSD chunk must be a multiple of it, as in JAX
    with pytest.raises(ValueError, match="chunk"):
        tm.forward(tp, {"tokens": torch.from_numpy(_toks(s=130))})
