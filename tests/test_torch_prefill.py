"""The slice as a whole: the port's full-sequence path (`lm_forward`,
`lm_loss`, `Model.forward` / `prefill` / `loss`) and dense ring-cache
decode (`Model.decode_step`) against the JAX package's, chatglm3-6b
reduced, weights converted from the JAX model by `repro_torch.convert`,
the same numpy tokens on both sides.

Tolerances: float32 (both sides `dataclasses.replace(cfg, dtype=
"float32")`) logits, caches and hiddens within 1e-4 (the same math in
another summation order, through two layers and the logits head). In
bfloat16 the two frameworks round products and casts at different
places, and a one-ulp flip in layer 0 carries into layer 1: logits within
3e-2 (as tests/test_torch_server.py), the K/V cache and the hiddens
within two bf16 ulps of the tensor's largest magnitude (2**-6 * max|x|)."""
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
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model as TModel

ARCH = "chatglm3-6b"
B, S = 2, 16
TOL = {"float32": dict(logits=1e-4, cache=1e-4),
       "bfloat16": dict(logits=3e-2, cache=None)}

_CACHE = {}


def _models(dtype, attn_impl="blockwise"):
    """(jax model, jax params, port model, port params)."""
    if dtype not in _CACHE:
        jcfg = dataclasses.replace(jget_config(ARCH, reduced=True),
                                   dtype=dtype)
        jp = JModel(jcfg).init(jax.random.PRNGKey(0))
        _CACHE[dtype] = (jp, convert.from_jax(jax.tree.map(np.asarray, jp)))
    jp, tp = _CACHE[dtype]
    jm = JModel(dataclasses.replace(jget_config(ARCH, reduced=True),
                                    dtype=dtype), attn_impl=attn_impl)
    tm = TModel(dataclasses.replace(tget_config(ARCH, reduced=True),
                                    dtype=dtype), attn_impl=attn_impl,
                device="cpu")
    return jm, jp, tm, tp


def _toks(seed=0, s=S):
    return np.random.default_rng(seed).integers(0, 256, (B, s)) \
        .astype(np.int32)


def _err(got: torch.Tensor, want) -> float:
    return float(np.abs(got.float().numpy()
                        - np.asarray(jnp.asarray(want, jnp.float32))).max())


def _cache_close(got: torch.Tensor, want, dtype) -> bool:
    """K/V cache or hiddens within the dtype's tolerance (module doc)."""
    tol = TOL[dtype]["cache"]
    if tol is None:
        tol = 2 ** -6 * float(jnp.abs(jnp.asarray(want, jnp.float32)).max())
    return _err(got, want) < tol


@pytest.mark.parametrize("attn_impl", ["full", "blockwise", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_forward_matches_jax(attn_impl, dtype):
    """Logits, the returned K/V cache and the post-layer hiddens."""
    jm, jp, tm, tp = _models(dtype)
    toks = _toks()
    kw = dict(attn_impl=attn_impl, return_cache=True, return_hiddens=True)
    jl, jaux = JT.lm_forward(jp, jm.cfg, jnp.asarray(toks), **kw)
    tl, taux = TT.lm_forward(tp, tm.cfg, torch.from_numpy(toks), **kw)
    tol = TOL[dtype]
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    assert _err(tl, jl) < tol["logits"]
    for got, want in zip(taux["kv_cache"], jaux["kv_cache"]):
        assert tuple(got.shape) == want.shape
        assert _cache_close(got, want, dtype)
    assert tuple(taux["hiddens"].shape) == jaux["hiddens"].shape
    assert _cache_close(taux["hiddens"], jaux["hiddens"], dtype)
    # a dense config has no MoE aux loss: zero on both sides
    assert float(jaux["moe_aux_loss"]) == float(taux["moe_aux_loss"]) == 0.0


def test_flash_ignores_explicit_positions_like_jax():
    """With attn_impl="flash" both packages take the positions for the
    rotary embedding only and mask by tile position: offset and permuted
    positions give the same logits on both sides, while the oracle path
    (which masks by the positions) sees another mask."""
    jm, jp, tm, tp = _models("float32")
    toks = _toks(seed=1)
    perm = np.random.default_rng(2).permutation(S)
    for pos in (np.arange(S)[None] + np.array([[3], [11]]),
                np.broadcast_to(perm[None], (B, S))):
        pos = np.ascontiguousarray(pos, np.int32)
        jl, _ = JT.lm_forward(jp, jm.cfg, jnp.asarray(toks),
                              positions=jnp.asarray(pos), attn_impl="flash")
        tl, _ = TT.lm_forward(tp, tm.cfg, torch.from_numpy(toks),
                              positions=torch.from_numpy(pos),
                              attn_impl="flash")
        assert _err(tl, jl) < TOL["float32"]["logits"]
    full, _ = TT.lm_forward(tp, tm.cfg, torch.from_numpy(toks),
                            positions=torch.from_numpy(pos),
                            attn_impl="full")
    assert (full - tl).abs().max().item() > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_with_masked_labels_matches_jax(dtype):
    jm, jp, tm, tp = _models(dtype, attn_impl="flash")
    toks = _toks(seed=3)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -100
    labels[0, :5] = -100
    jloss, _ = jm.loss(jp, {"tokens": jnp.asarray(toks),
                            "labels": jnp.asarray(labels)})
    tloss, _ = tm.loss(tp, {"tokens": torch.from_numpy(toks),
                            "labels": torch.from_numpy(labels)})
    assert tloss.shape == ()
    assert abs(float(tloss) - float(jloss)) < TOL[dtype]["logits"]
    # every label masked: loss 0, as in the JAX package (denominator >= 1)
    none = np.full_like(labels, -100)
    tz, _ = tm.loss(tp, {"tokens": torch.from_numpy(toks),
                         "labels": torch.from_numpy(none)})
    assert float(tz) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_forward_prefill_decode_match_jax(dtype):
    """Model.forward / prefill with flash, then four decode steps over the
    dense ring cache from a fresh state, on both sides."""
    jm, jp, tm, tp = _models(dtype, attn_impl="flash")
    toks = _toks(seed=4)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert _err(tl, jl) < TOL[dtype]["logits"]
    assert torch.equal(tm.prefill(tp, {"tokens": torch.from_numpy(toks)}),
                       tl)
    jst = jm.init_decode_state(B, 8)
    tst = tm.init_decode_state(B, 8)
    for name in ("k", "v", "k_pos"):
        assert tuple(tst["kv"][name].shape) == jst["kv"][name].shape
    for t in range(4):
        jlog, jst = jm.decode_step(jp, jst, jnp.asarray(toks[:, t]))
        tlog, tst = tm.decode_step(tp, tst, torch.from_numpy(toks[:, t]))
        assert _err(tlog, jlog) < TOL[dtype]["logits"]
    assert tst["pos"] == int(jst["pos"]) == 4
    assert np.array_equal(tst["kv"]["k_pos"].numpy(),
                          np.asarray(jst["kv"]["k_pos"]))
    assert _cache_close(tst["kv"]["k"], jst["kv"]["k"], dtype)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_reproduces_flash_prefill(window):
    """Teacher-forced decode reproduces the port's own flash prefill logits
    (the KV-cache check of tests/test_arch_smoke.py), and the post-layer
    hiddens agree layer by layer. window=5 runs the ring buffer (C=5) and
    the kernel's sliding window."""
    _, _, tm, tp = _models("float32", attn_impl="flash")
    tm.cfg = dataclasses.replace(tm.cfg, sliding_window=window)
    toks = torch.from_numpy(_toks(seed=5))
    full, aux = TT.lm_forward(tp, tm.cfg, toks, attn_impl="flash",
                              return_hiddens=True)
    state = tm.init_decode_state(B, S)
    logits, hs = [], []
    for t in range(S):
        lg, state, h = tm.decode_step(tp, state, toks[:, t],
                                      return_hiddens=True)
        logits.append(lg)
        hs.append(h)
    assert state["kv"]["k"].shape[2] == (window or S)
    assert (torch.stack(logits, 1) - full).abs().max().item() < 1e-4
    assert (torch.cat(hs, 2) - aux["hiddens"]).abs().max().item() < 1e-4


def test_unported_options_raise():
    _, _, tm, tp = _models("float32")
    toks = torch.from_numpy(_toks())
    # every remat policy of JAX's runs (tests/test_torch_train_grads.py);
    # another name raises
    with pytest.raises(ValueError, match="remat"):
        TT.lm_forward(tp, tm.cfg, toks, remat="nothing_saveable")
    # extra_embeds (the VLM stub's patch embeddings) are prepended, for
    # any attention model, as in JAX (tests/test_torch_mrope.py holds the
    # VLM against JAX)
    lg, _ = TT.lm_forward(tp, tm.cfg, toks, extra_embeds=torch.zeros(B, 2, 64))
    assert lg.shape == (B, toks.shape[1] + 2, tm.cfg.vocab_size)
    with pytest.raises(ValueError, match="attn_impl"):
        TModel(tm.cfg, attn_impl="ring", device="cpu")
    with pytest.raises(ValueError, match="S=200"):
        TT.lm_forward(tp, tm.cfg, torch.from_numpy(_toks(s=200)),
                      attn_impl="flash")


def test_model_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TModel(tget_config(ARCH, reduced=True), attn_impl="flash")
