"""Gradients of the port's `lm_loss` against `jax.grad` of the JAX
package's, for one reduced config of each ported family (chatglm3-6b
dense, olmoe-1b-7b MoE, falcon-mamba-7b ssm, zamba2-2.7b hybrid), in
float32 (`dataclasses.replace(cfg, dtype="float32")`), weights converted
from the JAX model by `convert.from_jax` and the same numpy tokens on
both sides. The ssm and hybrid families differentiate through
`kops.mamba_scan` (its plain version and `ref.mamba_scan_bwd` on the
CPU).

Tolerance: each leaf within 1e-4 of the largest |g| of JAX's leaf (the
two run the same fp32 math in another order: the losses agree within
1e-5, and a gradient's error scales with its leaf's magnitude). The
remat policies give gradients bit for bit equal to "none"."""
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
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config as tget_config
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model as TModel

ARCHS = ["chatglm3-6b", "olmoe-1b-7b", "falcon-mamba-7b", "zamba2-2.7b"]
B, S = 2, 16
_CACHE = {}


def _setup(arch):
    """(port model, port params, tokens, labels, JAX loss, JAX grads in
    the port's layout)."""
    if arch not in _CACHE:
        jcfg = dataclasses.replace(jget_config(arch, reduced=True),
                                   dtype="float32")
        jm = JModel(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(1)
        toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
        labels = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
        labels[0, :3] = -100                     # masked labels
        jloss, jgrads = jax.value_and_grad(
            lambda p: JT.lm_loss(p, jcfg, jnp.asarray(toks),
                                 jnp.asarray(labels))[0])(jp)
        tm = TModel(dataclasses.replace(tget_config(arch, reduced=True),
                                        dtype="float32"), device="cpu")
        _CACHE[arch] = (tm, convert.from_jax(jax.tree.map(np.asarray, jp)),
                        torch.from_numpy(toks), torch.from_numpy(labels),
                        float(jloss),
                        convert.from_jax(jax.tree.map(np.asarray, jgrads)))
    return _CACHE[arch]


def _grads(tm, tp, toks, labels, remat="none"):
    leaves = tree_lib.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = TT.lm_loss(tp, tm.cfg, toks, labels, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return float(loss.detach()), grads


def _plain_grads(arch):
    """`_grads` of `arch` with remat "none", computed once."""
    if ("none", arch) not in _CACHE:
        tm, tp, toks, labels, _, _ = _setup(arch)
        _CACHE["none", arch] = _grads(tm, tp, toks, labels)
    return _CACHE["none", arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax(arch):
    tm, tp, toks, labels, jloss, jgrads = _setup(arch)
    loss, grads = _plain_grads(arch)
    assert abs(loss - jloss) < 1e-5
    names, want = tree_lib.flatten_with_paths(jgrads)
    assert tree_lib.flatten_with_paths(tp)[0] == names
    assert len(grads) == len(want) > 5
    for name, g, w in zip(names, grads, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        scale = max(w.abs().max().item(), 1e-30)
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * scale, (name, err, scale)
    # the scan carries gradient to every mamba parameter (its inputs)
    for name, g in zip(names, grads):
        if "/m/" in name:
            assert g.abs().max().item() > 0, name


@pytest.mark.parametrize("remat", ["full", "dots", "everything"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_the_same_grads(arch, remat):
    tm, tp, toks, labels, _, _ = _setup(arch)
    loss0, g0 = _plain_grads(arch)
    loss1, g1 = _grads(tm, tp, toks, labels, remat=remat)
    assert loss0 == loss1
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_unknown_remat_raises():
    tm, tp, toks, labels, _, _ = _setup("chatglm3-6b")
    with pytest.raises(ValueError, match="remat"):
        TT.lm_loss(tp, tm.cfg, toks, labels, remat="some")
    with pytest.raises(ValueError, match="remat"):
        TModel(tm.cfg, remat="some", device="cpu")


def test_mamba2_grads_stay_finite_where_exp_overflows():
    """A departure from the JAX package, on purpose: its SSD block takes
    exp(cum_l - cum_m) over the whole [L, L] chunk and masks the output,
    so where the masked exponent overflows (a chunk whose decay sums past
    88, as zamba2-2.7b's full-size blocks reach in training) its gradient
    is inf * 0 = nan; the port masks the exponent. The forward is the
    same to float32 rounding (within 1e-4), and the port's gradient is
    finite."""
    from repro.models import ssm as jssm
    from repro_torch.models import ssm as tssm
    jcfg = dataclasses.replace(jget_config("zamba2-2.7b", reduced=True),
                               dtype="float32")
    tcfg = dataclasses.replace(tget_config("zamba2-2.7b", reduced=True),
                               dtype="float32")
    jp = jssm.init_mamba2(jax.random.PRNGKey(0), jcfg, jnp.float32)
    # large decays: A = exp(6) and dt near 1 sum past 88 within a chunk
    jp = dict(jp, A_log=jnp.full_like(jp["A_log"], 6.0),
              dt_bias=jnp.full_like(jp["dt_bias"], 1.0))
    tp = convert.from_jax({"mamba": jax.tree.map(
        lambda x: np.asarray(x)[None, None], jp)})["mamba"][0][0]
    x = np.random.default_rng(0).normal(size=(2, 32, jcfg.d_model)) \
        .astype(np.float32)
    jy, jvjp = jax.vjp(lambda xx: jssm.mamba2_forward(jp, xx, jcfg,
                                                      chunk=16)[0],
                       jnp.asarray(x))
    jg = np.asarray(jvjp(jnp.ones_like(jy))[0])
    assert np.isnan(jg).any()                    # JAX's gradient
    xt = torch.from_numpy(x).requires_grad_()
    ty = tssm.mamba2_forward(tp, xt, tcfg, chunk=16)[0]
    tg, = torch.autograd.grad(ty.sum(), xt)
    assert np.abs(ty.detach().numpy() - np.asarray(jy)).max() < 1e-4
    assert torch.isfinite(tg).all()
