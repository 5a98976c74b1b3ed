"""The port's mamba2 (SSD) block (`repro_torch.models.ssm`) against the JAX
package's, on the same numpy inputs, at zamba2-2.7b reduced's widths
(d_model 64, Din 128, two heads of 64 channels, N 16).

Tolerances: `mamba2_forward` / `mamba2_step` on converted weights within
1e-4 in float32 (the same math; the products are contracted in another
order and the carry runs in `mamba_scan`'s plain version instead of
`lax.scan`). The carry alone, `kops.mamba_scan` on the CPU against JAX's
scan body, within 1e-6 (the same product and sum per step; XLA may fuse
them). The init's shapes and dtypes exactly, its constants as stated."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import get_config as jget_config
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import ssm as tssm

ARCH = "zamba2-2.7b"


def _cfgs():
    return (dataclasses.replace(jget_config(ARCH, reduced=True),
                                dtype="float32"),
            dataclasses.replace(tget_config(ARCH, reduced=True),
                                dtype="float32"))


def _block(seed=0):
    """(jax cfg, jax block params, port cfg, port block params), float32;
    the port's converted through `convert.from_jax`'s [G, per] path."""
    jcfg, tcfg = _cfgs()
    jp = jssm.init_mamba2(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = convert.from_jax({"mamba": jax.tree.map(
        lambda x: np.asarray(x)[None, None], jp)})["mamba"][0][0]
    return jcfg, jp, tcfg, tp


def _err(got, want) -> float:
    return float(np.abs(got.float().numpy()
                        - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mamba2_shapes_dtypes_and_constants(dtype):
    """Every weight at JAX's shape and dtype; D = 1, the norm's scale and
    conv_b zero; A_log = log U(1, 16) and dt_bias the inverse softplus of
    dt in [1e-3, 1e-1], one per head, as in JAX."""
    jcfg, tcfg = (jget_config(ARCH, reduced=True),
                  tget_config(ARCH, reduced=True))
    want = jssm.init_mamba2(jax.random.PRNGKey(0), jcfg, jnp.dtype(dtype))
    got = tssm.init_mamba2(tcfg, getattr(torch, dtype),
                           torch.Generator().manual_seed(0), "cpu")
    assert tssm.MAMBA2_HEADDIM == jssm.MAMBA2_HEADDIM == 64
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype) == f"torch.{v.dtype}", k
    assert np.array_equal(got["D"].numpy(), np.asarray(want["D"]))
    assert not got["norm"].any() and not got["conv_b"].any()
    a = got["A_log"].exp()
    assert a.min() >= 1.0 and a.max() <= 16.0
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert dt.min() >= 1e-3 * (1 - 1e-4) and dt.max() <= 1e-1 * (1 + 1e-4)
    # the scales: in_proj d^-0.5, conv_w 0.2, out_proj Din^-0.5
    d, din = tcfg.d_model, tcfg.d_model * tcfg.ssm_expand
    for k, scale in (("in_proj", d ** -0.5), ("conv_w", 0.2),
                     ("out_proj", din ** -0.5)):
        assert abs(got[k].float().std().item() / scale - 1) < 0.15, k


def _state(jcfg, rng, batch):
    st = {k: rng.normal(size=v.shape).astype(np.float32) * 0.5
          for k, v in jssm.mamba2_init_state(jcfg, batch, jnp.float32)
          .items()}
    return ({k: jnp.asarray(v) for k, v in st.items()},
            {k: torch.from_numpy(v) for k, v in st.items()})


@pytest.mark.parametrize("s,chunk", [(16, 4), (8, 128), (1, 1)])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_forward_matches_jax(s, chunk, with_state):
    jcfg, jp, tcfg, tp = _block()
    rng = np.random.default_rng(s + chunk)
    x = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    jst, tst = _state(jcfg, rng, 2) if with_state else (None, None)
    jy, jnew = jssm.mamba2_forward(jp, jnp.asarray(x), jcfg, chunk=chunk,
                                   state=jst)
    ty, tnew = tssm.mamba2_forward(tp, torch.from_numpy(x), tcfg,
                                   chunk=chunk, state=tst)
    assert tuple(ty.shape) == jy.shape and ty.dtype == torch.float32
    assert _err(ty, jy) < 1e-4
    for k in ("h", "conv"):
        assert tuple(tnew[k].shape) == jnew[k].shape, k
        assert _err(tnew[k], jnew[k]) < 1e-4, k


def test_mamba2_carry_runs_in_mamba_scan(monkeypatch):
    """The carry across chunks goes through `kops.mamba_scan` (looked up on
    the module at each call), once a call, with a = each chunk's decay
    broadcast over (n, p) and b = its final state, [B, NC, N, H*P]."""
    jcfg, jp, tcfg, tp = _block(seed=3)
    calls = []

    def spy(a, b, h0):
        calls.append((tuple(a.shape), tuple(b.shape), tuple(h0.shape),
                      a.is_contiguous() and b.is_contiguous()))
        return tref.mamba_scan(a, b, h0)
    monkeypatch.setattr(tops, "mamba_scan", spy)
    x = np.random.default_rng(4).normal(size=(2, 16, jcfg.d_model)) \
        .astype(np.float32)
    tssm.mamba2_forward(tp, torch.from_numpy(x), tcfg, chunk=4)
    lanes = tcfg.d_model * tcfg.ssm_expand
    n = tcfg.ssm_state_dim
    assert calls == [((2, 4, n, lanes), (2, 4, n, lanes), (2, n, lanes),
                      True)]


def test_mamba_scan_carry_matches_jax_scan_body():
    """The chunk carry on the CPU through the wrapper (its plain version)
    against the JAX package's `lax.scan` body, h = dec * h + snew, at the
    carry's layout: h_prevs (each chunk's starting state) and h_last."""
    rng = np.random.default_rng(5)
    b, nc, n, nh, p = 2, 6, 16, 2, 64
    dec = rng.uniform(0.2, 1.0, (b, nc, nh)).astype(np.float32)
    snew = rng.normal(size=(b, nc, n, nh, p)).astype(np.float32)
    h0 = rng.normal(size=(b, n, nh, p)).astype(np.float32)

    def body(h, xs):
        d, s_ = xs
        return d[:, None, :, None] * h + s_, h
    want_last, want_prevs = jax.lax.scan(
        body, jnp.asarray(h0), (jnp.moveaxis(jnp.asarray(dec), 1, 0),
                                jnp.moveaxis(jnp.asarray(snew), 1, 0)))
    want_prevs = np.moveaxis(np.asarray(want_prevs), 0, 1)

    a = torch.from_numpy(dec)[:, :, None, :, None] \
        .expand(b, nc, n, nh, p).reshape(b, nc, n, nh * p).contiguous()
    h0_t = torch.from_numpy(h0).reshape(b, n, nh * p)
    before = dict(tops.launches)
    h_all, h_last = tops.mamba_scan(
        a, torch.from_numpy(snew).reshape(b, nc, n, nh * p), h0_t)
    assert tops.launches == before   # CPU tensors: the plain version
    prevs = torch.cat([h0_t[:, None], h_all[:, :-1]], 1) \
        .reshape(b, nc, n, nh, p)
    assert _err(prevs, want_prevs) < 1e-6
    assert _err(h_last.reshape(b, n, nh, p), want_last) < 1e-6


def test_mamba2_step_and_init_state_match_jax():
    """Eight decode steps from a fresh state on both sides: the state's
    layout and dtypes, every step's output and the final state."""
    jcfg, jp, tcfg, tp = _block(seed=1)
    jst = jssm.mamba2_init_state(jcfg, 3, jnp.float32)
    tst = tssm.mamba2_init_state(tcfg, 3, torch.float32, "cpu")
    bst = tssm.mamba2_init_state(tcfg, 3, torch.bfloat16, "cpu")
    for k in jst:
        assert tuple(tst[k].shape) == jst[k].shape, k
        assert str(tst[k].dtype) == f"torch.{jst[k].dtype}", k
        assert not tst[k].any()
    assert bst["h"].dtype == torch.float32 and \
        bst["conv"].dtype == torch.bfloat16
    xs = np.random.default_rng(2).normal(
        size=(8, 3, 1, jcfg.d_model)).astype(np.float32)
    for x in xs:
        jy, jst = jssm.mamba2_step(jp, jnp.asarray(x), jcfg, jst)
        ty, tst = tssm.mamba2_step(tp, torch.from_numpy(x), tcfg, tst)
        assert _err(ty, jy) < 1e-4
    for k in jst:
        assert _err(tst[k], jst[k]) < 1e-4, k


def test_mamba2_chunk_must_divide_seq():
    jcfg, jp, tcfg, tp = _block()
    x = np.zeros((1, 24, jcfg.d_model), np.float32)
    with pytest.raises(ValueError, match="seq 24 % chunk 16"):
        jssm.mamba2_forward(jp, jnp.asarray(x), jcfg, chunk=16)
    with pytest.raises(ValueError, match="seq 24 % chunk 16"):
        tssm.mamba2_forward(tp, torch.from_numpy(x), tcfg, chunk=16)
    # S <= chunk runs as one chunk
    y, _ = tssm.mamba2_forward(tp, torch.from_numpy(x), tcfg, chunk=32)
    assert y.shape == (1, 24, jcfg.d_model)
