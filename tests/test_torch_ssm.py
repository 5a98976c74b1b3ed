"""The port's mamba1 block (`repro_torch.models.ssm`) and the plain version
of the `mamba_scan` kernel against the JAX package, on the same numpy
inputs.

Tolerances: the plain scan against JAX's `ref.mamba_scan` and its Pallas
kernel (interpret mode) within 1e-5 (the same recurrence; XLA may fuse a
step's product and sum). `causal_conv` exactly in float32 (the same
products summed in the same order). `mamba1_forward` / `mamba1_step` on
converted weights within 1e-4 in float32 (JAX's associative scan and the
matmuls sum in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import ssm as tssm

ARCH = "falcon-mamba-7b"
# tests/test_kernels.py's sweep (b, s, c, n, chunk, ct); the port's scan
# has no chunk or channel tile
SCAN_SHAPES = [(1, 64, 8, 16, 16, 4), (2, 128, 16, 8, 64, 8),
               (1, 32, 4, 4, 32, 4)]


def _scan_inputs(b, s, c, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.3, 1.0, (b, s, c, n)).astype(np.float32)
    bb = rng.normal(size=(b, s, c, n)).astype(np.float32)
    h0 = rng.normal(size=(b, c, n)).astype(np.float32)
    return a, bb, h0


@pytest.mark.parametrize("b,s,c,n,chunk,ct", SCAN_SHAPES)
def test_mamba_scan_plain_matches_jax(b, s, c, n, chunk, ct):
    a, bb, h0 = _scan_inputs(b, s, c, n, seed=s + c)
    got_all, got_last = tref.mamba_scan(*map(torch.from_numpy, (a, bb, h0)))
    assert got_all.dtype == got_last.dtype == torch.float32
    ja, jb, jh = map(jnp.asarray, (a, bb, h0))
    for want_all, want_last in (jref.mamba_scan(ja, jb, jh),
                                jops.mamba_scan(ja, jb, jh, chunk=chunk,
                                                ct=ct)):
        assert np.abs(got_all.numpy() - np.asarray(want_all)).max() < 1e-5
        assert np.abs(got_last.numpy() - np.asarray(want_last)).max() < 1e-5


def test_mamba_scan_on_cpu_launches_nothing():
    """The wrapper takes the plain version for CPU tensors (bf16 inputs
    widened exactly), and counts no launch."""
    a, bb, h0 = _scan_inputs(2, 5, 3, 4, seed=0)
    a16, b16 = (torch.from_numpy(x).bfloat16() for x in (a, bb))
    before = dict(tops.launches)
    got = tops.mamba_scan(a16, b16, torch.from_numpy(h0))
    want = tref.mamba_scan(a16.float(), b16.float(), torch.from_numpy(h0))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tops.launches == before


def _conv_inputs(b, s, c, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, c)).astype(np.float32),
            rng.normal(size=(k, c)).astype(np.float32),
            rng.normal(size=(c,)).astype(np.float32),
            rng.normal(size=(b, k - 1, c)).astype(np.float32))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 9])
def test_causal_conv_matches_jax(with_state, s):
    x, w, bias, st = _conv_inputs(2, s, 6, 4, seed=s)
    st = st if with_state else None
    want_y, want_st = jssm.causal_conv(
        *map(jnp.asarray, (x, w, bias)),
        None if st is None else jnp.asarray(st))
    got_y, got_st = tssm.causal_conv(
        *map(torch.from_numpy, (x, w, bias)),
        None if st is None else torch.from_numpy(st))
    assert np.array_equal(got_y.numpy(), np.asarray(want_y))
    assert np.array_equal(got_st.numpy(), np.asarray(want_st))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mamba1_shapes_dtypes_and_constants(dtype):
    """Every weight at JAX's shape and dtype; D = 1 exactly; A_log =
    log(1..N) as JAX computes it under jit (XLA folds the constant,
    correctly rounded). JAX's eager init (`Model.init`) takes log(7) from
    XLA's vectorised log, one ulp above the correctly rounded value: the
    port keeps the correctly rounded one, so against that path A_log
    agrees within one ulp."""
    cfg = jget_config(ARCH, reduced=True)
    tcfg = tget_config(ARCH, reduced=True)
    jdt = jnp.dtype(dtype)
    want = jax.jit(lambda k: jssm.init_mamba1(k, cfg, jdt))(
        jax.random.PRNGKey(0))
    got = tssm.init_mamba1(tcfg, getattr(torch, dtype),
                           torch.Generator().manual_seed(0), "cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype) == f"torch.{v.dtype}", k
    assert np.array_equal(got["A_log"].numpy(), np.asarray(want["A_log"]))
    assert np.array_equal(got["D"].numpy(), np.asarray(want["D"]))
    assert not got["conv_b"].any()
    eager = np.asarray(jssm.init_mamba1(jax.random.PRNGKey(0), cfg,
                                        jdt)["A_log"])
    ulps = np.abs(got["A_log"].numpy().view(np.int32) - eager.view(np.int32))
    assert ulps.max() <= 1
    # dt_bias inverts softplus of dt in [1e-3, 1e-1], as in JAX
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert dt.min() >= 1e-3 * (1 - 1e-4) and dt.max() <= 1e-1 * (1 + 1e-4)


def _block(seed=0):
    """(jax cfg, jax layer params, port cfg, port layer params), float32."""
    jcfg = dataclasses.replace(jget_config(ARCH, reduced=True),
                               dtype="float32")
    tcfg = dataclasses.replace(tget_config(ARCH, reduced=True),
                               dtype="float32")
    jp = jssm.init_mamba1(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = convert.from_jax({"layers": jax.tree.map(
        lambda x: np.asarray(x)[None], jp)})["layers"][0]
    return jcfg, jp, tcfg, tp


def _err(got, want) -> float:
    return float(np.abs(got.float().numpy()
                        - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("s,chunk", [(16, 256), (32, 8), (1, 1)])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba1_forward_matches_jax(s, chunk, with_state):
    jcfg, jp, tcfg, tp = _block()
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    jst = tst = None
    if with_state:
        st = {k: rng.normal(size=v.shape).astype(np.float32) * 0.5
              for k, v in jssm.mamba1_init_state(jcfg, 2, jnp.float32)
              .items()}
        jst = {k: jnp.asarray(v) for k, v in st.items()}
        tst = {k: torch.from_numpy(v) for k, v in st.items()}
    jy, jnew = jssm.mamba1_forward(jp, jnp.asarray(x), jcfg, chunk=chunk,
                                   state=jst)
    ty, tnew = tssm.mamba1_forward(tp, torch.from_numpy(x), tcfg,
                                   chunk=chunk, state=tst)
    assert tuple(ty.shape) == jy.shape and ty.dtype == torch.float32
    assert _err(ty, jy) < 1e-4
    for k in ("h", "conv"):
        assert tuple(tnew[k].shape) == jnew[k].shape
        assert _err(tnew[k], jnew[k]) < 1e-4


def test_mamba1_step_matches_jax():
    """Eight decode steps from a fresh state on both sides."""
    jcfg, jp, tcfg, tp = _block(seed=1)
    jst = jssm.mamba1_init_state(jcfg, 3, jnp.float32)
    tst = tssm.mamba1_init_state(tcfg, 3, torch.float32, "cpu")
    for k in jst:
        assert tuple(tst[k].shape) == jst[k].shape
        assert str(tst[k].dtype) == f"torch.{jst[k].dtype}"
    xs = np.random.default_rng(2).normal(
        size=(8, 3, 1, jcfg.d_model)).astype(np.float32)
    for x in xs:
        jy, jst = jssm.mamba1_step(jp, jnp.asarray(x), jcfg, jst)
        ty, tst = tssm.mamba1_step(tp, torch.from_numpy(x), tcfg, tst)
        assert _err(ty, jy) < 1e-4
    for k in jst:
        assert _err(tst[k], jst[k]) < 1e-4


def test_mamba1_chunk_must_divide_seq():
    jcfg, jp, tcfg, tp = _block()
    x = np.zeros((1, 24, jcfg.d_model), np.float32)
    with pytest.raises(ValueError, match="seq 24 % chunk 16"):
        jssm.mamba1_forward(jp, jnp.asarray(x), jcfg, chunk=16)
    with pytest.raises(ValueError, match="seq 24 % chunk 16"):
        tssm.mamba1_forward(tp, torch.from_numpy(x), tcfg, chunk=16)
    # S <= chunk runs as one chunk
    y, _ = tssm.mamba1_forward(tp, torch.from_numpy(x), tcfg, chunk=32)
    assert y.shape == (1, 24, jcfg.d_model)
