"""The port's attention against the JAX package's, on the same numpy inputs:
the flash_attention plain version against the JAX wrapper (the Pallas
kernel in interpret mode) over the sweep of tests/test_kernels.py, and
`full_attention`, `blockwise_attention` and `decode_attention` against
their JAX counterparts. Tolerances: 2e-5 in float32 (the same fp32 math in
another summation order), 2e-2 in bfloat16 (one bf16 rounding of the
output, plus bf16 products where the JAX function takes them)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from test_torch_gpu import FLASH_MASKS, FLASH_SHAPES, _flash_inputs

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _both(arrays, dtype):
    """numpy float32 arrays -> (jax arrays, torch tensors) in `dtype`,
    rounded once (bf16 bits identical on both sides)."""
    j = [jnp.asarray(a).astype(dtype) for a in arrays]
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype)) for x in j]
    return j, t


def _err(got: torch.Tensor, want) -> float:
    return float(np.abs(got.float().numpy()
                        - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("b,s,h,kv,d", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas(b, s, h, kv, d, causal, window, dtype):
    j, t = _both(_flash_inputs(b, s, h, kv, d, seed=s + d), dtype)
    want = jops.flash_attention(*j, causal=causal, window=window)
    got = tops.flash_attention(*t, causal=causal, window=window)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, s, h, d)
    assert _err(got, want) < TOL[dtype]


def test_flash_wrapper_refuses_s_200_on_cpu():
    q, k, v = map(torch.from_numpy, _flash_inputs(1, 200, 4, 2, 16, seed=0))
    with pytest.raises(ValueError, match="S=200"):
        tops.flash_attention(q, k, v)


def _attn_inputs(b, sq, sk, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]


@pytest.mark.parametrize("causal,window,softcap", [(True, 0, 0.0),
                                                   (True, 5, 0.0),
                                                   (False, 0, 0.0),
                                                   (True, 0, 3.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_attention_matches(causal, window, softcap, dtype):
    j, t = _both(_attn_inputs(2, 12, 12, 4, 2, 16, seed=1), dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    assert _err(tattn.full_attention(*t, **kw),
                jattn.full_attention(*j, **kw)) < TOL[dtype]


@pytest.mark.parametrize("sk,chunk", [(16, 8), (13, 4), (20, 512)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 6), (False, 0)])
def test_blockwise_attention_matches(sk, chunk, causal, window):
    """Key lengths that are and are not multiples of the chunk (padded keys
    at position 2**30), with explicit offset positions. Only causality masks
    the pad keys, so without causality a padded run attends to them too, in
    the JAX package as in the port; elsewhere it agrees with the oracle."""
    j, t = _both(_attn_inputs(2, sk, sk, 4, 1, 8, seed=sk), "float32")
    pos = (np.arange(sk)[None] + np.array([[0], [7]])).astype(np.int32)
    kw = dict(causal=causal, window=window, chunk=chunk)
    got = tattn.blockwise_attention(*t, q_pos=torch.from_numpy(pos),
                                    k_pos=torch.from_numpy(pos), **kw)
    want = jattn.blockwise_attention(*j, q_pos=jnp.asarray(pos),
                                     k_pos=jnp.asarray(pos), **kw)
    assert _err(got, want) < TOL["float32"]
    got_d = tattn.blockwise_attention(*t, **kw)
    assert _err(got_d, jattn.blockwise_attention(*j, **kw)) < TOL["float32"]
    if causal or sk % chunk == 0:
        assert _err(got_d, jattn.full_attention(
            *j, causal=causal, window=window)) < TOL["float32"]


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches(window, dtype):
    """A ring cache: per-lane lengths, k_pos and q_pos."""
    rng = np.random.default_rng(5)
    q, k, v = _attn_inputs(3, 1, 6, 4, 2, 16, seed=2)
    j, t = _both([q, k, v], dtype)
    lens = np.array([1, 4, 6], np.int32)
    k_pos = np.where(np.arange(6)[None] < lens[:, None],
                     rng.permutation(6)[None] + 10, -1).astype(np.int32)
    q_pos = np.array([12, 15, 16], np.int32)
    got = tattn.decode_attention(*t, torch.from_numpy(lens), window=window,
                                 k_pos=torch.from_numpy(k_pos),
                                 q_pos=torch.from_numpy(q_pos))
    want = jattn.decode_attention(*j, jnp.asarray(lens), window=window,
                                  k_pos=jnp.asarray(k_pos),
                                  q_pos=jnp.asarray(q_pos))
    assert _err(got, want) < TOL[dtype]
    # scalar cache_len, default positions
    assert _err(tattn.decode_attention(*t, 5, window=window),
                jattn.decode_attention(*j, 5, window=window)) < TOL[dtype]
