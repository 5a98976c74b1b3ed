"""The port's attention against the JAX package's, on the same numpy inputs:
the flash_attention plain version, and a plain emulation of the rounding of
the tensor-core flash kernel, against the JAX wrapper (the Pallas kernel
in interpret mode) over the sweep of tests/test_kernels.py; the rule that
picks the flash kernel; and `full_attention`, `blockwise_attention` and
`decode_attention` against their JAX counterparts. Tolerances: 2e-5 in
float32 (the same fp32 math in another summation order), 2e-2 in bfloat16
(one bf16 rounding of the output, plus bf16 products or probabilities
where one side takes them)."""
import functools

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


@functools.lru_cache(maxsize=None)
def _pallas_flash(b, s, h, kv, d, causal, window, dtype):
    """(torch inputs, the JAX wrapper's output as float32 numpy) for one
    case of the sweep, computed once per test process."""
    j, t = _both(_flash_inputs(b, s, h, kv, d, seed=s + d), dtype)
    want = jops.flash_attention(*j, causal=causal, window=window)
    return t, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("b,s,h,kv,d", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas(b, s, h, kv, d, causal, window, dtype):
    t, want = _pallas_flash(b, s, h, kv, d, causal, window, dtype)
    got = tops.flash_attention(*t, causal=causal, window=window)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, s, h, d)
    assert _err(got, want) < TOL[dtype]


def _tensor_core_flash(q, k, v, causal, window, bk=128):
    """The rounding of `flash_attention_wgmma.cu` in plain torch: bf16 q,
    k, v; fp32 scores with the scale applied after the product; an online
    softmax over tiles of `bk` keys in fp32 (the sum of the unrounded
    probabilities); P rounded to bf16 before P.V; fp32 accumulation; the
    output rounded to bf16. (The kernel skips wholly masked tiles, which
    gives the same result.)"""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qf = q.float().reshape(b, s, kv, h // kv, d)
    kf, vf = k.float(), v.float()
    pos = torch.arange(s)
    m = torch.full((b, kv, h // kv, s), tattn.NEG_INF)
    l = torch.zeros((b, kv, h // kv, s))
    acc = torch.zeros((b, kv, h // kv, s, d))
    for j0 in range(0, s, bk):
        j = pos[j0:j0 + bk]
        sc = torch.einsum("bskrd,btkd->bkrst", qf, kf[:, j0:j0 + bk]) \
            * d ** -0.5
        ok = torch.ones((s, j.numel()), dtype=torch.bool)
        if causal:
            ok &= j[None] <= pos[:, None]
        if window > 0:
            ok &= j[None] > pos[:, None] - window
        sc = torch.where(ok, sc, tattn.NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkrst,btkd->bkrsd", p.bfloat16().float(), vf[:, j0:j0 + bk])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).bfloat16()


@pytest.mark.parametrize("b,s,h,kv,d", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
def test_flash_tensor_core_rounding_matches_pallas(b, s, h, kv, d, causal,
                                                   window):
    """The precision chosen for the tensor-core kernel (bf16 P into P.V)
    holds the bf16 tolerance against the TPU kernel's fp32 P."""
    t, want = _pallas_flash(b, s, h, kv, d, causal, window, "bfloat16")
    got = _tensor_core_flash(*t, causal, window)
    assert _err(got, want) < TOL["bfloat16"]


_B, _S, _H, _KV = 2, 256, 32, 2


def _contiguous(d):
    """(pointers, strides) of contiguous bf16 q [B,S,H,D], k, v
    [B,S,KV,D] at 16-byte-aligned bases: the model's `_qkv` outputs."""
    q_st = (_S * _H * d, _H * d, d)
    kv_st = (_S * _KV * d, _KV * d, d)
    return (4096, 8192, 12288), q_st + kv_st + kv_st


@pytest.mark.parametrize("dtype,d,ptr_offset,stride_fix,want", [
    (torch.bfloat16, 128, 0, None, tops.TENSOR_CORES),   # chatglm3-6b
    (torch.bfloat16, 64, 0, None, tops.TENSOR_CORES),
    (torch.bfloat16, 16, 0, None, tops.TENSOR_CORES),
    (torch.bfloat16, 96, 0, None, tops.TENSOR_CORES),
    (torch.float32, 128, 0, None, tops.CUDA_CORES),      # fp32 keeps 2e-5
    (torch.bfloat16, 136, 0, None, tops.CUDA_CORES),     # D > 128
    (torch.bfloat16, 256, 0, None, tops.CUDA_CORES),
    (torch.bfloat16, 20, 0, None, tops.CUDA_CORES),      # D % 8 != 0
    (torch.bfloat16, 128, 2, None, tops.CUDA_CORES),     # base not 16-B
    (torch.bfloat16, 128, 0, (1, 4100), tops.CUDA_CORES),  # q's pos stride
    (torch.bfloat16, 128, 0, (8, 132), tops.CUDA_CORES),   # v's head stride
    (torch.bfloat16, 128, 0, (5, 0), tops.CUDA_CORES),     # broadcast k head
    (torch.bfloat16, 128, 0, (1, 4608), tops.TENSOR_CORES),  # fused view
])
def test_flash_variant_rule(dtype, d, ptr_offset, stride_fix, want):
    """`_flash_variant`: the tensor-core kernel takes bf16, D <= 128 with
    D % 8 == 0, 16-byte-aligned bases and positive strides that are
    multiples of 8 elements; everything else the CUDA-core kernel."""
    ptrs, strides = _contiguous(d)
    ptrs = (ptrs[0] + ptr_offset,) + ptrs[1:]
    if stride_fix is not None:
        i, value = stride_fix
        strides = strides[:i] + (value,) + strides[i + 1:]
    assert tops._flash_variant(dtype, d, ptrs, strides) == want


def test_flash_variant_rule_on_real_views():
    """The rule read off tensors: a fused projection's q/k/v views (the
    tensor cores) and a view one element off its base (the CUDA cores)."""
    b, s, h, kv, d = _B, 128, 8, 2, 64
    fused = torch.zeros((b, s, (h + 2 * kv) * d), dtype=torch.bfloat16)
    views = (fused[..., :h * d].view(b, s, h, d),
             fused[..., h * d:(h + kv) * d].view(b, s, kv, d),
             fused[..., (h + kv) * d:].view(b, s, kv, d))

    def rule(q, k, v):
        return tops._flash_variant(
            q.dtype, d, tuple(x.data_ptr() for x in (q, k, v)),
            tuple(st for x in (q, k, v) for st in x.stride()[:3]))
    assert fused.data_ptr() % 16 == 0
    assert rule(*views) == tops.TENSOR_CORES
    odd = torch.zeros((b, s, h * d + 1), dtype=torch.bfloat16)
    assert rule(odd[..., 1:].view(b, s, h, d), *views[1:]) == tops.CUDA_CORES


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
