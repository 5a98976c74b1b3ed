"""The paged-attention plain version against the JAX kernel (Pallas,
interpret mode) at the shapes of tests/test_kernels.py (the CUDA kernels
against their plain versions on the card are in test_torch_gpu.py)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from test_torch_gpu import PA_SHAPES, _pa_inputs


@pytest.mark.parametrize("b,h,kv,d,bt,mb", PA_SHAPES)
def test_paged_attention_plain_matches_pallas(b, h, kv, d, bt, mb):
    q, kp, vp, tables, lens = _pa_inputs(b, h, kv, d, bt, mb, seed=b * d)
    want_o, want_t = jops.paged_attention(*map(jnp.asarray, (q, kp, vp,
                                                            tables, lens)))
    got_o, got_t = tops.paged_attention(*map(torch.from_numpy, (q, kp, vp,
                                                               tables, lens)))
    assert np.abs(got_o.numpy() - np.asarray(want_o)).max() < 2e-5
    assert np.array_equal(got_t.numpy(), np.asarray(want_t))


def test_paged_attention_plain_takes_strided_pool_views():
    """kvcache.attend hands the kernel pages[:, 0] / pages[:, 1] of the pool:
    strided views, never copied."""
    q, kp, vp, tables, lens = _pa_inputs(2, 8, 2, 16, 4, 6, seed=3)
    pool = torch.from_numpy(np.stack([kp, vp], axis=1))   # [n, 2, bt, KV, D]
    got = tops.paged_attention(torch.from_numpy(q), pool[:, 0], pool[:, 1],
                               torch.from_numpy(tables),
                               torch.from_numpy(lens))
    want = tops.paged_attention(*map(torch.from_numpy, (q, kp, vp, tables,
                                                        lens)))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_combine_partials_matches():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 1, 4, 8)).astype(np.float32)
    parts_j, parts_t = [], []
    for s in range(3):
        k = rng.normal(size=(2, 5, 2, 8)).astype(np.float32)
        v = rng.normal(size=(2, 5, 2, 8)).astype(np.float32)
        m = rng.random((2, 5)) < 0.8
        parts_j.append(jattn.decode_attention_partial(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(m)))
        parts_t.append(tattn.decode_attention_partial(
            *map(torch.from_numpy, (q, k, v, m))))
    got = tattn.combine_partials(parts_t).numpy()
    want = np.asarray(jattn.combine_partials(parts_j))
    assert np.abs(got - want).max() < 2e-5


def _split_attention(q, kp, vp, tables, lens, n_splits, groups=None):
    """The split kernel's arithmetic in plain PyTorch: each lane's pages cut
    into n_splits ranges of ceil(MB / n_splits) pages, a flash-decoding
    partial of each range (`decode_attention_partial`), merged by
    `combine_partials`, and lanes with no valid position zeroed as
    `ref.paged_attention` zeroes them. groups=(G, RG): each KV head's REP
    query heads computed apart, RG at a time, as the kernel's blocks take
    them, and put back in place."""
    if groups is not None:
        g_n, rg = groups
        kv = kp.shape[2]
        rep = q.shape[1] // kv
        out, empty = np.zeros_like(q), 0
        for g in range(g_n):
            r0, r1 = g * rg, min(rep, (g + 1) * rg)
            heads = [h * rep + r for h in range(kv) for r in range(r0, r1)]
            out[:, heads], e = _split_attention(
                np.ascontiguousarray(q[:, heads]), kp, vp, tables, lens,
                n_splits)
            empty += e
        return out, empty
    q, kp, vp, tables, lens = map(torch.from_numpy, (q, kp, vp, tables, lens))
    b, mb = tables.shape
    n_slots, bt, kv, d = kp.shape
    pps = -(-mb // n_splits)
    safe = tables.clamp(0, n_slots - 1).long()
    valid_all = (torch.arange(mb * bt)[None] < lens[:, None]) & \
        torch.repeat_interleave(tables >= 0, bt, dim=1)
    parts, empty_splits = [], 0
    for j0 in range(0, mb, pps):
        j1 = min(mb, j0 + pps)
        k = kp[safe[:, j0:j1]].reshape(b, (j1 - j0) * bt, kv, d)
        v = vp[safe[:, j0:j1]].reshape(b, (j1 - j0) * bt, kv, d)
        valid = valid_all[:, j0 * bt:j1 * bt]
        empty_splits += int((~valid.any(1)).sum())
        parts.append(tattn.decode_attention_partial(q[:, None], k, v, valid))
    out = tattn.combine_partials(parts)
    out = torch.where(valid_all.any(1)[:, None, None, None], out, 0)
    return out[:, 0].numpy(), empty_splits


def _edge_lanes(q, kp, tables, lens, h, d, bt, mb):
    """The batch plus a lane of length 0 and one of length bt * MB - 1."""
    rng = np.random.default_rng(d)
    q = np.concatenate([q, rng.normal(size=(2, h, d)).astype(np.float32)])
    full = rng.choice(kp.shape[0], mb, replace=False).astype(np.int32)
    tables = np.concatenate([tables, np.full((1, mb), 0, np.int32),
                             full[None]])
    lens = np.concatenate([lens, np.array([0, bt * mb - 1], np.int32)])
    return q, tables, lens


@pytest.mark.parametrize("b,h,kv,d,bt,mb", PA_SHAPES)
@pytest.mark.parametrize("split", ["one", "two", "per_page"])
def test_split_kv_arithmetic_matches_pallas(b, h, kv, d, bt, mb, split):
    """The arithmetic of the split/combine kernel against the JAX kernel
    (Pallas, interpret mode) within 2e-5. A lane of length 0 is added to
    every batch and held against zeros (the port's output; the TPU kernel
    returns a mean over slot 0 there), and so is a lane at full length;
    with the random lengths, some splits hold no valid position. (No -1
    hole inside a length: the TPU kernel reads slot 0 there, since it
    tests its clamped table, while the port masks the page.)"""
    q, kp, vp, tables, lens = _pa_inputs(b, h, kv, d, bt, mb, seed=b + d)
    q, tables, lens = _edge_lanes(q, kp, tables, lens, h, d, bt, mb)
    n_splits = {"one": 1, "two": 2, "per_page": mb}[split]
    got, empty_splits = _split_attention(q, kp, vp, tables, lens, n_splits)
    want, _ = jops.paged_attention(*map(jnp.asarray, (q, kp, vp, tables,
                                                      lens)))
    want = np.asarray(want)
    assert empty_splits >= 1
    assert not got[b].any()
    live = np.arange(b + 2) != b
    assert np.abs(got[live] - want[live]).max() < 2e-5


@pytest.mark.parametrize("b,h,kv,d,bt,mb", PA_SHAPES + [(2, 80, 2, 16, 4, 5)])
@pytest.mark.parametrize("variant", [tops.TENSOR_CORES, tops.CUDA_CORES])
def test_grouped_split_arithmetic_matches_pallas(b, h, kv, d, bt, mb,
                                                 variant):
    """The query group cut as `_paged_groups` cuts it for each kernel (REP
    48: three groups of 16 on the tensor cores, two of 24 on the CUDA
    cores; REP 40: 16 + 16 + 8, and 20 + 20), one split per page, against
    the JAX kernel (Pallas, interpret mode) within 2e-5, with the lanes of
    length 0 and at full length."""
    rep = h // kv
    groups = tops._paged_groups(variant, rep, d)
    q, kp, vp, tables, lens = _pa_inputs(b, h, kv, d, bt, mb, seed=b + h)
    q, tables, lens = _edge_lanes(q, kp, tables, lens, h, d, bt, mb)
    got, _ = _split_attention(q, kp, vp, tables, lens, mb, groups)
    want, _ = jops.paged_attention(*map(jnp.asarray, (q, kp, vp, tables,
                                                      lens)))
    want = np.asarray(want)
    assert not got[b].any()
    live = np.arange(b + 2) != b
    assert np.abs(got[live] - want[live]).max() < 2e-5


@pytest.mark.parametrize("rep", [1, 2, 8, 16, 17, 32, 33, 40, 48, 64, 100])
@pytest.mark.parametrize("variant", [tops.TENSOR_CORES, tops.CUDA_CORES])
def test_paged_groups_cover_every_head_once(rep, variant):
    """`_paged_groups`: G blocks of at most RG heads cover [0, REP) exactly
    once with no empty block; REP <= 32 stays one block wherever a block
    can hold it (the CUDA-core kernel always, the tensor-core kernel at
    REP <= 16 or D <= 128); the CUDA-core kernel never needs
    more than 32 warps, the tensor-core kernel never more than two
    m-tiles, or one past D 128."""
    for d in (16, 64, 128, 256):
        g, rg = tops._paged_groups(variant, rep, d)
        heads = [r for i in range(g) for r in range(i * rg,
                                                    min(rep, (i + 1) * rg))]
        assert heads == list(range(rep))
        assert (g - 1) * rg < rep <= g * rg
        assert 1 <= rg <= 32
        if variant == tops.TENSOR_CORES and d > 128:
            assert rg <= 16
        if rep <= 32 and (variant == tops.CUDA_CORES or rep <= 16
                          or d <= 128):
            assert (g, rg) == (1, rep)
    if variant == tops.TENSOR_CORES and rep > 32:
        assert tops._paged_groups(variant, rep, 128)[1] == 16


@pytest.mark.parametrize("dtype,rep,d,ptrs,stride,want", [
    (torch.bfloat16, 48, 128, (0, 16, 32), 8 * 16, tops.TENSOR_CORES),
    (torch.bfloat16, 16, 128, (0, 16, 32), 8 * 16, tops.TENSOR_CORES),
    (torch.bfloat16, 32, 256, (0, 16, 32), 8 * 16, tops.TENSOR_CORES),
    (torch.bfloat16, 64, 16, (0, 16, 32), 8, tops.TENSOR_CORES),
    (torch.float32, 48, 128, (0, 16, 32), 8 * 16, tops.CUDA_CORES),
    (torch.bfloat16, 48, 120, (0, 16, 32), 8 * 16, tops.CUDA_CORES),
    (torch.bfloat16, 48, 128, (0, 18, 32), 8 * 16, tops.CUDA_CORES),
    (torch.bfloat16, 48, 128, (0, 16, 32), 8 * 16 + 1, tops.CUDA_CORES)])
def test_paged_variant_rule(dtype, rep, d, ptrs, stride, want):
    """bf16, D % 16 == 0, D <= 256, aligned q/k/v and slot stride: the
    tensor cores at any REP (granite's 48 included); anything else the
    CUDA cores."""
    assert tops._paged_variant(dtype, rep, d, ptrs, stride) == want


@pytest.mark.parametrize("rep", [40, 48, 64])
@pytest.mark.parametrize("variant", [tops.TENSOR_CORES, tops.CUDA_CORES])
def test_paged_smem_fits(rep, variant):
    """A split block's shared memory stays within an H100 block's 227 KB
    for REP 40/48/64 x D 16-256 x bt 4-16, at the warps the wrapper
    gives a tensor-core block."""
    for d in (16, 32, 64, 128, 256):
        for bt in (4, 8, 16):
            _, rg = tops._paged_groups(variant, rep, d)
            n_warps = tops._PAGED_WARPS if variant == tops.TENSOR_CORES else 1
            assert tops._paged_smem(variant, rg, d, bt, n_warps) \
                <= tops._SMEM_MAX
