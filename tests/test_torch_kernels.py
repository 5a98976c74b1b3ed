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


def _split_attention(q, kp, vp, tables, lens, n_splits):
    """The split kernel's arithmetic in plain PyTorch: each lane's pages cut
    into n_splits ranges of ceil(MB / n_splits) pages, a flash-decoding
    partial of each range (`decode_attention_partial`), merged by
    `combine_partials`, and lanes with no valid position zeroed as
    `ref.paged_attention` zeroes them."""
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
    rng = np.random.default_rng(d)
    q = np.concatenate([q, rng.normal(size=(2, h, d)).astype(np.float32)])
    full = rng.choice(kp.shape[0], mb, replace=False).astype(np.int32)
    tables = np.concatenate([tables, np.full((1, mb), 0, np.int32),
                             full[None]])
    lens = np.concatenate([lens, np.array([0, bt * mb - 1], np.int32)])
    n_splits = {"one": 1, "two": 2, "per_page": mb}[split]
    got, empty_splits = _split_attention(q, kp, vp, tables, lens, n_splits)
    want, _ = jops.paged_attention(*map(jnp.asarray, (q, kp, vp, tables,
                                                      lens)))
    want = np.asarray(want)
    assert empty_splits >= 1
    assert not got[b].any()
    live = np.arange(b + 2) != b
    assert np.abs(got[live] - want[live]).max() < 2e-5
