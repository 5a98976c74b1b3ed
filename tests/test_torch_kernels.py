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
