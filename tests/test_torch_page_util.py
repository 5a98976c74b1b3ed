"""The port's Page Utilization against the JAX package's: `from_arrays` on
`tests/test_page_util.py`'s exact cases and on random access records
(equal), `from_pool` on pools after random traces (within 1e-7
relative), the metric's bounds on the port, and, as the collector tidies
a scattered hot set, a value that does not fall and equals JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
pytest.importorskip("hypothesis")  # optional dev dep (requirements-dev.txt)
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import page_util as jpu
from repro.core import pool as jpl
from repro_torch.core import collector as tcol
from repro_torch.core import page_util as tpu
from repro_torch.core import pool as tpl
from test_torch_pool import jax_pool_config, random_trace, run_both


def test_exact_cases():
    for addrs, sizes, want in (([0], [64], 64 / 4096), ([0], [4096], 1.0),
                               ([0, 32], [64, 64], 96 / 4096),
                               ([4000], [200], 200 / 8192)):
        got = tpu.from_arrays(np.asarray(addrs), np.asarray(sizes))
        assert abs(got - want) < 1e-9
        assert got == jpu.from_arrays(np.asarray(addrs), np.asarray(sizes))
    assert tpu.from_arrays(np.zeros(0), np.zeros(0)) == 1.0


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("page_size", [4096, 512])
def test_from_arrays_matches_jax_on_random_records(seed, page_size):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    addrs = rng.integers(0, 1 << 22, n)
    sizes = rng.integers(1, 3 * page_size, n)
    got = tpu.from_arrays(addrs, sizes, page_size)
    assert got == jpu.from_arrays(addrs, sizes, page_size)
    assert 0.0 < got <= 1.0


@settings(max_examples=50, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 1 << 20), st.integers(1, 4096)),
                min_size=1, max_size=100))
def test_bounds(records):
    addrs = np.asarray([a for a, _ in records])
    sizes = np.asarray([s for _, s in records])
    assert 0.0 < tpu.from_arrays(addrs, sizes) <= 1.0


_jfrom_pool = jax.jit(jpu.from_pool, static_argnums=0)


@pytest.mark.parametrize("seed", range(4))
def test_from_pool_matches_jax(seed):
    """After random alloc / read / write / free traces (access bits set on
    a scattered subset of pages)."""
    rng = np.random.default_rng(seed)
    cfg = tpl.make_config(96, 4, sb_slots=8, page_slots=int(
        rng.choice([1, 2, 4])), slack=2.0)
    jstate, tstate, _ = run_both(cfg, random_trace(rng, 12, 96, 16, 4))
    want = float(_jfrom_pool(jax_pool_config(cfg), jstate))
    got = tpu.from_pool(cfg, tstate)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-7 * abs(want)
    assert 0 < want <= 1


def test_pool_variant_improves_after_tidying():
    """test_page_util.py's case on both packages: the scattered hot set's
    Page Utilization does not fall as the collector tidies, and the port's
    equals JAX's after each window."""
    from repro.core import collector as jcol
    cfg = tpl.make_config(max_objects=128, slot_words=4, sb_slots=16,
                          page_slots=4, slack=2.0)
    jcfg = jax_pool_config(cfg)
    tc, jc = tcol.CollectorConfig(), jcol.CollectorConfig()
    ts = tpl.alloc(cfg, tpl.init(cfg), torch.arange(128, dtype=torch.int32),
                   torch.zeros((128, 4)))
    js = jpl.alloc(jcfg, jpl.init(jcfg), jnp.arange(128, dtype=jnp.int32),
                   jnp.zeros((128, 4), jnp.float32))
    hot = np.random.default_rng(0).permutation(128)[:16].astype(np.int32)
    pus = []
    for _ in range(5):
        ts, _ = tcol.collect(cfg, tc, ts)
        _, ts = tpl.read(cfg, ts, torch.from_numpy(hot))
        js, _ = jcol.collect(jcfg, jc, js)
        _, js = jpl.read(jcfg, js, jnp.asarray(hot))
        pu, want = float(tpu.from_pool(cfg, ts)), float(
            _jfrom_pool(jcfg, js))
        assert abs(pu - want) <= 1e-7 * want
        pus.append(pu)
    assert 0 < pus[0] <= pus[-1] <= 1
