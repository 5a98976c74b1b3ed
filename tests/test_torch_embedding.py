"""The port's tiered embedding (`repro_torch.models.embedding`) against the
JAX package's on the same inputs: a state carried across by
`convert.embedding_from_jax`, then windows of lookup, collect and
write_rows, in fp32 and bf16. Every embedding, state leaf and counter is
equal bit for bit, `counts` included (every addend of its scatter is 1.0,
so the order of the additions does not matter). The one exception is the
report's `hot_coverage`, a ratio of two float32 sums over the vocab whose
rounding depends on the order of the additions: it holds to V x 2^-24
relative, the bound of the summation error."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.models import embedding as jemb
from repro_torch import convert
from repro_torch.models import embedding as temb

V, D, HOT = 1024, 32, 64
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bits(a):
    """An array or tensor as numpy, bf16 as its bits."""
    if isinstance(a, torch.Tensor):
        a = a.cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def assert_same(j, t, what):
    a, b = _bits(j), _bits(t)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def assert_states_equal(js, ts):
    assert set(js) == set(ts)
    for k in js:
        assert_same(js[k], ts[k], k)


def assert_reports_equal(jr, tr):
    assert_same(jr["cold_hit_rate"], tr["cold_hit_rate"], "cold_hit_rate")
    assert tr["hot_coverage"].dtype == torch.float32
    np.testing.assert_allclose(float(tr["hot_coverage"]),
                               float(jr["hot_coverage"]),
                               rtol=V * 2.0 ** -24, atol=0)


def _table(seed, jdt):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(size=(V, D)).astype(np.float32), jdt)


def _tokens(rng, shape):
    """Zipfian ids scattered over the vocab (bench_embedding's stream)."""
    w = 1.0 / np.power(np.arange(1, V + 1, dtype=np.float64), 1.1)
    cdf = np.cumsum(w) / np.sum(w)
    scramble = np.random.default_rng(7).permutation(V)
    return scramble[np.searchsorted(cdf, rng.random(shape))].astype(np.int32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_windows_match_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    cfg_j = jemb.TieredEmbeddingConfig(vocab_size=V, d_model=D, hot_rows=HOT)
    cfg_t = temb.TieredEmbeddingConfig(vocab_size=V, d_model=D, hot_rows=HOT)
    js = jemb.init(cfg_j, _table(0, jdt))
    ts = convert.embedding_from_jax({k: np.asarray(v) for k, v in js.items()})
    assert ts["full"].dtype == tdt and ts["win_lookups"].dtype == torch.int32
    assert_states_equal(js, ts)
    assert_states_equal(js, temb.init(cfg_t, ts["full"]))
    rng = np.random.default_rng(1)
    for w in range(6):
        for _ in range(2):
            toks = _tokens(rng, (4, 64))
            je, js = jemb.lookup(cfg_j, js, jnp.asarray(toks))
            te, ts = temb.lookup(cfg_t, ts, torch.from_numpy(toks))
            assert_same(je, te, "embeddings")
            assert_states_equal(js, ts)
        js, jr = jemb.collect(cfg_j, js)
        ts, tr = temb.collect(cfg_t, ts)
        assert_states_equal(js, ts)
        assert_reports_equal(jr, tr)
        if w % 2:
            # 16 distinct rows, half of them in the replica
            hot = np.asarray(js["hot_ids"])
            cold = np.setdiff1d(np.arange(V), hot)
            rows = np.concatenate([rng.choice(hot, 8, replace=False),
                                   rng.choice(cold, 8, replace=False)])
            rows = rng.permutation(rows).astype(np.int32)
            vals = rng.normal(size=(16, D)).astype(np.float32)
            js = jemb.write_rows(js, jnp.asarray(rows),
                                 jnp.asarray(vals, jdt))
            ts = temb.write_rows(ts, torch.from_numpy(rows),
                                 torch.from_numpy(vals).to(tdt))
            assert_states_equal(js, ts)
    assert float(tr["cold_hit_rate"]) < 0.5


def test_write_rows_leaves_its_input():
    cfg = temb.TieredEmbeddingConfig(vocab_size=V, d_model=D, hot_rows=HOT)
    s = temb.init(cfg, torch.zeros(V, D))
    rows = torch.tensor([3, 700])            # one hot row, one cold
    out = temb.write_rows(s, rows, torch.ones(2, D))
    assert not s["full"].any() and not s["hot"].any()
    assert out["full"][rows].eq(1).all() and out["hot"][3].eq(1).all()
    assert out["full"].sum() == 2 * D and out["hot"].sum() == D


def test_collect_ties_go_to_the_lower_row():
    """Mostly tied counts, where torch.topk picks other rows: the port
    elects JAX's hot set (top_k: ties to the lower index)."""
    cfg_j = jemb.TieredEmbeddingConfig(vocab_size=V, d_model=D, hot_rows=HOT)
    cfg_t = temb.TieredEmbeddingConfig(vocab_size=V, d_model=D, hot_rows=HOT)
    counts = np.zeros(V, np.float32)
    counts[[5, 700, 900, 901]] = [3.0, 2.0, 2.0, 2.0]
    js = dict(jemb.init(cfg_j, _table(2, jnp.float32)),
              counts=jnp.asarray(counts))
    ts = convert.embedding_from_jax({k: np.asarray(v) for k, v in js.items()})
    js, jr = jemb.collect(cfg_j, js)
    ts, tr = temb.collect(cfg_t, ts)
    assert_states_equal(js, ts)
    assert_reports_equal(jr, tr)
    assert ts["hot_ids"][:6].tolist() == [5, 700, 900, 901, 0, 1]
    topk = torch.topk(torch.from_numpy(counts), HOT).indices.to(torch.int32)
    assert not torch.equal(topk, ts["hot_ids"])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sizes_match_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    cfg_j = jemb.TieredEmbeddingConfig(vocab_size=32000, d_model=2560,
                                       hot_rows=4096)
    cfg_t = temb.TieredEmbeddingConfig(vocab_size=32000, d_model=2560,
                                       hot_rows=4096)
    assert temb.hbm_bytes(cfg_t, tdt) == jemb.hbm_bytes(cfg_j, jdt)
    assert temb.total_bytes(cfg_t, tdt) == jemb.total_bytes(cfg_j, jdt)
