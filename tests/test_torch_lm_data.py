"""The port's token pipeline (`repro_torch.data.lm`) against the JAX
package's: its numpy threefry (`prng_key`, `fold_in`, `uniform`) against
`jax.random`, and `TokenPipeline.batch_at` against JAX's for several seeds,
steps and shards. All exact."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.data import lm as jlm
from repro_torch.data import lm as tlm


def _key_data(key) -> tuple:
    return tuple(int(x) for x in np.asarray(jax.random.key_data(key)))


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, 2 ** 31,
                                  2 ** 32 - 1, -1, -7])
def test_prng_key(seed):
    assert tlm.prng_key(seed) == _key_data(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("data", [0, 1, 5, 12345, 2 ** 31 - 1, 2 ** 32 - 1])
def test_fold_in(data):
    for seed in (0, 3):
        want = _key_data(jax.random.fold_in(jax.random.PRNGKey(seed), data))
        assert tlm.fold_in(tlm.prng_key(seed), data) == want
    with pytest.raises(OverflowError):
        tlm.fold_in(tlm.prng_key(0), -1)


@pytest.mark.parametrize("shape", [(1,), (3,), (2, 5), (4, 65), (3, 7, 9)])
def test_uniform(shape):
    for seed in (0, 11):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), 4)
        tk = tlm.fold_in(tlm.prng_key(seed), 4)
        want = np.asarray(jax.random.uniform(jk, shape))
        got = tlm.uniform(tk, shape)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed,vocab,seq,batch,num_shards", [
    (0, 1000, 16, 8, 2), (3, 32000, 64, 4, 1), (7, 65024, 33, 6, 3),
    (12, 50, 5, 4, 4)])
def test_batch_at_matches_jax(seed, vocab, seq, batch, num_shards):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    for shard in range(num_shards):
        jp = jlm.TokenPipeline(jlm.DataConfig(**kw), shard=shard,
                               num_shards=num_shards)
        tp = tlm.TokenPipeline(tlm.DataConfig(**kw), shard=shard,
                               num_shards=num_shards, device="cpu")
        for step in (0, 1, 5, 1000):
            want, got = jp.batch_at(step), tp.batch_at(step)
            for k in ("tokens", "labels"):
                assert got[k].dtype == torch.int32
                assert got[k].device.type == "cpu"
                assert np.array_equal(got[k].numpy(), np.asarray(want[k])), \
                    (shard, step, k)


def test_pipeline_iterates_and_checks_shards():
    cfg = tlm.DataConfig(vocab_size=100, seq_len=8, global_batch=4)
    tp = tlm.TokenPipeline(cfg, device="cpu")
    it = iter(tp)
    for step in range(3):
        b = next(it)
        assert torch.equal(b["tokens"], tp.batch_at(step)["tokens"])
    with pytest.raises(ValueError, match="multiple"):
        tlm.TokenPipeline(cfg, num_shards=3, device="cpu")
