"""The port's ten Table-1 structures (`repro_torch.data.structures`)
against the JAX package's, exactly: the same seed draws the same
permutations in the same order, so every rank table, metadata and node
object list, search path and touched-object stream is equal, dtype and
all."""
import numpy as np
import pytest

pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.data import structures as jst
from repro_torch import data as tdata
from repro_torch.data import structures as tst

NAMES = sorted(jst.STRUCTURES)


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and np.array_equal(a, b), what


def test_registry_and_sizes_match():
    assert sorted(tst.STRUCTURES) == NAMES
    assert sorted(tdata.STRUCTURES) == NAMES
    assert tdata.make_structure is tst.make_structure
    for c in ("KEY_BYTES", "VALUE_BYTES", "NODE_BYTES", "LOCK_BYTES",
              "BTREE_NODE_BYTES", "MASSTREE_NODE_BYTES", "ART_NODE_BYTES"):
        assert getattr(tst, c) == getattr(jst, c), c


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_keys", [512, 5000])
@pytest.mark.parametrize("name", NAMES)
def test_structure_matches_jax(name, n_keys, seed):
    js = jst.make_structure(name, n_keys, seed)
    ts = tst.make_structure(name, n_keys, seed)
    assert type(ts).__name__ == type(js).__name__ and ts.name == name
    _same(js.key_at_rank, ts.key_at_rank, "key_at_rank")
    _same(js.rank_of, ts.rank_of, "rank_of")
    for what in ("meta_objects", "node_objects"):
        for a, b in zip(getattr(js, what)(), getattr(ts, what)()):
            _same(a, b, what)
    rng = np.random.default_rng(100 + seed)
    keys = rng.integers(0, n_keys, 2048)
    upd = rng.random(2048) < 0.5
    values = 4 * n_keys + 7 + rng.permutation(2048)
    _same(js.paths(keys, upd), ts.paths(keys, upd), "paths")
    _same(js.touched(keys, upd, values), ts.touched(keys, upd, values),
          "touched")


def test_coarse_lock_is_a_shared_hot_object():
    """tests/test_data_and_sim.py's check on the port."""
    s = tst.make_structure("skip-coarse", 256, seed=0)
    keys = np.arange(64)
    flat = s.touched(keys, np.zeros(64, bool), 10_000 + keys)
    # the global lock object is touched once by EVERY op
    assert (flat == s.lock_base).sum() == 64
    # fraser (lock-free) touches no metadata objects (values live at ids
    # >= 10_000 here)
    s2 = tst.make_structure("skip-fraser", 256, seed=0)
    flat2 = s2.touched(keys, np.zeros(64, bool), 10_000 + keys)
    assert ((flat2 >= s2.meta_base) & (flat2 < 10_000)).sum() == 0
