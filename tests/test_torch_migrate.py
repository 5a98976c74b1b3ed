"""The port's plain `migrate` and its three-phase model `migrate_phased`
(the order the CUDA kernel runs: mark, direct copies and staged reads,
staged writes) against the JAX package's `ops.migrate(...,
has_scratch_row=True)`, whose Pallas kernel runs in interpret mode, bit for
bit, on the hazards of an in-place move and on hypothesis-generated lists
with distinct live destinations.

Two edges of the semantics are the port's own: a destination out of range
is dropped, and a source clamps into range. The TPU kernel leaves both
undefined (a block index out of bounds); interpret mode writes the scratch
row for such a destination and wraps a negative source as numpy indexing
does. So each case is held against JAX on the lists that the port's rule
makes of it: ok cleared where the destination is out of range, sources
clipped into range (for every other list these change nothing)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
pytest.importorskip("hypothesis")  # optional dev dep (requirements-dev.txt)
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from test_torch_gpu import MIGRATE_KINDS, MIGRATE_STAGED, migrate_moves


def _jax_migrate(data, src, dst, ok):
    """JAX's migrate on the port's rule: out-of-range destinations masked,
    sources clipped into range."""
    n_rows = data.shape[0]
    ok = ok & (dst >= 0) & (dst < n_rows)
    src = np.clip(src, 0, n_rows - 1).astype(np.int32)
    return np.asarray(jops.migrate(jnp.asarray(data), jnp.asarray(src),
                                   jnp.asarray(dst), jnp.asarray(ok),
                                   has_scratch_row=True))


def _check(data, src, dst, ok):
    """ref.migrate, ref.migrate_phased and the wrapper on CPU tensors equal
    JAX bit for bit and leave the scratch row zero. Returns the staged
    mask."""
    want = _jax_migrate(data, src, dst, ok)
    args = [torch.from_numpy(x) for x in (src, dst, ok)]
    got = tref.migrate(torch.from_numpy(data.copy()), *args)
    phased, staged = tref.migrate_phased(torch.from_numpy(data.copy()),
                                         *args)
    wrapped = tops.migrate(torch.from_numpy(data.copy()), *args)
    for x in (got, phased, wrapped):
        assert np.array_equal(x.numpy(), want)
        assert not x[-1].any(), "the scratch row must stay zero"
    return staged.numpy()


def _pool(rng, n_rows, w, dtype=np.float32):
    data = rng.normal(size=(n_rows, w)).astype(dtype)
    data[-1] = 0                                    # the scratch row
    return data


@pytest.mark.parametrize("kind", MIGRATE_KINDS)
@pytest.mark.parametrize("n_rows,w", [(17, 8), (24, 128)])
def test_migrate_hazards_match_pallas(kind, n_rows, w):
    rng = np.random.default_rng(n_rows)
    src, dst, ok = migrate_moves(kind, n_rows, rng)
    staged = _check(_pool(rng, n_rows, w), src, dst, ok)
    if kind == "disjoint":
        assert not staged.any()
    else:
        assert staged.tolist() == [bool(x) for x in MIGRATE_STAGED[kind]]


def test_migrate_edges_are_the_ports_rule():
    """The two cases JAX's interpret mode reads otherwise: the port drops a
    destination out of range (interpret mode writes the scratch row) and
    clamps a negative source to row 0 (interpret mode wraps it)."""
    rng = np.random.default_rng(5)
    data = _pool(rng, 17, 8)
    for kind in ("dst_out_of_range", "negative_src"):
        src, dst, ok = migrate_moves(kind, 17, rng)
        got = tref.migrate(torch.from_numpy(data.copy()),
                           *(torch.from_numpy(x) for x in (src, dst, ok)))
        want = data.copy()
        if kind == "dst_out_of_range":
            want[9] = data[5]                       # the one live move
        else:
            want[7], want[8], want[9] = data[0], data[0], data[5]
        assert np.array_equal(got.numpy(), want), kind


N_ROWS, N_MOVES = 24, 8


@settings(max_examples=40, deadline=None)
@given(src=st.lists(st.integers(-3, N_ROWS + 2), min_size=N_MOVES,
                    max_size=N_MOVES),
       dst=st.lists(st.integers(-2, N_ROWS + 2).filter(
           lambda d: d != N_ROWS - 1), min_size=N_MOVES, max_size=N_MOVES,
           unique=True),
       ok=st.lists(st.booleans(), min_size=N_MOVES, max_size=N_MOVES))
def test_migrate_random_lists_match_pallas(src, dst, ok):
    """Any list whose live destinations are distinct (none the scratch
    row): chains, cycles, swaps, fan-out and out-of-range lanes mixed. A
    live move is staged exactly when its source is a live destination and
    its destination a live source."""
    data = _pool(np.random.default_rng(0), N_ROWS, 16)
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    ok = np.asarray(ok, bool)
    staged = _check(data, src, dst, ok)
    live = ok & (dst >= 0) & (dst < N_ROWS)
    s = np.clip(src, 0, N_ROWS - 1)
    sources, dests = set(s[live].tolist()), set(dst[live].tolist())
    want = [bool(lv and si in dests and di in sources)
            for lv, si, di in zip(live, s, dst)]
    assert staged.tolist() == want
