"""The port's MoE block (`repro_torch/models/moe.py`) and expert tiering
(`repro_torch/models/expert_tiering.py`) against the JAX package's, on the
same numpy inputs and weights converted from the JAX init.

`moe_block` in float32: outputs within 1e-5, the chosen experts and the
per-expert counts exactly, the aux loss within 1e-6, at the reduced olmoe
and mixtral with no drops and at olmoe's B=4 x S=64 with capacity drops
while the drop bin (row n = T*k) holds a kept slot, where the reference's
scatter lets the last dropped token overwrite that slot's input. Ties
among gates choose the lowest expert id, as `jax.lax.top_k` does. The
expert-tiering state machine matches bit for bit, step by step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import get_config as jget_config
from repro.models import expert_tiering as jet
from repro.models import moe as jmoe
from repro.models import transformer as JT
from repro.models.model import Model as JModel
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.models import expert_tiering as tet
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT
from test_torch_pool import flat, to_np

ARCHS = ["olmoe-1b-7b", "mixtral-8x7b"]


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jget_config(arch, reduced=True), dtype=dtype),
            dataclasses.replace(tget_config(arch, reduced=True), dtype=dtype))


def _params(arch, dtype="float32"):
    jc, tc = _cfgs(arch, dtype)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jc, jnp.dtype(dtype))
    tp = {k: convert._tensor(np.asarray(v), "cpu") for k, v in jp.items()}
    return jc, tc, jp, tp


def _x(b, s, d, seed, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(dtype)


# (arch, B, S, seed): no drops, then olmoe's drop case (counts above G = 80
# while expert n // G holds more than n % G slots)
MOE_CASES = [("olmoe-1b-7b", 2, 8, 1), ("mixtral-8x7b", 2, 8, 1),
             ("mixtral-8x7b", 4, 64, 1), ("olmoe-1b-7b", 4, 64, 5)]


@pytest.mark.parametrize("arch,b,s,seed", MOE_CASES)
def test_moe_block_matches_jax(arch, b, s, seed):
    jc, tc, jp, tp = _params(arch)
    x = _x(b, s, jc.d_model, seed)
    jout, jaux, jcnt = jax.jit(lambda v: jmoe.moe_block(jp, v, jc))(
        jnp.asarray(x))
    tout, taux, tcnt = tmoe.moe_block(tp, torch.from_numpy(x), tc)
    assert tout.dtype == torch.float32 and tuple(tout.shape) == (b, s,
                                                                 jc.d_model)
    assert np.abs(np.asarray(jout) - tout.numpy()).max() < 1e-5
    assert tcnt.dtype == torch.int32
    assert np.array_equal(np.asarray(jcnt), tcnt.numpy())
    assert abs(float(jaux) - float(taux)) < 1e-6
    # decode's call skips only the aux loss
    out2, aux2, cnt2 = tmoe.moe_block(tp, torch.from_numpy(x), tc,
                                      with_aux=False)
    assert aux2 is None and torch.equal(out2, tout) and torch.equal(cnt2,
                                                                    tcnt)
    # the chosen experts, in JAX's order
    xf = jnp.asarray(x.reshape(-1, jc.d_model))
    _, je = jax.lax.top_k(jax.nn.softmax(xf @ jp["router"], -1),
                          jc.experts_per_token)
    _, _, te = tmoe._route(tp, torch.from_numpy(x.reshape(-1, jc.d_model)),
                           jc.experts_per_token)
    assert np.array_equal(np.asarray(je), te.numpy())
    t = b * s
    g, n = tmoe.capacity(t, tc), t * tc.experts_per_token
    cnt = tcnt.numpy()
    drops = int(np.maximum(cnt - g, 0).sum())
    if (b, s) == (4, 64) and arch == "olmoe-1b-7b":
        # the case the dispatch's drop rule decides: slot n is kept
        assert drops > 0 and cnt[n // g] > n % g, (cnt, g, n)
    elif (b, s) == (2, 8):
        assert drops == 0
        ref = tmoe.moe_block_ref(tp, torch.from_numpy(x), tc)
        assert (ref - tout).abs().max().item() < 1e-5


def test_moe_block_bf16_matches_jax():
    """bfloat16 weights and inputs: the products round in another order,
    the outputs within 2e-2, the counts exactly."""
    jc, tc, jp, tp = _params("olmoe-1b-7b", "bfloat16")
    x = _x(2, 8, jc.d_model, 1)
    jout, _, jcnt = jmoe.moe_block(jp, jnp.asarray(x, jnp.bfloat16), jc)
    tout, _, tcnt = tmoe.moe_block(tp, torch.from_numpy(x).bfloat16(), tc)
    assert tout.dtype == torch.bfloat16
    assert np.abs(to_np(jout) - to_np(tout)).max() < 2e-2
    assert np.array_equal(np.asarray(jcnt), tcnt.numpy())


@pytest.mark.parametrize("t", [1, 7, 8, 9, 16, 63, 64, 100, 128, 511, 512,
                               4096, 8192])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_capacity_matches_jax(arch, reduced, t):
    jc = jget_config(arch, reduced=reduced)
    tc = tget_config(arch, reduced=reduced)
    for cf in (1.0, 1.25, 2.0):
        assert tmoe.capacity(t, tc, cf) == jmoe.capacity(t, jc, cf)


@pytest.mark.parametrize("gates", ["equal", "three_way"])
def test_router_ties_choose_lowest_expert(gates):
    """Equal gates: JAX's top_k takes the lowest expert ids first; so must
    the port (a stable descending sort, not torch.topk)."""
    jc, tc, jp, tp = _params("olmoe-1b-7b")
    router = np.asarray(jp["router"]).copy()
    if gates == "equal":
        router[:] = 0.0
    else:                         # experts 1, 2 and 4 always tie
        router[:, 2] = router[:, 4] = router[:, 1]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = _x(4, 16, jc.d_model, 3)
    xf = x.reshape(-1, jc.d_model)
    _, je = jax.lax.top_k(jax.nn.softmax(jnp.asarray(xf) @ jp["router"], -1),
                          jc.experts_per_token)
    _, _, te = tmoe._route(tp, torch.from_numpy(xf), jc.experts_per_token)
    assert np.array_equal(np.asarray(je), te.numpy())
    if gates == "equal":
        assert (te.numpy() == [0, 1]).all()
    else:
        assert any(list(r) == [1, 2] for r in te.numpy())
    jout, _, jcnt = jmoe.moe_block(jp, jnp.asarray(x), jc)
    tout, _, tcnt = tmoe.moe_block(tp, torch.from_numpy(x), tc)
    assert np.array_equal(np.asarray(jcnt), tcnt.numpy())
    assert np.abs(np.asarray(jout) - tout.numpy()).max() < 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_gathered_and_ref_match_jax(arch):
    """`moe_block_gathered` (the decode variant that reads only the routed
    experts) and the dense oracle `moe_block_ref`, against JAX's and
    against `moe_block` where nothing drops."""
    jc, tc, jp, tp = _params(arch)
    x = _x(1, 2, jc.d_model, 4)
    jg, jaux, jcnt = jmoe.moe_block_gathered(jp, jnp.asarray(x), jc)
    tg, taux, tcnt = tmoe.moe_block_gathered(tp, torch.from_numpy(x), tc)
    assert np.abs(np.asarray(jg) - tg.numpy()).max() < 1e-5
    assert np.array_equal(np.asarray(jcnt), tcnt.numpy())
    assert float(jaux) == float(taux) == 0.0
    jr = jmoe.moe_block_ref(jp, jnp.asarray(x), jc)
    tr = tmoe.moe_block_ref(tp, torch.from_numpy(x), tc)
    assert np.abs(np.asarray(jr) - tr.numpy()).max() < 1e-5
    tb, _, _ = tmoe.moe_block(tp, torch.from_numpy(x), tc)
    assert (tb - tg).abs().max().item() < 1e-5


def test_dispatch_writes_no_index_put():
    """The dispatch and the combine are deterministic on the card: no
    `index_put_` (with duplicate indices CUDA picks the winning write at
    random; with accumulate=True it adds by atomics), no `index_add_` and
    no `index_copy_`."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Banned(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func._schema.name
            if any(w in name for w in ("index_put", "index_add",
                                       "index_copy")):
                raise AssertionError(name)
            return func(*args, **(kwargs or {}))
    jc, tc, jp, tp = _params("olmoe-1b-7b")
    x = torch.from_numpy(_x(4, 64, jc.d_model, 5))
    with Banned():
        tmoe.moe_block(tp, x, tc)


# ---------------------------------------------------------------------------
# expert tiering
# ---------------------------------------------------------------------------
def _assert_tiering_equal(js, ts):
    fj, ft = flat(js), flat(ts)
    assert sorted(fj) == sorted(ft)
    for k in fj:
        a, b = to_np(fj[k]), to_np(ft[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), (k, a, b)


def _assert_report_equal(jr, tr):
    assert sorted(jr) == sorted(tr)
    for k in jr:
        assert np.array_equal(np.asarray(jr[k]), to_np(torch.as_tensor(
            tr[k]))), (k, jr[k], tr[k])


def _run_tiering(cfg_kw, counts_seq, collect_every=1):
    jcfg = jet.ExpertTieringConfig(**cfg_kw)
    tcfg = tet.ExpertTieringConfig(**cfg_kw)
    js, ts = jet.init(jcfg), tet.init(tcfg)
    _assert_tiering_equal(js, ts)
    reports = []
    for i, c in enumerate(counts_seq):
        js = jet.observe(jcfg, js, jnp.asarray(c))
        ts = tet.observe(tcfg, ts, torch.from_numpy(c))
        _assert_tiering_equal(js, ts)
        if (i + 1) % collect_every == 0:
            js, jr = jet.collect(jcfg, js)
            ts, tr = tet.collect(tcfg, ts)
            _assert_tiering_equal(js, ts)
            _assert_report_equal(jr, tr)
            reports.append(tr)
    return ts, reports


def test_expert_tiering_demotes_and_faults_like_jax():
    """tests/test_tiering_integrations.py's scenario on both packages: two
    hot experts a layer, six collects, then a token routed to a cold
    expert faults its slab back."""
    kw = dict(num_layers=2, num_experts=8, bytes_per_expert=100)
    hot = np.zeros((2, 8), np.int32)
    hot[:, :2] = 50
    probe = np.zeros((2, 8), np.int32)
    probe[0, 7] = 1
    ts, reports = _run_tiering(kw, [hot] * 6)
    assert int(reports[-1]["resident_experts"]) == 4
    jcfg, tcfg = jet.ExpertTieringConfig(**kw), tet.ExpertTieringConfig(**kw)
    js = jet.init(jcfg)
    for _ in range(6):
        js, _ = jet.collect(jcfg, jet.observe(jcfg, js, jnp.asarray(hot)))
    js = jet.observe(jcfg, js, jnp.asarray(probe))
    ts = tet.observe(tcfg, ts, torch.from_numpy(probe))
    _assert_tiering_equal(js, ts)
    assert int(ts["total_faults"]) >= 1 and bool(ts["resident"][0, 7])


@pytest.mark.parametrize("collect_every", [1, 3])
def test_expert_tiering_random_counts_bit_for_bit(collect_every):
    """Skewed random routing over 40 steps: MIAD's threshold rises and
    falls, experts demote and fault back, every leaf and report equal."""
    rng = np.random.default_rng(11)
    skew = rng.dirichlet(np.full(16, 0.3), size=3)
    seq = []
    for step in range(40):
        c = np.stack([rng.multinomial(24, skew[(step // 10 + l) % 3])
                      for l in range(3)]).astype(np.int32)
        seq.append(c)
    kw = dict(num_layers=3, num_experts=16, bytes_per_expert=4096,
              promotion_target=0.05)
    _, reports = _run_tiering(kw, seq, collect_every)
    assert len({float(r["ct"]) for r in reports}) > 1
    assert min(int(r["resident_experts"]) for r in reports) < 48


def test_expert_tiering_on_olmoe_forward_counts():
    """The port's own `expert_counts_per_layer` from reduced-olmoe
    forwards (weights converted from the JAX init) equal JAX's, and drive
    both tiering state machines to the same state."""
    jcfg_m, tcfg_m = _cfgs("olmoe-1b-7b")
    jp = JModel(jcfg_m).init(jax.random.PRNGKey(0))
    tp = convert.from_jax(jax.tree.map(np.asarray, jp))
    kw = dict(num_layers=jcfg_m.num_layers, num_experts=jcfg_m.num_experts,
              bytes_per_expert=3 * jcfg_m.d_model * jcfg_m.moe_d_ff * 4,
              promotion_target=0.05)
    seq = []
    rng = np.random.default_rng(12)
    for step in range(8):
        # short prompts from a narrowing vocabulary: at most 6 of the 8
        # experts a layer are hit, fewer as the routing concentrates
        toks = rng.integers(0, 256 >> step, (1, 3)).astype(np.int32)
        _, jaux = JT.lm_forward(jp, jcfg_m, jnp.asarray(toks))
        _, taux = TT.lm_forward(tp, tcfg_m, torch.from_numpy(toks))
        assert np.array_equal(np.asarray(jaux["expert_counts_per_layer"]),
                              taux["expert_counts_per_layer"].numpy())
        seq.append(taux["expert_counts_per_layer"].numpy())
    ts, reports = _run_tiering(kw, seq, collect_every=2)
    assert len(reports) == 4
    assert int(ts["ciw"].max()) > 0 and not bool(ts["resident"].all())
