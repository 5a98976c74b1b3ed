"""The port's AdamW (`repro_torch.optim.adamw`) against the JAX package's
on the same numpy params and grads.

Tolerances: float32 params within rtol 1e-6 (the two compute the same
fp32 expression in another order of fusion: a few ulps), bfloat16 params
within one bf16 ulp of JAX's (the fp32 update differs by a few ulps and
may round to the neighbouring bf16 value), m and v within rtol 1e-6, the
learning rate and the grad norm within rtol 1e-6. Also mirrors the JAX
package's `test_adamw_converges_on_quadratic` and
`test_grad_clip_bounds_update` (tests/test_runtime_and_optim.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.optim import adamw as jadamw
from repro_torch.optim import adamw as tadamw

SHAPES = {"w": (8, 6), "b": (6,), "layers": [{"k": (4, 3)}, {"k": (4, 3)}]}


def _tree(rng, scale=1.0):
    return {"w": (rng.normal(size=SHAPES["w"]) * scale).astype(np.float32),
            "b": (rng.normal(size=SHAPES["b"]) * scale).astype(np.float32),
            "layers": [{"k": (rng.normal(size=(4, 3)) * scale)
                        .astype(np.float32)} for _ in range(2)]}


def _jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _torch(tree, dtype):
    return jax.tree.map(lambda a: torch.from_numpy(a).to(dtype), tree)


def _ulp_bf16(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significand bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [1.0, 1e3])
def test_update_matches_jax_over_five_steps(dtype, grad_clip):
    rng = np.random.default_rng(0)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=4, grad_clip=grad_clip)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    p_np = _tree(rng)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = _jax(p_np, jdt)
    tp = _torch(p_np, getattr(torch, dtype))
    js, ts = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    assert all(m.dtype == torch.float32
               for m in jax.tree.leaves(ts["m"]) + jax.tree.leaves(ts["v"]))
    clipped = False
    for _ in range(5):                     # steps 1-5: warmup, mid, past
        g_np = _tree(rng, scale=3.0)
        jp, js, jm = jadamw.adamw_update(
            jcfg, jp, _jax(g_np, jdt), js)
        tp_before = jax.tree.leaves(tp)
        tp, ts, tm = tadamw.adamw_update(
            tcfg, tp, _torch(g_np, getattr(torch, dtype)), ts)
        # updated in place
        assert all(a is b for a, b in zip(tp_before, jax.tree.leaves(tp)))
        assert int(ts["step"]) == int(js["step"])
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        clipped |= float(jm["grad_norm"]) > grad_clip
        for a, b in zip(jax.tree.leaves(ts["m"]) + jax.tree.leaves(ts["v"]),
                        jax.tree.leaves(js["m"]) + jax.tree.leaves(js["v"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-12)
        for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
            got = a.float().numpy()
            want = np.asarray(b, np.float32)
            if dtype == "float32":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
            else:
                assert (np.abs(got - want) <= _ulp_bf16(want)).all()
    assert clipped == (grad_clip == 1.0)


@pytest.mark.parametrize("step", [0, 1, 50, 100, 5000, 10_000, 20_000])
def test_cosine_schedule_matches_jax(step):
    cfg = dict(lr=3e-4, warmup_steps=100, total_steps=10_000)
    want = float(jadamw.cosine_schedule(jadamw.AdamWConfig(**cfg),
                                        jnp.asarray(step, jnp.int32)))
    got = float(tadamw.cosine_schedule(tadamw.AdamWConfig(**cfg),
                                       torch.tensor(step, dtype=torch.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_adamw_converges_on_quadratic():
    cfg = tadamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                             total_steps=100)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = tadamw.adamw_init(params)
    for _ in range(100):
        g = {"w": 2 * params["w"]}          # grad of sum(w ** 2)
        params, state, m = tadamw.adamw_update(cfg, params, g, state)
    assert float(params["w"].abs().max()) < 0.1


def test_grad_clip_bounds_update():
    cfg = tadamw.AdamWConfig(lr=1.0, grad_clip=1.0, warmup_steps=0)
    params = {"w": torch.zeros(4)}
    state = tadamw.adamw_init(params)
    g = {"w": torch.full((4,), 1e6)}
    _, _, m = tadamw.adamw_update(cfg, params, g, state)
    assert float(m["grad_norm"]) > 1e5          # reported pre-clip
