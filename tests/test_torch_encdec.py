"""The encoder-decoder family: seamless-m4t-large-v2 reduced (two encoder
and two decoder layers, d_model 64, four heads of 16, 16 encoder frames)
through the port's `cross_attention`, `encoder_forward`, `Model.forward`
/ `prefill` / `loss` and `init_decode_state(enc_out=)` / `decode_step`,
against the JAX package's, with weights converted from the JAX model by
`repro_torch.convert` and the same numpy tokens and frame embeddings on
both sides. JAX's flash path runs its Pallas kernel in interpret mode, as
tests/test_kernels.py runs it.

Tolerances: float32 (both sides `dataclasses.replace(cfg,
dtype="float32")`) outputs and logits within 1e-5, the loss within 1e-5
and each gradient leaf within 1e-4 of the largest |g| of JAX's leaf (the
rule of tests/test_torch_train_grads.py); in bfloat16 the dense tests'
rule (tests/test_torch_prefill.py): logits within 3e-2, the encoder's
output and the K/V caches within two bf16 ulps of the tensor's largest
magnitude (2**-6 * max|x|); the port's teacher-forced decode against its
own forward within 0.15, the bound tests/test_arch_smoke.py sets, and
within 1e-4 in float32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import get_config as jget_config
from repro.data.lm import DataConfig as JDataConfig
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.models.model import Model as JModel
from repro.optim import adamw as jadamw
from repro.runtime.server import Server as JServer
from repro.runtime.server import ServerConfig as JServerConfig
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config as tget_config
from repro_torch.data.lm import DataConfig
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model as TModel
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.server import Server as TServer
from repro_torch.runtime.server import ServerConfig as TServerConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig

ARCH = "seamless-m4t-large-v2"
B, S = 2, 16
DECODE_S = 8
_CACHE = {}


def _models(dtype):
    """(jax model, jax params, port model, port params)."""
    if dtype not in _CACHE:
        jm = JModel(dataclasses.replace(jget_config(ARCH, reduced=True),
                                        dtype=dtype))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = TModel(dataclasses.replace(tget_config(ARCH, reduced=True),
                                        dtype=dtype), device="cpu")
        _CACHE[dtype] = (jm, jp, tm,
                         convert.from_jax(jax.tree.map(np.asarray, jp)))
    return _CACHE[dtype]


def _batch(seed=0, s=S):
    """(numpy tokens [B, s], numpy frame embeddings [B, S_enc, D] fp32)."""
    cfg = tget_config(ARCH, reduced=True)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    enc = rng.normal(size=(B, cfg.encoder_seq_len, cfg.d_model)) \
        .astype(np.float32)
    return toks, enc


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tol(dtype, want, logits=True) -> float:
    if dtype == "float32":
        return 1e-5
    return 3e-2 if logits else 2 ** -6 * np.abs(_np(want)).max()


def test_convert_unstacks_the_encoder_and_matches_init():
    jm, jp, tm, tp = _models("float32")
    assert set(tp) == set(jp) == {"embed", "final_ln", "out", "layers",
                                  "enc_layers", "enc_ln"}
    assert len(tp["enc_layers"]) == tm.cfg.num_encoder_layers == 2
    for i, lp in enumerate(tp["enc_layers"]):
        assert "xq" not in lp
        for k in ("wq", "wk", "wv", "wo", "ln1", "ln2"):
            assert np.array_equal(lp[k].numpy(),
                                  np.asarray(jp["enc_layers"][k][i])), k
    for i, lp in enumerate(tp["layers"]):
        for k in ("ln_x", "xq", "xk", "xv", "xo"):
            assert np.array_equal(lp[k].numpy(),
                                  np.asarray(jp["layers"][k][i])), k
    # the port's own init has the converted weights' structure
    own = tm.init(torch.Generator().manual_seed(0))
    layout = (lambda t: [(n, tuple(x.shape), x.dtype) for n, x in zip(
        *tree_lib.flatten_with_paths(t))])
    assert layout(own) == layout(tp)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_attention_matches_jax(masked):
    """GQA (8 query heads over 2 KV heads) over 12 encoder positions, with
    and without a padding mask (every row keeps at least one position)."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 5, 8, 16)).astype(np.float32)
    k = rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 12, 2, 16)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random((2, 12)) < 0.6
        mask[:, 0] = True
        mask[1, 7:] = False
    want = JA.cross_attention(*(jnp.asarray(x) for x in (q, k, v)),
                              None if mask is None else jnp.asarray(mask))
    got = TA.cross_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             None if mask is None else torch.from_numpy(mask))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(_np(got) - _np(want)).max() < 1e-5
    if masked:
        # a masked position does not move the output
        v2 = v.copy()
        v2[1, 7:] += 100.0
        moved = TA.cross_attention(*(torch.from_numpy(x) for x in (q, k, v2)),
                                   torch.from_numpy(mask))
        assert torch.equal(moved[1], got[1])


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("impl", ["full", "blockwise", "flash"])
def test_encoder_forward_matches_jax(impl, remat):
    jm, jp, tm, tp = _models("float32")
    _, enc = _batch(seed=2)
    want = JT.encoder_forward(jp, jm.cfg, jnp.asarray(enc), attn_impl=impl,
                              remat=remat)
    got = TT.encoder_forward(tp, tm.cfg, torch.from_numpy(enc),
                             attn_impl=impl, remat=remat)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(_np(got) - _np(want)).max() < 1e-5
    if impl != "flash":
        # under grad mode remat "full" recomputes each layer: the same
        # gradient as "none"
        leaves = tree_lib.leaves(tp["enc_layers"])
        grads = []
        for r in ("none", remat):
            for p in leaves:
                p.requires_grad_(True)
            try:
                out = TT.encoder_forward(tp, tm.cfg, torch.from_numpy(enc),
                                         attn_impl=impl, remat=r)
                grads.append(torch.autograd.grad(out.square().sum(), leaves))
            finally:
                for p in leaves:
                    p.requires_grad_(False)
        assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_match_jax(dtype):
    jm, jp, tm, tp = _models(dtype)
    toks, enc = _batch(seed=3)
    jl, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks),
                               "enc_embeds": jnp.asarray(enc)})
    batch = {"tokens": torch.from_numpy(toks),
             "enc_embeds": torch.from_numpy(enc)}
    tl, aux = tm.forward(tp, batch)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    assert np.abs(_np(tl) - _np(jl)).max() < _tol(dtype, jl)
    assert set(aux) == set(jaux)
    for k in aux:
        assert np.array_equal(aux[k].numpy(), np.asarray(jaux[k])), k
    assert torch.equal(tm.prefill(tp, batch), tl)
    # the encoder's output comes back with the cache, as in JAX
    _, jc = JT.lm_forward(jp, jm.cfg, jnp.asarray(toks),
                          enc_embeds=jnp.asarray(enc), return_cache=True)
    _, tc = TT.lm_forward(tp, tm.cfg, batch["tokens"],
                          enc_embeds=batch["enc_embeds"], return_cache=True)
    assert tc["enc_out"].dtype == getattr(torch, dtype)
    assert np.abs(_np(tc["enc_out"]) - _np(jc["enc_out"])).max() < \
        _tol(dtype, jc["enc_out"], logits=False)


def test_flash_prefill_matches_jax():
    """attn_impl "flash": the encoder's non-causal and the decoder's causal
    launches (the kernel's plain version here; JAX's Pallas kernel in
    interpret mode)."""
    jm, jp, tm, tp = _models("float32")
    toks, enc = _batch(seed=4)
    jl, _ = JT.lm_forward(jp, jm.cfg, jnp.asarray(toks),
                          enc_embeds=jnp.asarray(enc), attn_impl="flash")
    flash = TModel(tm.cfg, attn_impl="flash", device="cpu")
    tl = flash.prefill(tp, {"tokens": torch.from_numpy(toks),
                            "enc_embeds": torch.from_numpy(enc)})
    assert np.abs(_np(tl) - _np(jl)).max() < 1e-5


def test_loss_and_grads_match_jax():
    jm, jp, tm, tp = _models("float32")
    toks, enc = _batch(seed=5)
    labels = np.roll(toks, -1, axis=1)
    labels[0, :3] = -100
    jloss, jg = jax.value_and_grad(lambda p: jm.loss(p, {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
        "enc_embeds": jnp.asarray(enc)})[0])(jp)
    leaves = tree_lib.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = tm.loss(tp, {"tokens": torch.from_numpy(toks),
                               "labels": torch.from_numpy(labels),
                               "enc_embeds": torch.from_numpy(enc)})
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    assert abs(loss.item() - float(jloss)) < 1e-5
    want = convert.from_jax(jax.tree.map(np.asarray, jg))
    names, wl = tree_lib.flatten_with_paths(want)
    assert tree_lib.flatten_with_paths(tp)[0] == names
    for name, g, w in zip(names, grads, wl):
        scale = max(w.abs().max().item(), 1e-30)
        assert (g - w).abs().max().item() <= 1e-4 * scale, name
    # the encoder and the cross weights receive gradient
    for name, g in zip(names, grads):
        if name.startswith("enc_layers") or "/x" in name:
            assert g.abs().max().item() > 0, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_jax(dtype):
    """init_decode_state(enc_out=) on the same encoder memory, then
    DECODE_S teacher-forced steps: logits at every step, the caches and pos
    after the last."""
    jm, jp, tm, tp = _models(dtype)
    toks, enc = _batch(seed=6, s=DECODE_S)
    enc_out = np.asarray(JT.encoder_forward(jp, jm.cfg, jnp.asarray(enc)))
    jst = jm.init_decode_state(B, DECODE_S, enc_out=jnp.asarray(enc_out))
    tst = tm.init_decode_state(B, DECODE_S,
                               enc_out=convert._tensor(enc_out, "cpu"))
    assert set(tst) == set(jst) == {"pos", "kv", "enc_out"}
    for t in range(DECODE_S):
        jlog, jst = jm.decode_step(jp, jst, jnp.asarray(toks[:, t]))
        tlog, tst = tm.decode_step(tp, tst, torch.from_numpy(toks[:, t]))
        assert np.abs(_np(tlog) - _np(jlog)).max() < _tol(dtype, jlog), t
    assert tst["pos"] == int(jst["pos"]) == DECODE_S
    assert np.array_equal(tst["kv"]["k_pos"].numpy(),
                          np.asarray(jst["kv"]["k_pos"]))
    for k in ("k", "v"):
        assert np.abs(_np(tst["kv"][k]) - _np(jst["kv"][k])).max() < \
            _tol(dtype, jst["kv"][k], logits=False), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_reproduces_forward(dtype):
    """Teacher-forced decode over the forward's own encoder output
    reproduces the forward's logits (tests/test_arch_smoke.py's check,
    with a random encoder input where it uses zeros)."""
    _, _, tm, tp = _models(dtype)
    toks, enc = _batch(seed=7, s=DECODE_S)
    toks = torch.from_numpy(toks)
    full, aux = TT.lm_forward(tp, tm.cfg, toks,
                              enc_embeds=torch.from_numpy(enc),
                              return_cache=True)
    state = tm.init_decode_state(B, DECODE_S, enc_out=aux["enc_out"])
    logits = []
    for t in range(DECODE_S):
        lg, state = tm.decode_step(tp, state, toks[:, t])
        logits.append(lg)
    err = (torch.stack(logits, 1) - full).abs().max().item()
    assert err < 0.15
    if dtype == "float32":
        assert err < 1e-4


def test_encoder_inputs_are_required():
    _, _, tm, tp = _models("float32")
    toks, _ = _batch()
    with pytest.raises(ValueError, match="enc_embeds"):
        tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    with pytest.raises(ValueError, match="enc_out"):
        tm.init_decode_state(B, 8)


def test_server_refuses_what_jax_serves_without_cross_attention():
    """A departure from the JAX package, on purpose: JAX's paged `Server`
    serves this model, but it passes no encoder memory, so its decoder
    runs without cross attention (the xq / xk / xv / xo weights unused: a
    different model). The port's `Server` refuses it."""
    jm, jp, tm, _ = _models("float32")
    kw = dict(batch=2, max_len=32, block_tokens=4, collect_every=4)
    prompts = np.random.default_rng(8).integers(0, 512, (2, 5)) \
        .astype(np.int32)
    out = JServer(jm, JServerConfig(**kw)).generate(jp, jnp.asarray(prompts),
                                                    max_new=4)
    assert np.asarray(out).shape == (2, 4)
    with pytest.raises(ValueError, match="encoder-decoder"):
        TServer(tm, TServerConfig(**kw))


def test_trainer_fails_in_both_packages(tmp_path):
    """The token pipeline gives no frame embeddings: JAX's `Trainer` fails
    on its assertion, the port's raises before any step."""
    jm, jp, tm, tp = _models("float32")
    dkw = dict(vocab_size=jm.cfg.vocab_size, seq_len=16, global_batch=2)
    okw = dict(total_steps=2, warmup_steps=1)
    with pytest.raises(AssertionError):
        JTrainer(jm, JDataConfig(**dkw), jadamw.AdamWConfig(**okw),
                 JTrainerConfig(ckpt_dir=str(tmp_path / "jax"))).run(jp, 1)
    with pytest.raises(ValueError, match="enc_embeds"):
        Trainer(tm, DataConfig(**dkw), AdamWConfig(**okw),
                TrainerConfig(ckpt_dir=str(tmp_path / "torch"))).run(tp, 1)
