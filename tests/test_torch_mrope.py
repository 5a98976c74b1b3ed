"""The VLM family: qwen2-vl-72b reduced (two layers, d_model 64, four
heads of 16 over two KV heads, M-RoPE) through the port's `apply_mrope`,
`positional`, `Model.forward` / `prefill` / `loss` with patch embeddings
prepended (`extra_embeds`), text-only decode, `Server.generate` and
`Trainer`, against the JAX package's, with weights converted from the JAX
model by `repro_torch.convert` and the same numpy inputs on both sides.
JAX's flash path runs its Pallas kernel in interpret mode, as
tests/test_kernels.py runs it.

Tolerances: rotary outputs within 1e-5; float32 (both sides
`dataclasses.replace(cfg, dtype="float32")`) logits and the loss within
1e-5, each gradient leaf within 1e-4 of the largest |g| of JAX's leaf
(tests/test_torch_train_grads.py's rule); bfloat16 logits within 3e-2
(the dense tests' rule, tests/test_torch_prefill.py); greedy tokens
identical; Trainer losses within 1e-4 and grad norms within 1e-4 of
JAX's (tests/test_torch_train.py's rule)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import get_config as jget_config
from repro.data.lm import DataConfig as JDataConfig
from repro.models import layers as JL
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
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model as TModel
from repro_torch.models.model import vlm_patches
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.server import Server as TServer
from repro_torch.runtime.server import ServerConfig as TServerConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig

ARCH = "qwen2-vl-72b"
B, S_TXT, G = 2, 12, 2      # G x G patches, then S_TXT text tokens
P = G * G
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


def _batch(seed=0, s=S_TXT):
    """(numpy tokens [B, s], numpy patch embeddings [B, P, D] fp32)."""
    cfg = tget_config(ARCH, reduced=True)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    patches = rng.normal(size=(B, P, cfg.d_model)).astype(np.float32)
    return toks, patches


def _grid_positions(s_txt=S_TXT) -> np.ndarray:
    """[3, B, P + s_txt]: patch i at t = 0, h = i // G, w = i % G; text
    token j at G + j in all three streams."""
    pos = np.zeros((3, B, P + s_txt), np.int32)
    i = np.arange(P)
    pos[1, :, :P] = i // G
    pos[2, :, :P] = i % G
    pos[:, :, P:] = G + np.arange(s_txt)
    return pos


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(a, b) -> float:
    return float(np.abs(_np(a) - _np(b)).max())


@pytest.mark.parametrize("d", [16, 64, 128])
def test_apply_mrope_matches_jax(d):
    """Three distinct position streams: every section of the d/2 lanes is
    rotated by its own stream."""
    rng = np.random.default_rng(d)
    x = rng.normal(size=(2, 7, 3, d)).astype(np.float32)
    pos = rng.integers(0, 4096, (3, 2, 7)).astype(np.int32)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    assert got.dtype == torch.float32 and _err(got, want) < 1e-5
    # the lane split: the temporal section takes the rounding, and each
    # stream moves only its own lanes (and their rotation partners)
    lanes = d // 2
    sizes = [lanes - 2 * (lanes // 4), lanes // 4, lanes // 4]
    for i in range(3):
        moved = pos.copy()
        moved[i] += 1
        out = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(moved),
                             1e6)
        changed = (out != got).any(0).any(0).any(0).numpy()
        lo = sum(sizes[:i])
        want_lanes = np.zeros(lanes, bool)
        want_lanes[lo:lo + sizes[i]] = True
        assert np.array_equal(changed[:lanes], want_lanes), i
        assert np.array_equal(changed[lanes:], want_lanes), i


def test_positional_broadcasts_2d_positions():
    _, _, tm, _ = _models("float32")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 6, 4, 16)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 100, (2, 6)).astype(np.int32))
    got = TL.positional(tm.cfg, x, pos)
    assert torch.equal(got, TL.apply_mrope(x, pos[None].expand(3, 2, 6),
                                           tm.cfg.rope_theta))
    jm = _models("float32")[0]
    want = JL.positional(jm.cfg, jnp.asarray(x.numpy()),
                         jnp.asarray(pos.numpy()))
    assert _err(got, want) < 1e-5


@pytest.mark.parametrize("impl", ["full", "blockwise", "flash"])
def test_forward_with_patches_matches_jax(impl):
    jm, jp, tm, tp = _models("float32")
    toks, patches = _batch(seed=2)
    jl, _ = JT.lm_forward(jp, jm.cfg, jnp.asarray(toks),
                          extra_embeds=jnp.asarray(patches), attn_impl=impl)
    model = TModel(tm.cfg, attn_impl=impl, device="cpu")
    batch = {"tokens": torch.from_numpy(toks),
             "extra_embeds": torch.from_numpy(patches)}
    tl, aux = model.forward(tp, batch)
    assert tuple(tl.shape) == jl.shape == (B, P + S_TXT, tm.cfg.vocab_size)
    assert _err(tl, jl) < 1e-5
    assert torch.equal(model.prefill(tp, batch), tl)


def test_bf16_forward_matches_jax():
    jm, jp, tm, tp = _models("bfloat16")
    toks, patches = _batch(seed=3)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks),
                            "extra_embeds": jnp.asarray(patches)})
    tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks),
                            "extra_embeds": torch.from_numpy(patches)})
    assert _err(tl, jl) < 3e-2


@pytest.mark.parametrize("impl", ["full", "blockwise", "flash"])
def test_grid_positions_match_jax(impl):
    """lm_forward with [3, B, S] grid positions. "full" and "blockwise"
    mask by the temporal stream (0 for every patch, so the patches see
    each other both ways); "flash" masks by index, as the TPU kernel does:
    the two differ, in both packages alike."""
    jm, jp, tm, tp = _models("float32")
    toks, patches = _batch(seed=4)
    pos = _grid_positions()
    jl, _ = JT.lm_forward(jp, jm.cfg, jnp.asarray(toks),
                          extra_embeds=jnp.asarray(patches),
                          positions=jnp.asarray(pos), attn_impl=impl)
    tl, _ = TT.lm_forward(tp, tm.cfg, torch.from_numpy(toks),
                          extra_embeds=torch.from_numpy(patches),
                          positions=torch.from_numpy(pos), attn_impl=impl)
    assert _err(tl, jl) < 1e-5
    text_only, _ = TT.lm_forward(tp, tm.cfg, torch.from_numpy(toks),
                                 extra_embeds=torch.from_numpy(patches),
                                 attn_impl=impl)
    assert _err(tl, text_only) > 1e-3     # the grid moves the logits


def test_loss_drops_patch_logits_and_grads_match_jax():
    jm, jp, tm, tp = _models("float32")
    toks, patches = _batch(seed=5)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -100
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "extra_embeds": jnp.asarray(patches)}
    tb = {"tokens": torch.from_numpy(toks),
          "labels": torch.from_numpy(labels),
          "extra_embeds": torch.from_numpy(patches)}
    jloss, jg = jax.value_and_grad(lambda p: jm.loss(p, jb)[0])(jp)
    # the loss is the text positions' cross entropy only
    logits, _ = tm.forward(tp, tb)
    logp = torch.log_softmax(logits[:, P:], -1)
    mask = tb["labels"] != -100
    nll = -torch.gather(logp, -1, torch.where(mask, tb["labels"], 0)
                        .long()[..., None])[..., 0]
    leaves = tree_lib.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = tm.loss(tp, tb)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    assert abs(loss.item() - (nll * mask).sum().item() / mask.sum().item()) \
        < 1e-6
    assert abs(loss.item() - float(jloss)) < 1e-5
    want = convert.from_jax(jax.tree.map(np.asarray, jg))
    names, wl = tree_lib.flatten_with_paths(want)
    assert tree_lib.flatten_with_paths(tp)[0] == names
    for name, g, w in zip(names, grads, wl):
        scale = max(w.abs().max().item(), 1e-30)
        assert (g - w).abs().max().item() <= 1e-4 * scale, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_jax(dtype):
    """Text-only decode (M-RoPE with t == h == w), 8 teacher-forced steps,
    then the caches; the float32 decode also reproduces the port's own
    text-only forward."""
    jm, jp, tm, tp = _models(dtype)
    toks, _ = _batch(seed=6, s=8)
    jst, tst = jm.init_decode_state(B, 8), tm.init_decode_state(B, 8)
    logits = []
    for t in range(8):
        jlog, jst = jm.decode_step(jp, jst, jnp.asarray(toks[:, t]))
        tlog, tst = tm.decode_step(tp, tst, torch.from_numpy(toks[:, t]))
        logits.append(tlog)
        assert _err(tlog, jlog) < (1e-5 if dtype == "float32" else 3e-2), t
    assert tst["pos"] == int(jst["pos"]) == 8
    for k in ("k", "v"):
        want = jst["kv"][k]
        tol = 1e-5 if dtype == "float32" else \
            2 ** -6 * np.abs(_np(want)).max()
        assert _err(tst["kv"][k], want) < tol, k
    if dtype == "float32":
        full, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
        assert (torch.stack(logits, 1) - full).abs().max().item() < 1e-4


def test_server_generate_matches_jax():
    """Greedy `Server.generate` over the paged pool, text only, as JAX's
    server runs the VLM: identical tokens and reports."""
    jm, jp, tm, tp = _models("float32")
    kw = dict(batch=B, max_len=32, block_tokens=4, collect_every=4)
    js, ts = JServer(jm, JServerConfig(**kw)), TServer(tm, TServerConfig(**kw))
    prompts = np.random.default_rng(7).integers(0, 256, (B, 5)) \
        .astype(np.int32)
    jout = js.generate(jp, jnp.asarray(prompts), max_new=8)
    tout = ts.generate(tp, prompts, max_new=8)
    assert np.array_equal(np.asarray(jout), tout.numpy())
    assert js.reports == ts.reports


def test_trainer_follows_jax(tmp_path):
    """Three `Trainer` steps on the token pipeline (text only)."""
    jm, jp, tm, tp = _models("float32")
    tp = tree_lib.map_leaves(torch.clone, tp)
    dkw = dict(vocab_size=jm.cfg.vocab_size, seq_len=16, global_batch=2)
    okw = dict(total_steps=3, warmup_steps=1)
    jout = JTrainer(jm, JDataConfig(**dkw), jadamw.AdamWConfig(**okw),
                    JTrainerConfig(ckpt_dir=str(tmp_path / "jax"),
                                   log_every=1)).run(jp, 3)
    tout = Trainer(tm, DataConfig(**dkw), AdamWConfig(**okw),
                   TrainerConfig(ckpt_dir=str(tmp_path / "torch"),
                                 log_every=1)).run(tp, 3)
    assert tout["step"] == jout["step"] == 3
    for (_, t), (_, j) in zip(tout["history"], jout["history"]):
        assert abs(t["loss"] - j["loss"]) < 1e-4
        assert abs(t["grad_norm"] - j["grad_norm"]) < 1e-4 * j["grad_norm"]
    want = convert.from_jax(jax.tree.map(np.asarray, jout["params"]))
    for name, g, w in zip(tree_lib.flatten_with_paths(tout["params"])[0],
                          tree_lib.leaves(tout["params"]),
                          tree_lib.leaves(want)):
        assert (g - w).abs().max().item() < 1e-5, name


def test_vlm_patches_matches_jax():
    from repro.models.model import vlm_patches as jvlm_patches
    for s in (8, 16, 64, 1024, 4096, 32768):
        assert vlm_patches(s) == jvlm_patches(s)
    assert vlm_patches(4096) == 256
