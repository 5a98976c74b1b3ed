"""The port's `Model` facade and `configs/shapes.py` against the JAX
package's, for all ten architectures, and the port's analog of
tests/test_arch_smoke.py.

* `shapes`: SHAPES, SHAPE_ORDER, `reduced_shape` and the (arch x shape)
  `applicable` matrix equal JAX's, full and reduced configs.
* `param_specs()` at FULL size: every leaf's shape and dtype equal JAX's
  `param_specs()` (`jax.eval_shape` of init), as "meta" tensors, nothing
  allocated (qwen2-vl-72b's 80 layers are 135 GiB of bf16). JAX stacks
  the per-layer dicts on a leading [L] axis ([G, per] for zamba2's mamba2
  blocks); the port keeps lists, which map onto those axes.
* `input_specs` for every shape, full and reduced, with and without the
  decode state: JAX's names, shapes and dtypes. One leaf differs in form:
  the decode state's "pos" is the Python int 0 in the port (its decode
  loop runs on the host) where JAX keeps an int32 scalar.
* `make_inputs`: the specs' shapes and dtypes, integers in [0, vocab),
  floats N(0, 1) x 0.02, and for decode a fresh state.
* every reduced config: a loss step (finite loss, a nonzero finite
  gradient), prefill logits [B, S, V] finite, four decode steps."""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.configs import shapes as jshapes
from repro.models.model import Model as JModel
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import list_archs
from repro_torch.configs import shapes as tshapes
from repro_torch.models.model import Model as TModel
from repro_torch.models.model import build

ARCHS = list(list_archs())


def _jax_leaves(tree) -> dict:
    """{path: (shape, dtype name)} of a JAX pytree of ShapeDtypeStructs."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        out[name] = (tuple(leaf.shape), str(leaf.dtype))
    return out


def _stacked(tree, prefix="", lead=()) -> dict:
    """The port's tree as JAX would stack it: {path: (shape, dtype name)},
    list items folded into leading axes (a list of lists into two)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_stacked(v, f"{prefix}{k}/", lead))
        return out
    if isinstance(tree, list):
        parts = [_stacked(v, prefix, ()) for v in tree]
        assert all(p.keys() == parts[0].keys() for p in parts)
        assert all(p == parts[0] for p in parts), "ragged layers"
        return {k: (lead + (len(tree),) + s, d)
                for k, (s, d) in parts[0].items()}
    assert isinstance(tree, torch.Tensor), type(tree)
    return {prefix[:-1]: (lead + tuple(tree.shape),
                          str(tree.dtype).replace("torch.", ""))}


def test_shapes_match_jax():
    assert tshapes.SHAPE_ORDER == jshapes.SHAPE_ORDER
    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    for name in tshapes.SHAPE_ORDER:
        assert dataclasses.asdict(tshapes.reduced_shape(name)) == \
            dataclasses.asdict(jshapes.reduced_shape(name))
    assert ARCHS == list(jlist_archs())
    for arch in ARCHS:
        for reduced in (False, True):
            for name in tshapes.SHAPE_ORDER:
                assert tshapes.applicable(tget_config(arch, reduced), name) \
                    == jshapes.applicable(jget_config(arch, reduced), name)
    # the matrix: long_500k only for the sub-quadratic archs
    runs = [a for a in ARCHS
            if tshapes.applicable(tget_config(a), "long_500k")[0]]
    assert runs == ["falcon-mamba-7b", "mixtral-8x7b", "zamba2-2.7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax_at_full_size(arch):
    specs = TModel(tget_config(arch), device="cpu").param_specs()
    leaves = tree_lib.leaves(specs)
    assert leaves and all(x.device.type == "meta" for x in leaves)
    want = _jax_leaves(JModel(jget_config(arch)).param_specs())
    assert _stacked(specs) == want
    n = sum(x.numel() for x in leaves)
    assert n == sum(int(np.prod(s)) for s, _ in want.values())
    if arch == "qwen2-vl-72b":
        assert n * 2 / 2 ** 30 > 135        # bf16 GiB, never allocated


def _state_leaves(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_state_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch):
    for reduced in (False, True):
        jm = JModel(jget_config(arch, reduced))
        tm = TModel(tget_config(arch, reduced), device="cpu")
        for name in tshapes.SHAPE_ORDER:
            shape = tshapes.reduced_shape(name) if reduced \
                else tshapes.SHAPES[name]
            jshape = jshapes.reduced_shape(name) if reduced \
                else jshapes.SHAPES[name]
            for with_state in (True, False):
                got = _state_leaves(tm.input_specs(shape, with_state))
                want = _jax_leaves(jm.input_specs(jshape, with_state))
                if with_state and shape.mode == "decode":
                    # the port's decode position is a host int
                    assert got.pop("state/pos") == 0
                    assert want.pop("state/pos") == ((), "int32")
                assert all(v.device.type == "meta" for v in got.values())
                assert {k: (tuple(v.shape),
                            str(v.dtype).replace("torch.", ""))
                        for k, v in got.items()} == want, (name, reduced)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_inputs_follow_the_specs(arch):
    m = build(arch, reduced=True, device="cpu")
    for name in tshapes.SHAPE_ORDER:
        shape = tshapes.reduced_shape(name)
        specs = m.input_specs(shape)
        got = m.make_inputs(shape, torch.Generator().manual_seed(1))
        assert sorted(got) == sorted(specs)
        flat, want = _state_leaves(got), _state_leaves(specs)
        for k, spec in want.items():
            v = flat[k]
            if k == "state/pos":
                assert v == spec == 0
                continue
            assert v.shape == spec.shape and v.dtype == spec.dtype, k
            assert v.device.type == "cpu"
            if k in ("tokens", "labels"):
                assert 0 <= int(v.min()) and int(v.max()) < m.cfg.vocab_size
            elif k in ("extra_embeds", "enc_embeds", "state/enc_out"):
                std = v.float().std().item()
                assert 0.015 < std < 0.025, (k, std)
            elif k == "state/kv/k_pos":
                assert (v == -1).all()
            else:                          # a fresh state
                assert (v == 0).all(), k


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_smoke(arch):
    """tests/test_arch_smoke.py's contract on the port, reduced config:
    a loss step with a finite loss and a nonzero finite gradient, prefill
    logits [B, S, V] finite, four decode steps."""
    m = build(arch, reduced=True, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    batch = m.make_inputs(tshapes.reduced_shape("train_4k"),
                          torch.Generator().manual_seed(1))
    leaves = tree_lib.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = m.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    assert loss.shape == () and torch.isfinite(loss)
    gn = sum(g.float().abs().sum().item() for g in grads)
    assert np.isfinite(gn) and gn > 0

    sh = tshapes.reduced_shape("prefill_32k")
    batch = m.make_inputs(sh, torch.Generator().manual_seed(2))
    logits = m.prefill(params, batch)
    assert tuple(logits.shape) == (sh.global_batch, sh.seq_len,
                                   m.cfg.vocab_size)
    assert torch.isfinite(logits).all()

    b = 2
    enc = None
    if m.cfg.is_encoder_decoder:
        enc = torch.zeros((b, m.cfg.encoder_seq_len, m.cfg.d_model),
                          dtype=getattr(torch, m.cfg.dtype))
    state = m.init_decode_state(b, 16, enc_out=enc)
    toks = torch.tensor([1, 2], dtype=torch.int32)
    for _ in range(4):
        logits, state = m.decode_step(params, state, toks)
    assert tuple(logits.shape) == (b, m.cfg.vocab_size)
    assert torch.isfinite(logits).all() and state["pos"] == 4
