"""The port's gradient compression (`repro_torch.optim.compression`)
against the JAX package's: q, the scales and the decompressed values bit
for bit on the same numpy inputs; `compressed_allreduce` on a world-1
gloo group against JAX's under `shard_map` on its 1-device mesh. Then one
spawned run of 4 gloo processes: the 4-rank compressed sum, and the (2, 2)
mesh's sharded prefill (and decode) of reduced models against the
unsharded ones in fp32."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch
import torch.distributed as dist  # noqa: E402

from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.optim import compression as comp  # noqa: E402

SHAPES = [(1000,), (64, 256), (3, 7, 129), (256,), (5,)]
WORLD = 4
TOL = 1e-4          # of the largest |logit|, fp32 (2, 2) vs one device


def _grad(shape, seed, dtype=np.float32):
    g = np.random.default_rng(seed).standard_normal(shape).astype(dtype)
    if shape == (64, 256):
        g[3] = 0.0                          # an all-zero block
    return g


@pytest.mark.parametrize("shape", SHAPES)
def test_compress_equals_jax_bit_for_bit(shape):
    g = _grad(shape, 0)
    q, s = comp.compress_int8(torch.from_numpy(g))
    jq, js = jcomp.compress_int8(jnp.asarray(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy().view(np.int32),
                          np.asarray(js).view(np.int32))
    back = comp.decompress_int8(q, s, shape, torch.float32)
    jback = jcomp.decompress_int8(jq, js, shape, jnp.float32)
    assert np.array_equal(back.numpy().view(np.int32),
                          np.asarray(jback).view(np.int32))


def test_compress_bf16_and_zeros_equal_jax():
    """A bf16 gradient (cast to fp32 first) and an all-zero one (scale at
    its 1e-12 floor, q all zero)."""
    g = _grad((3, 300), 1)
    gt = torch.from_numpy(g).to(torch.bfloat16)
    jg = jnp.asarray(g).astype(jnp.bfloat16)
    for t, j in ((gt, jg), (torch.zeros(700), jnp.zeros(700))):
        q, s = comp.compress_int8(t)
        jq, js = jcomp.compress_int8(j)
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert np.array_equal(s.numpy(), np.asarray(js))
    assert float(s.min()) == np.float32(1e-12)
    out = comp.decompress_int8(q, s, (700,), torch.bfloat16)
    assert out.dtype == torch.bfloat16 and not out.any()


@pytest.fixture
def world1():
    """A world-1 gloo group, destroyed after the test."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_compressed_allreduce_world1_equals_jax_shard_map(world1):
    """Over one rank (a gloo group) and one device (JAX's shard_map on its
    1-device mesh): the reduced grads and the new error of a tree of an
    fp32 and a bf16 leaf, with an error carried in, bit for bit."""
    from jax.sharding import PartitionSpec as JP
    g = {"a": _grad((2, 300), 2), "b": _grad((7,), 3)}
    e = {"a": _grad((2, 300), 4) * 1e-3, "b": _grad((7,), 5) * 1e-3}
    tg = {"a": torch.from_numpy(g["a"]),
          "b": torch.from_numpy(g["b"]).to(torch.bfloat16)}
    te = {k: torch.from_numpy(v) for k, v in e.items()}
    red, err = comp.compressed_allreduce(tg, world1, te)
    mesh = jax.make_mesh((1,), ("d",))
    jg = {"a": jnp.asarray(g["a"]),
          "b": jnp.asarray(g["b"]).astype(jnp.bfloat16)}
    je = {k: jnp.asarray(v) for k, v in e.items()}
    spec = {"a": JP(), "b": JP()}
    jred, jerr = jax.shard_map(
        lambda x, y: jcomp.compressed_allreduce(x, "d", y), mesh=mesh,
        in_specs=(spec, spec), out_specs=(spec, spec))(jg, je)
    for k in g:
        assert red[k].dtype == tg[k].dtype
        assert np.array_equal(red[k].float().numpy(),
                              np.asarray(jred[k]).astype(np.float32))
        assert np.array_equal(err[k].numpy(), np.asarray(jerr[k]))
    _, new = comp.compressed_allreduce(tg, world1)    # error=None: zeros
    assert torch.equal(new["a"], tg["a"] - comp.decompress_int8(
        *comp.compress_int8(tg["a"]), (2, 300), torch.float32))


def _reduced(arch):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, reduced=True),
                               dtype="float32")


def _prefill_case(mesh, arch, b=4, s=32, attn_impl="blockwise"):
    """The sharded prefill of a reduced fp32 model against the unsharded
    one, both with `attn_impl`; a VLM with patches and [3, B, S]
    positions. Returns (err, top)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import shardings as sh
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    cfg = _reduced(arch)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    p = 8 if cfg.frontend == "vision" else 0
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s - p),
                                     generator=g)}
    kw = {"attn_impl": attn_impl}
    if p:
        batch["extra_embeds"] = torch.randn(b, p, cfg.d_model,
                                            generator=g) * 0.02
        pos = torch.arange(s)[None, None].repeat(3, b, 1)
        kw["positions"] = pos
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = torch.randn(b, cfg.encoder_seq_len,
                                          cfg.d_model, generator=g) * 0.02

    def run(prm, bt, **k):
        return T.lm_forward(prm, cfg, bt["tokens"],
                            extra_embeds=bt.get("extra_embeds"),
                            enc_embeds=bt.get("enc_embeds"), **k)[0]
    ref = run(params, batch, **kw)
    dp = sh.distribute(params, mesh, sh.param_shardings(mesh, params),
                       src_data_rank=None)
    db = sh.distribute(batch, mesh, sh.batch_shardings(mesh, batch),
                       src_data_rank=None)
    if p:
        kw["positions"] = sh.distribute_leaf(pos, mesh, sh.P(None, "data"),
                                             src_data_rank=None)
    with implicit_replication():
        out = run(dp, db, **kw).full_tensor()
    return (out - ref).abs().max().item(), ref.abs().max().item()


def _decode_case(mesh, arch, b=2, steps=4, max_len=16):
    """Teacher-forced decode with the state laid out by
    `decode_state_shardings` (the cache length over "model": flash
    decoding) against the unsharded decode."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import shardings as sh
    from repro_torch.models.model import Model
    cfg = _reduced(arch)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (b, steps),
                         generator=torch.Generator().manual_seed(2))
    dp = sh.distribute(params, mesh, sh.param_shardings(mesh, params),
                       src_data_rank=None)
    st = model.init_decode_state(b, max_len)
    dst = sh.distribute(model.init_decode_state(b, max_len), mesh,
                        sh.decode_state_shardings(mesh, st, cfg),
                        src_data_rank=None)
    err = top = 0.0
    with implicit_replication():
        for t in range(steps):
            ref, st = model.decode_step(params, st, toks[:, t])
            out, dst = model.decode_step(dp, dst, sh.distribute_leaf(
                toks[:, t].contiguous(), mesh, sh.P("data"),
                src_data_rank=None))
            err = max(err, (out.full_tensor() - ref).abs().max().item())
            top = max(top, ref.abs().max().item())
    return err, top


def _worker(rank, path):
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=WORLD)
    try:
        flat = make_host_mesh(1, "cpu")
        ones = {"w": torch.ones(300), "b": torch.ones(3,
                                                      dtype=torch.bfloat16)}
        red, _ = comp.compressed_allreduce(ones, (flat, "data"))
        assert all(bool((v == WORLD).all()) for v in red.values())
        grads = [torch.from_numpy(_grad((5, 300), 10 + r))
                 for r in range(WORLD)]
        mine = {"w": grads[rank]}
        red, err = comp.compressed_allreduce(mine, (flat, "data"))
        parts = [comp.decompress_int8(*comp.compress_int8(g), g.shape,
                                      torch.float32) for g in grads]
        mag = sum(p.abs() for p in parts)
        ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=1e-30)))
                         - 23)
        assert bool(((red["w"] - sum(parts)).abs() <= 4 * ulp).all())
        assert torch.equal(err["w"], grads[rank] - parts[rank])
        mesh = make_host_mesh(2, "cpu")
        for arch in ("qwen2-vl-72b", "olmoe-1b-7b", "falcon-mamba-7b",
                     "zamba2-2.7b", "seamless-m4t-large-v2"):
            e, top = _prefill_case(mesh, arch)
            assert e <= TOL * top, (arch, e, top)
        for arch in ("qwen2-vl-72b", "zamba2-2.7b"):
            e, top = _decode_case(mesh, arch)
            assert e <= TOL * top, (arch, "decode", e, top)
        # the flash wrapper (its plain version on CPU tensors) on local
        # shards: kv heads split with the q heads (qwen2-vl, 2 of 4 q and
        # 1 of 2 kv heads a rank), and picked per q head (chatglm3 on a
        # (1, 4) mesh: 1 q head a rank, its kv head rank // 2)
        for m, arch in ((mesh, "qwen2-vl-72b"),
                        (make_host_mesh(4, "cpu"), "chatglm3-6b")):
            e, top = _prefill_case(m, arch, attn_impl="flash")
            assert e <= TOL * top, (arch, "flash", e, top)
    finally:
        dist.destroy_process_group()


def test_four_ranks_sum_and_sharded_prefill(tmp_path):
    """4 gloo processes: ones sum to exactly 4; seeded grads to the sum of
    the four decompressions within 4 fp32 ulps of their summed magnitude,
    the error feedback the residual; on the (2, 2) ("data", "model") mesh
    the prefill of five reduced fp32 models (the VLM, MoE, ssm, hybrid
    and encoder-decoder families) laid out by the sharding rules, and the
    decode of two, within 1e-4 of the largest |logit| of the unsharded
    run; so too the prefill through the flash wrapper, on the (2, 2) mesh
    and on a (1, 4) mesh whose ranks pick their GQA kv head."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_worker, args=(str(tmp_path / "rdv"),),
                             nprocs=WORLD, join=False,
                             start_method="spawn")
    t0 = time.time()
    try:
        while not ctx.join(timeout=5):
            assert time.time() - t0 < 240, "the 4-rank run timed out"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in ctx.processes)
