"""The port's training path (`repro_torch.runtime.trainer`, `launch/
train.py`) against the JAX package's, and the gradients of its kernels.

  * three `Trainer.run` steps of reduced chatglm3-6b and zamba2-2.7b in
    float32 against JAX's `Trainer.run` from the same converted weights
    and the same `DataConfig`: losses, learning rates and grad norms
    within 1e-4 (relative for the norm), params after within 1e-5 (each
    AdamW step moves a param by at most about lr = 3e-4 times a
    normalised update, whose error follows the gradients' 1e-4 relative
    one);
  * JAX's `test_trainer_resume_and_preemption`, mirrored, and resume
    exactness: a run resumed from step 3's checkpoint replays steps 4-6
    bit for bit;
  * `ref.mamba_scan_bwd` equals autograd through `ref.mamba_scan` bit for
    bit, in fp32 and bf16, and so do the gradients through
    `kops.mamba_scan` on the CPU;
  * `flash_attention` and `paged_attention` refuse to be differentiated,
    as the JAX package cannot differentiate its kernels, and a trainer
    with attn_impl="flash" fails at its first step.
"""
import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro.configs import get_config as jget_config
from repro.data.lm import DataConfig as JDataConfig
from repro.models.model import Model as JModel
from repro.optim import adamw as jadamw
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.configs import get_config as tget_config
from repro_torch.data.lm import DataConfig
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as train_cli
from repro_torch.models.model import Model, build
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def _f32(arch, jax_side):
    get = jget_config if jax_side else tget_config
    return dataclasses.replace(get(arch, reduced=True), dtype="float32")


@pytest.mark.parametrize("arch", ["chatglm3-6b", "zamba2-2.7b"])
def test_trainer_follows_jax(arch, tmp_path):
    jm = JModel(_f32(arch, True))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = convert.from_jax(jax.tree.map(np.asarray, jp))
    dkw = dict(vocab_size=jm.cfg.vocab_size, seq_len=16, global_batch=2)
    okw = dict(total_steps=3, warmup_steps=1)
    jout = JTrainer(jm, JDataConfig(**dkw), jadamw.AdamWConfig(**okw),
                    JTrainerConfig(ckpt_dir=str(tmp_path / "jax"),
                                   log_every=1)).run(jp, 3)
    tm = Model(_f32(arch, False), device="cpu")
    tout = Trainer(tm, DataConfig(**dkw), AdamWConfig(**okw),
                   TrainerConfig(ckpt_dir=str(tmp_path / "torch"),
                                 log_every=1)).run(tp, 3)
    assert tout["step"] == jout["step"] == 3
    assert [s for s, _ in tout["history"]] == [1, 2, 3]
    for (_, tm_), (_, jm_) in zip(tout["history"], jout["history"]):
        assert abs(tm_["loss"] - jm_["loss"]) < 1e-4
        assert abs(tm_["lr"] - jm_["lr"]) < 1e-10
        assert abs(tm_["grad_norm"] - jm_["grad_norm"]) \
            < 1e-4 * jm_["grad_norm"]
    want = convert.from_jax(jax.tree.map(np.asarray, jout["params"]))
    names, got = tree_lib.flatten_with_paths(tout["params"])
    assert tree_lib.flatten_with_paths(want)[0] == names
    for name, g, w in zip(names, got, tree_lib.leaves(want)):
        assert not g.requires_grad
        assert (g - w).abs().max().item() < 1e-5, name
    assert int(tout["opt"]["step"]) == 3


def test_trainer_resume_and_preemption(tmp_path):
    m = build("chatglm3-6b", reduced=True, device="cpu")
    dcfg = DataConfig(vocab_size=m.cfg.vocab_size, seq_len=16,
                      global_batch=2)
    d = str(tmp_path)
    tcfg = TrainerConfig(ckpt_dir=d, ckpt_every=4, log_every=2)
    ocfg = AdamWConfig(total_steps=20, warmup_steps=2)

    def init(seed):
        return m.init(torch.Generator().manual_seed(seed))
    tr = Trainer(m, dcfg, ocfg, tcfg)
    out = tr.run(init(0), num_steps=6)
    assert out["step"] == 6
    # simulated preemption: handler sets the flag mid-run
    tr2 = Trainer(m, dcfg, ocfg, tcfg)
    tr2._preempted = True
    out2 = tr2.run(init(1), num_steps=12)
    assert out2["preempted"] and out2["step"] == 6  # saved, no steps
    # a fresh trainer resumes from 6 and continues
    tr3 = Trainer(m, dcfg, ocfg, tcfg)
    out3 = tr3.run(init(2), num_steps=10)
    assert out3["step"] == 10


def test_resume_replays_exactly(tmp_path):
    m = Model(tget_config("zamba2-2.7b", reduced=True), remat="full",
              device="cpu")
    dcfg = DataConfig(vocab_size=m.cfg.vocab_size, seq_len=16,
                      global_batch=2, seed=3)
    ocfg = AdamWConfig(total_steps=6, warmup_steps=2)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    whole = Trainer(m, dcfg, ocfg, TrainerConfig(
        ckpt_dir=a, ckpt_every=3, log_every=1, keep_last=5)).run(
        m.init(torch.Generator().manual_seed(0)), 6)
    os.makedirs(b)
    shutil.copytree(os.path.join(a, "step_3"), os.path.join(b, "step_3"))
    resumed = Trainer(m, dcfg, ocfg, TrainerConfig(
        ckpt_dir=b, ckpt_every=3, log_every=1)).run(
        m.init(torch.Generator().manual_seed(9)), 6)
    assert [s for s, _ in resumed["history"]] == [4, 5, 6]
    assert [h["loss"] for _, h in resumed["history"]] == \
        [h["loss"] for _, h in whole["history"][3:]]
    assert all(torch.equal(x, y) for x, y in zip(
        tree_lib.leaves(resumed["params"]), tree_lib.leaves(whole["params"])))
    assert all(torch.equal(x, y) for x, y in zip(
        tree_lib.leaves(resumed["opt"]), tree_lib.leaves(whole["opt"])))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 64, 8, 16), (2, 37, 3, 5),
                                   (2, 1, 4, 4), (1, 0, 2, 3)])
def test_mamba_scan_bwd_is_autograd_bit_for_bit(shape, dtype):
    g = torch.Generator().manual_seed(sum(shape))
    a = (0.3 + 0.7 * torch.rand(shape, generator=g)).to(dtype)
    b = torch.randn(shape, generator=g).to(dtype)
    h0 = torch.randn((shape[0],) + shape[2:], generator=g)
    dh_all = torch.randn(shape, generator=g)
    dh_last = torch.randn(h0.shape, generator=g)
    ins = [t.clone().requires_grad_() for t in (a, b, h0)]
    h_all, h_last = ref.mamba_scan(*ins)
    # at S = 0 h_all is empty and outside the graph
    outs = [(h_all, dh_all), (h_last, dh_last)][0 if shape[1] else 1:]
    want = torch.autograd.grad([o for o, _ in outs], ins,
                               [d for _, d in outs], allow_unused=True,
                               materialize_grads=True)
    got = ref.mamba_scan_bwd(a, h0, h_all.detach(), dh_all, dh_last)
    assert [x.dtype for x in got] == [dtype, dtype, torch.float32]
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    # the wrapper's autograd Function (its plain version on the CPU)
    ins = [t.clone().requires_grad_() for t in (a, b, h0)]
    fwd = ops.mamba_scan(*ins)
    assert all(torch.equal(x, y.detach()) for x, y in zip(fwd,
                                                          (h_all, h_last)))
    via_ops = torch.autograd.grad(fwd, ins, [dh_all, dh_last])
    assert all(torch.equal(x, y) for x, y in zip(via_ops, want))


def test_attention_kernels_refuse_grads(tmp_path):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 2, 16, generator=g, requires_grad=True)
    k = torch.randn(1, 8, 2, 16, generator=g)
    with pytest.raises(NotImplementedError, match="no gradient"):
        ops.flash_attention(q, k, k)
    with torch.no_grad():
        ops.flash_attention(q, k, k)
    kp = torch.randn(4, 4, 1, 16, generator=g, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no gradient"):
        ops.paged_attention(q[:, 0].detach(), kp, kp.detach(),
                            torch.zeros(1, 2, dtype=torch.int32),
                            torch.ones(1, dtype=torch.int32))
    m = Model(tget_config("chatglm3-6b", reduced=True), attn_impl="flash",
              device="cpu")
    tr = Trainer(m, DataConfig(vocab_size=m.cfg.vocab_size, seq_len=16,
                               global_batch=2), AdamWConfig(),
                 TrainerConfig(ckpt_dir=str(tmp_path)))
    with pytest.raises(NotImplementedError, match="no gradient"):
        tr.run(m.init(torch.Generator().manual_seed(0)), 1)


def test_train_cli_on_the_cpu(tmp_path, capsys):
    out = train_cli.main(["--arch", "chatglm3-6b", "--reduced", "--steps",
                          "4", "--device", "cpu", "--ckpt-dir",
                          str(tmp_path)])
    text = capsys.readouterr().out
    assert out["step"] == 4 and "done at step 4" in text
    assert os.path.isdir(tmp_path / "step_4")
    assert train_cli.opt_config(3e-4, 200).warmup_steps == 10
