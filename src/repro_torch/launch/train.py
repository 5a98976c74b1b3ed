"""Training launcher of the port: `python -m repro_torch.launch.train
--arch chatglm3-6b [--reduced] [--steps N] ... [--device cpu]`, the flags
and defaults of `repro/launch/train.py` plus `--device` (default: cuda,
which must exist). Wires: config -> model -> fault-tolerant Trainer
(checkpoint/resume/preemption) -> metrics log. The default checkpoint
directory lies under the system's temporary directory; a run resumes from
the latest checkpoint it finds there.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.data.lm import DataConfig
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: TrainerConfig's)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    batch = args.batch or (4 if args.reduced else 256)
    seq = args.seq or (64 if args.reduced else 4096)
    model = Model(cfg, remat=args.remat, device=args.device)
    params = model.init(torch.Generator(device=model.device)
                        .manual_seed(args.seed))

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=args.seed)
    tcfg = TrainerConfig(ckpt_every=args.ckpt_every)
    if args.ckpt_dir:
        tcfg.ckpt_dir = args.ckpt_dir
    ocfg = opt_config(args.lr, args.steps)

    trainer = Trainer(model, dcfg, ocfg, tcfg)
    trainer.install_signal_handlers()

    def log(step, m):
        print(f"step {step:5d}  loss {m['loss']:.4f}  "
              f"lr {m['lr']:.2e}  gnorm {m['grad_norm']:.2f}  "
              f"{m['step_time_s']*1e3:.0f} ms")

    out = trainer.run(params, args.steps, on_metrics=log)
    print(f"done at step {out['step']}; preempted={out['preempted']}; "
          f"stragglers={len(out['stragglers'])}")
    return out


def opt_config(lr: float, steps: int) -> AdamWConfig:
    """AdamW as the launcher builds it: warmup over a twentieth of the
    steps, at least 5."""
    return AdamWConfig(lr=lr, total_steps=steps,
                       warmup_steps=max(steps // 20, 5))


if __name__ == "__main__":
    main()
