"""End-to-end training example of the PyTorch port: a ~100M-param
GLM-family model trained for a few hundred steps with the full stack —
deterministic zipfian data, AdamW + cosine schedule, async atomic
checkpointing, straggler monitoring, preemption-safe shutdown.

    PYTHONPATH=src python examples_torch/train_lm.py [--steps 200]
        [--tiny] [--device cpu]

(`python -m repro_torch.launch.train --arch <id>` runs the same loop on
a published config.) Runs on the card (`cuda`, which must exist) unless
`--device` names another device; `--tiny` trains 2 layers at width 64
over a 512-token vocabulary instead, a size the CPU takes in seconds.
`main` returns the trainer's run (params, optimizer state, step, logged
metrics, stragglers).
"""
import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import get_config
from repro_torch.data.lm import DataConfig
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig

# ~100M params: glm4 family scaled to 12L x 768
FULL = dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=2,
            d_ff=2048, vocab_size=32768, head_dim=64)
TINY = dict(FULL, num_layers=2, d_model=64, num_heads=4, d_ff=128,
            vocab_size=512, head_dim=16)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--tiny", action="store_true",
                    help="2 layers at width 64, vocab 512, in place of the "
                    "~100M model")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_config("glm4-9b"),
                              **(TINY if args.tiny else FULL))
    model = Model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    n_params = sum(x.numel() for x in tree_lib.leaves(params))
    print(f"model: {cfg.name} scaled -> {n_params/1e6:.1f}M params")

    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                      global_batch=8)
    opt = AdamWConfig(lr=6e-4, total_steps=args.steps,
                      warmup_steps=max(args.steps // 10, 10))
    run = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=50,
                        log_every=10)
    trainer = Trainer(model, data, opt, run)
    trainer.install_signal_handlers()

    def log(step, m):
        print(f"step {step:4d}  loss {m['loss']:.4f}  lr {m['lr']:.2e}  "
              f"{m['step_time_s']*1e3:.0f} ms")

    out = trainer.run(params, args.steps, on_metrics=log)
    first = out["history"][0][1]["loss"]
    last = out["history"][-1][1]["loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} over {out['step']} steps; "
          f"stragglers flagged: {len(out['stragglers'])}; "
          f"checkpoints in {args.ckpt_dir}")
    assert last < first, "loss did not decrease"
    return out


if __name__ == "__main__":
    main()
