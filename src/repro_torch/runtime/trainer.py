"""Fault-tolerant training loop (port of `repro/runtime/trainer.py`).

  * resume-exact: deterministic data (TokenPipeline.batch_at(step)) +
    checkpointed (params, opt, step) -> any step is replayable;
  * preemption-safe: SIGTERM/SIGINT (`install_signal_handlers`) stops the
    loop, and a final synchronous checkpoint is written before it returns;
  * async checkpointing every ckpt_every steps with atomic commit;
  * straggler monitor: per-step wall time EWMA; steps slower than
    `straggler_factor` x EWMA are recorded in `straggler_events`.

A step is the loss, `torch.autograd.grad` over the param leaves (the
counterpart of `jax.value_and_grad`: no `.grad` state is kept), then
`adamw_update`, which writes the params and the optimizer state in place
(the counterpart of JAX donating them). The host reads the step's loss,
learning rate and grad norm once per step: its one sync with the device.
The trainer runs on the model's device.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.data.lm import DataConfig, TokenPipeline
from repro_torch.optim import adamw


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    ckpt_every: int = 50
    keep_last: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    ewma: float = 0.9


class Trainer:
    def __init__(self, model, data_cfg: DataConfig,
                 opt_cfg: adamw.AdamWConfig, run_cfg: TrainerConfig,
                 loss_fn: Optional[Callable] = None):
        self.model = model
        self.data = TokenPipeline(data_cfg, device=model.device)
        self.opt_cfg = opt_cfg
        self.cfg = run_cfg
        self.ckpt = ckpt_lib.Checkpointer(run_cfg.ckpt_dir,
                                          keep_last=run_cfg.keep_last)
        self._preempted = False
        self._step_ewma: Optional[float] = None
        self.straggler_events = []
        self.loss = loss_fn or (lambda p, b: model.loss(p, b)[0])

    def loss_and_grads(self, params: Any, batch: Dict):
        """(loss, gradient tree of params' structure): the first half of
        `train_step`. The param leaves require grad during the loss and
        its gradient only."""
        leaves = tree_lib.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            lval = self.loss(params, batch)
            grads = torch.autograd.grad(lval, leaves, allow_unused=True,
                                        materialize_grads=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        return lval.detach(), tree_lib.unflatten(params, list(grads))

    def train_step(self, params: Any, opt_state: Dict, batch: Dict):
        """One step; params and opt_state are updated in place. Returns
        (params, opt_state, metrics {"loss", "lr", "grad_norm"} as 0-d
        tensors)."""
        lval, grads = self.loss_and_grads(params, batch)
        params, opt_state, metrics = adamw.adamw_update(
            self.opt_cfg, params, grads, opt_state)
        metrics["loss"] = lval
        return params, opt_state, metrics

    # -- preemption ----------------------------------------------------------
    def install_signal_handlers(self):
        def handler(signum, frame):
            self._preempted = True
        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)

    # -- run -------------------------------------------------------------------
    def run(self, params: Any, num_steps: int, *,
            start_step: Optional[int] = None,
            on_metrics: Optional[Callable[[int, Dict], None]] = None
            ) -> Dict:
        """Train; resumes from the latest checkpoint if one exists (its
        params replace `params`). Returns the trained params (the tensors
        updated in place), the optimizer state, the step reached, the
        logged metrics, the straggler events and whether the run was
        preempted."""
        opt_state = adamw.adamw_init(params)
        step = 0
        latest = ckpt_lib.latest_step(self.cfg.ckpt_dir)
        if start_step is None and latest is not None:
            tree = ckpt_lib.restore(self.cfg.ckpt_dir, latest,
                                    {"params": params, "opt": opt_state})
            params, opt_state = tree["params"], tree["opt"]
            step = latest
        elif start_step is not None:
            step = start_step

        history = []
        while step < num_steps and not self._preempted:
            t0 = time.perf_counter()
            batch = self.data.batch_at(step)
            params, opt_state, metrics = self.train_step(
                params, opt_state, batch)
            names = sorted(metrics)
            values = torch.stack([metrics[k].float() for k in names]) \
                .tolist()                       # the step's one host sync
            dt = time.perf_counter() - t0
            step += 1

            # straggler detection
            if self._step_ewma is None:
                self._step_ewma = dt
            else:
                if dt > self.cfg.straggler_factor * self._step_ewma:
                    self.straggler_events.append((step, dt, self._step_ewma))
                self._step_ewma = (self.cfg.ewma * self._step_ewma
                                   + (1 - self.cfg.ewma) * dt)

            if step % self.cfg.log_every == 0 or step == num_steps:
                m = dict(zip(names, values))
                m["step_time_s"] = dt
                history.append((step, m))
                if on_metrics:
                    on_metrics(step, m)
            if step % self.cfg.ckpt_every == 0:
                self.ckpt.save_async(step, {"params": params,
                                            "opt": opt_state},
                                     extra={"step": step})

        # preemption or completion: final synchronous checkpoint
        self.ckpt.wait()
        ckpt_lib.save(self.cfg.ckpt_dir, step,
                      {"params": params, "opt": opt_state},
                      extra={"step": step,
                             "preempted": bool(self._preempted)},
                      keep_last=self.cfg.keep_last)
        return {"params": params, "opt": opt_state, "step": step,
                "history": history,
                "stragglers": list(self.straggler_events),
                "preempted": self._preempted}
