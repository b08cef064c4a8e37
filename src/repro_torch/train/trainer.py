"""Fault-tolerant training loop, ported from ``repro/train/trainer.py``.

  * checkpoint/restart: periodic atomic checkpoints of (params, optimizer,
    data cursor); ``resume=True`` picks up the latest one, and a run that
    was preempted and resumed reproduces the uninterrupted run bit for bit
    (every kernel of the step is deterministic: no float atomics);
  * straggler watchdog: each step's wall time against an EWMA seeded from
    the second step; steps slower than ``straggler_factor`` x are recorded;
  * ``preempt_after`` simulates a preemption (fault injection for tests);
  * ``step_callback(step, params, metrics)`` after every step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus, to_device
from repro_torch.train.steps import TrainConfig, init_train_state, make_train_step

__all__ = ["TrainerConfig", "SimulatedPreemption", "train"]


class SimulatedPreemption(RuntimeError):
    pass


@dataclasses.dataclass
class TrainerConfig:
    num_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    resume: bool = True
    log_every: int = 10
    straggler_factor: float = 2.5
    preempt_after: Optional[int] = None      # fault injection (tests)
    step_callback: Optional[Callable] = None


def train(cfg: ModelConfig, tcfg: TrainConfig, dcfg: DataConfig,
          rcfg: TrainerConfig, *, seed: int = 0, device=None):
    """Run the loop on ``device`` (CUDA unless given); → (params,
    opt_state, history {"loss", "step_time", "slow_steps", "grad_norm"})."""
    dev = resolve_device(device)
    params, opt_state = init_train_state(cfg, tcfg, seed, device=dev)
    start_step = 0
    corpus = SyntheticCorpus(dcfg)

    if rcfg.resume and rcfg.ckpt_dir and latest_step(rcfg.ckpt_dir) is not None:
        (params, opt_state), start_step, extra = restore_checkpoint(
            rcfg.ckpt_dir, (params, opt_state))
        corpus = SyntheticCorpus.from_state(dcfg, extra["data"])
        print(f"[trainer] resumed from step {start_step}")

    step_fn = make_train_step(cfg, tcfg)
    history = {"loss": [], "step_time": [], "slow_steps": [], "grad_norm": []}
    ewma = None
    t_prev = time.perf_counter()
    for step in range(start_step, rcfg.num_steps):
        batch = to_device(next(corpus), dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        loss = float(metrics["loss"])
        now = time.perf_counter()
        dt = now - t_prev
        t_prev = now

        # the first step builds the kernels and would mask every straggler
        if step == start_step:
            note = " (build)"
        else:
            note = ""
            if ewma is None:
                ewma = dt
            if dt > rcfg.straggler_factor * ewma:
                history["slow_steps"].append((step, dt, ewma))
                print(f"[watchdog] step {step} took {dt * 1e3:.1f}ms "
                      f"(EWMA {ewma * 1e3:.1f}ms) — straggler flagged")
            ewma = 0.9 * ewma + 0.1 * dt

        history["loss"].append(loss)
        history["step_time"].append(dt)
        history["grad_norm"].append(float(metrics["grad_norm"]))
        if rcfg.log_every and step % rcfg.log_every == 0:
            print(f"[trainer] step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} {dt * 1e3:.0f}ms{note}")
        if rcfg.step_callback:
            rcfg.step_callback(step, params, metrics)

        done = step + 1
        if rcfg.ckpt_dir and (done % rcfg.ckpt_every == 0 or done == rcfg.num_steps):
            save_checkpoint(rcfg.ckpt_dir, done, (params, opt_state),
                            extra={"data": corpus.state()})
        if rcfg.preempt_after is not None and done >= rcfg.preempt_after:
            raise SimulatedPreemption(f"preempted after step {done}")
    return params, opt_state, history
