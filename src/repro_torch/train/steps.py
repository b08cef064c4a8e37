"""The training step, ported from ``repro/train/steps.py``: mixed precision
(fp32 masters cast at use), gradient accumulation over microbatches in fp32,
remat, LR schedules, global-norm clipping and AdamW.

The step runs eagerly: PyTorch's autograd takes the place of
``jax.value_and_grad``, and ``ops.matmul`` / ``ops.attention`` carry their
own backward kernels (K1 on transposed operands, K6).  A ``use_fusion``
config trains through the fused layers, whose backward is the derived
graphs of ``fusion.autodiff`` (K5 on the card).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.fusion import rng
from repro_torch.models import lm
from repro_torch.optim import adamw as adamw_mod
from repro_torch.optim import schedules

__all__ = ["TrainConfig", "make_train_step", "init_train_state"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """As the reference's.  ``ep_axis`` and ``unroll_layers`` are accepted
    and have no effect here: a dense model on one device has no expert axis
    to shard and no layer scan to unroll.  ``grad_compression`` raises
    (it comes with the distributed slice, ROADMAP.md Queue 1)."""
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"            # cosine | wsd
    wsd_stable_frac: float = 0.8
    microbatches: int = 1               # gradient accumulation
    remat: bool = True
    grad_compression: bool = False
    loss_chunk: int = 512
    ep_axis: Optional[str] = "model"
    unroll_layers: bool = False
    dropout_seed: int = 0               # base seed for cfg.dropout_rate dropout,
    #                                     folded with the step index
    adamw: adamw_mod.AdamWConfig = adamw_mod.AdamWConfig()


def _lr(tcfg: TrainConfig, step):
    if tcfg.schedule == "wsd":
        stable = int(tcfg.wsd_stable_frac * tcfg.total_steps)
        return schedules.wsd_schedule(
            step, peak_lr=tcfg.peak_lr, warmup_steps=tcfg.warmup_steps,
            stable_steps=stable,
            decay_steps=max(tcfg.total_steps - tcfg.warmup_steps - stable, 1))
    return schedules.cosine_schedule(
        step, peak_lr=tcfg.peak_lr, warmup_steps=tcfg.warmup_steps,
        total_steps=tcfg.total_steps)


def _check(tcfg: TrainConfig):
    if tcfg.grad_compression:
        raise NotImplementedError(
            "grad_compression is not ported to repro_torch yet: it comes with "
            "distributed/ (ROADMAP.md, Queue 1, the distributed slice)")


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, seed: int = 0, *, device=None):
    """→ (params, opt_state): fp32 master parameters from ``seed`` on
    ``device`` (CUDA unless given), each requiring a gradient, and zeroed
    AdamW moments."""
    _check(tcfg)
    dev = resolve_device(device)
    params = lm.init_params(cfg, seed, device=dev, dtype=torch.float32)
    for p in adamw_mod.tree_leaves(params):
        p.requires_grad_(True)
    return params, adamw_mod.init_state(params, tcfg.adamw)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """→ ``train_step(params, opt_state, batch, step)`` → (params,
    opt_state, metrics {"loss", "lr", "grad_norm"} plus lm_loss's metrics
    without microbatching).  ``batch`` holds device tensors (see
    ``data.to_device``); params and moments are updated in place."""
    _check(tcfg)

    def loss_fn(params, microbatch, dropout_seed=None):
        return lm.lm_loss(cfg, params, microbatch, remat=tcfg.remat,
                          loss_chunk=tcfg.loss_chunk, dropout_seed=dropout_seed)

    def train_step(params, opt_state, batch, step):
        lr = _lr(tcfg, int(step))
        leaves = adamw_mod.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        # per-step dropout stream: the step index folded into the base seed
        dropout_seed = None
        if cfg.dropout_rate > 0.0:
            dropout_seed = rng.fold_in(tcfg.dropout_seed, int(step))
        nmb = tcfg.microbatches
        if nmb > 1:
            b = batch["tokens"].shape[0]
            if b % nmb:
                raise ValueError(f"batch {b} does not split into {nmb} microbatches")
            size = b // nmb
            grads, loss_sum = None, torch.zeros(())
            for i in range(nmb):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                mb_seed = rng.fold_in(dropout_seed, i) if dropout_seed is not None else None
                loss, _ = loss_fn(params, mb, mb_seed)
                g = torch.autograd.grad(loss, leaves)
                if grads is None:
                    grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
                for acc, gi in zip(grads, g):
                    acc.add_(gi.float())
                loss_sum = loss_sum.to(loss.device) + loss.detach()
                del g
            grads = [g.div_(nmb) for g in grads]
            loss = loss_sum / nmb
            metrics = {}
        else:
            loss, metrics = loss_fn(params, batch, dropout_seed)
            grads = list(torch.autograd.grad(loss, leaves))
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        # grads: a list in the order of tree_leaves(params), which is the
        # tree apply_updates walks; a named range lets a profile tell the
        # optimizer's device time
        with torch.profiler.record_function("adamw"):
            params, opt_state, opt_metrics = adamw_mod.apply_updates(
                params, grads, opt_state, lr=lr, cfg=tcfg.adamw)
        return params, opt_state, {"loss": loss, "lr": lr, **opt_metrics, **metrics}

    return train_step

