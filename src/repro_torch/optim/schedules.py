"""Learning-rate schedules, cosine and WSD (Warmup-Stable-Decay, the
minicpm-2b recipe [arXiv:2404.06395]), in fp32 as in
``repro/optim/schedules.py``.  Each returns a 0-d fp32 CPU tensor."""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "wsd_schedule"]


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_schedule(step, *, peak_lr, warmup_steps, total_steps,
                    final_frac: float = 0.1):
    step = _f32(step)
    warm = peak_lr * step / _f32(max(warmup_steps, 1))
    prog = torch.clamp((step - warmup_steps) / _f32(max(total_steps - warmup_steps, 1)),
                       0.0, 1.0)
    cos = final_frac * peak_lr + (1 - final_frac) * peak_lr * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)


def wsd_schedule(step, *, peak_lr, warmup_steps, stable_steps, decay_steps,
                 final_frac: float = 0.01):
    """Warmup → stable plateau → short exponential decay (WSD)."""
    step = _f32(step)
    warm = peak_lr * step / _f32(max(warmup_steps, 1))
    decay_start = warmup_steps + stable_steps
    prog = torch.clamp((step - decay_start) / _f32(max(decay_steps, 1)), 0.0, 1.0)
    decay = peak_lr * torch.pow(_f32(final_frac), prog)
    return torch.where(step < warmup_steps, warm,
                       torch.where(step < decay_start, _f32(peak_lr), decay))
