"""Batched greedy serving on a dense KV cache.

Ported from ``repro/serve/decode.py``: ``make_serve_step`` (one greedy token
for the whole batch against the caches) and ``generate_loop`` (batch
prefill, then one step per token).  Sampled decoding and ``generate``, the
wrapper over the continuous-batching engine, are ported with the engine
(ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm

__all__ = ["ServeConfig", "make_serve_step", "generate_loop"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq: int = 2048
    greedy: bool = True


def make_serve_step(cfg: ModelConfig, scfg: ServeConfig):
    """→ step(params, caches, tokens (B,), pos) → (next tokens (B,), caches)."""
    if not scfg.greedy:
        raise NotImplementedError(
            "sampled decoding is not ported to repro_torch yet; see ROADMAP.md, Queue 1")

    def greedy_step(params, caches, tokens, pos):
        logits, caches = lm.decode_step(cfg, params, caches, tokens, pos)
        return torch.argmax(logits, dim=-1), caches

    return greedy_step


def _validate(scfg: ServeConfig, p: int, num_new: int) -> None:
    if num_new < 1:
        raise ValueError(f"num_new must be >= 1, got {num_new}")
    if p + num_new > scfg.max_seq:
        raise ValueError(
            f"prompt ({p}) + num_new ({num_new}) = {p + num_new} exceeds "
            f"ServeConfig.max_seq ({scfg.max_seq}); raise max_seq or "
            f"shorten the request")


def generate_loop(cfg: ModelConfig, params, prompts, num_new: int, *,
                  scfg: ServeConfig = ServeConfig()):
    """prompts (B, P) integer tensor or array → (B, P + num_new) int64 on
    the parameters' device: batch prefill, then one greedy step per token."""
    dev = params["embed"].device
    prompts = torch.as_tensor(prompts, device=dev).long()
    b, p = prompts.shape
    _validate(scfg, p, num_new)
    caches = lm.init_cache(cfg, b, p + num_new, device=dev)
    logits, caches = lm.prefill(cfg, params, caches, {"tokens": prompts})
    step = make_serve_step(cfg, scfg)
    tok = torch.argmax(logits, dim=-1)
    out = [tok]
    for t in range(num_new - 1):
        tok, caches = step(params, caches, tok, p + t)
        out.append(tok)
    return torch.cat([prompts, torch.stack(out, dim=1)], dim=1)
