"""Batched serving: ``generate`` over the continuous-batching engine, and
the dense-cache loop ``generate_loop``.

Ported from ``repro/serve/decode.py``: ``make_serve_step`` (one token for the
whole batch against dense caches, greedy or through the counter-based
sampler), ``generate_loop`` (batch prefill, then one step per token) and
``generate``, which runs the prompts through :class:`~repro_torch.serve.
engine.Engine`.  The reference's ``ep_axis``/``unroll_layers`` settings and
its ``jit`` switch steer JAX compilation and have no counterpart here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.serve.sampling import sample_tokens

__all__ = ["ServeConfig", "make_serve_step", "generate", "generate_loop"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq: int = 2048
    greedy: bool = True
    temperature: float = 1.0
    top_k: int = 0               # 0 → off
    top_p: float = 1.0           # >= 1 → off
    seed: int = 0


def _knobs(scfg: ServeConfig, b: int, device):
    """Per-row sampler knobs, all rows alike."""
    return dict(
        temperature=torch.full((b,), scfg.temperature, dtype=torch.float32, device=device),
        top_k=torch.full((b,), scfg.top_k, dtype=torch.int64, device=device),
        top_p=torch.full((b,), scfg.top_p, dtype=torch.float32, device=device))


def make_serve_step(cfg: ModelConfig, scfg: ServeConfig):
    """→ step(params, caches, tokens (B,), pos) → (next tokens (B,), caches).

    With ``scfg.greedy`` the step takes the argmax.  Otherwise it draws
    through the counter-based sampler at ``scfg.temperature``/``top_k``/
    ``top_p`` and takes two more arguments: ``seed`` (an int) and ``uids``
    ((B,) per-request sampler keys)."""

    def greedy_step(params, caches, tokens, pos):
        logits, caches = lm.decode_step(cfg, params, caches, tokens, pos)
        return torch.argmax(logits, dim=-1), caches

    if scfg.greedy:
        return greedy_step

    def sampled_step(params, caches, tokens, pos, seed, uids):
        logits, caches = lm.decode_step(cfg, params, caches, tokens, pos)
        b = tokens.shape[0]
        positions = torch.full((b,), pos + 1, dtype=torch.int64, device=tokens.device)
        nxt = sample_tokens(logits, uids=uids, positions=positions, seed=seed,
                            **_knobs(scfg, b, tokens.device))
        return nxt, caches

    return sampled_step


def _validate(scfg: ServeConfig, p: int, num_new: int) -> None:
    if num_new < 1:
        raise ValueError(f"num_new must be >= 1, got {num_new}")
    if p + num_new > scfg.max_seq:
        raise ValueError(
            f"prompt ({p}) + num_new ({num_new}) = {p + num_new} exceeds "
            f"ServeConfig.max_seq ({scfg.max_seq}); raise max_seq or "
            f"shorten the request")


def generate(cfg: ModelConfig, params, prompts, num_new: int, *,
             scfg: ServeConfig = ServeConfig()):
    """prompts (B, P) integer tensor or array → (B, P + num_new) int64 on
    the parameters' device, served by the continuous-batching engine (paged
    KV cache, one slot per prompt).  Request i gets sampler uid i, so the
    tokens equal :func:`generate_loop`'s."""
    from repro_torch.serve.engine import Engine, EngineConfig

    prompts = np.asarray(torch.as_tensor(prompts).cpu())
    b, p = prompts.shape
    _validate(scfg, p, num_new)
    ecfg = EngineConfig(
        num_slots=b, page_size=16, max_seq=p + num_new,
        segment_len=min(8, num_new), eos_token=None, seed=scfg.seed)
    eng = Engine(cfg, params, ecfg)
    temperature = 0.0 if scfg.greedy else scfg.temperature
    uids = [eng.submit(prompts[i], num_new, temperature=temperature,
                       top_k=scfg.top_k, top_p=scfg.top_p)
            for i in range(b)]
    done = eng.run()
    return torch.tensor([done[uid] for uid in uids], dtype=torch.int64,
                        device=eng.device)


def generate_loop(cfg: ModelConfig, params, prompts, num_new: int, *,
                  scfg: ServeConfig = ServeConfig()):
    """prompts (B, P) integer tensor or array → (B, P + num_new) int64 on
    the parameters' device: batch prefill, then one step per token on dense
    caches, greedy or sampled (row i keyed by uid i)."""
    dev = params["embed"].device
    prompts = torch.as_tensor(prompts, device=dev).long()
    b, p = prompts.shape
    _validate(scfg, p, num_new)
    caches = lm.init_cache(cfg, b, p + num_new, device=dev)
    logits, caches = lm.prefill(cfg, params, caches, {"tokens": prompts})
    step = make_serve_step(cfg, scfg)
    if scfg.greedy:
        tok = torch.argmax(logits, dim=-1)
        extra = ()
    else:
        uids = torch.arange(b, dtype=torch.int64, device=dev)
        positions = torch.full((b,), p, dtype=torch.int64, device=dev)
        tok = sample_tokens(logits, uids=uids, positions=positions,
                            seed=scfg.seed, **_knobs(scfg, b, dev))
        extra = (scfg.seed, uids)
    out = [tok]
    for t in range(num_new - 1):
        tok, caches = step(params, caches, tok, p + t, *extra)
        out.append(tok)
    return torch.cat([prompts, torch.stack(out, dim=1)], dim=1)
