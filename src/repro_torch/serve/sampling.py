"""Counter-based token sampling (temperature / top-k / top-p), ported from
``repro/serve/sampling.py`` to give the reference's tokens on the same logits.

Every draw is a pure function of ``(seed, request uid, sequence position)``
through threefry2x32 (``repro_torch.fusion.rng``), so a request's i-th token
does not depend on its slot, its batch or how decoding was segmented.  The
knobs are per-row tensors: ``temperature <= 0`` → greedy argmax,
``top_k == 0`` → no top-k cut, ``top_p >= 1`` → no nucleus cut.  Sampling is
gumbel-argmax over the filtered, temperature-scaled logits, with the
reference's float steps kept one for one.
"""
from __future__ import annotations

import torch

from repro_torch.fusion import rng

__all__ = ["SAMPLER_SALT", "sample_tokens"]

SAMPLER_SALT = rng.derive_salt("serve/sampler")


def _filter_logits(logits, top_k, top_p):
    """Mask logits outside the per-row top-k / nucleus sets to -inf.  One
    descending sort serves both cuts; the best token is always kept.  The
    sort is stable so ties keep vocabulary order, as ``jnp.argsort`` does."""
    v = logits.shape[-1]
    order = torch.argsort(-logits, dim=-1, stable=True)          # (B, V) desc
    sorted_logits = torch.gather(logits, -1, order)
    ranks = torch.arange(v, device=logits.device)[None, :]

    k = torch.where(top_k <= 0, v, top_k)[:, None]              # 0 → off
    keep_k = ranks < k

    probs = torch.softmax(sorted_logits, dim=-1)
    # exclusive cumsum: keep tokens until the mass before them reaches p
    cum = torch.cumsum(probs, dim=-1) - probs
    keep_p = cum < torch.clamp(top_p, 0.0, 1.0)[:, None]

    keep_sorted = (keep_k & keep_p) | (ranks == 0)
    keep = torch.zeros_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return torch.where(keep, logits, float("-inf"))


def _gumbel(bits):
    """Gumbel noise from uint32 words: the top 24 bits as a uniform in
    (0, 1), +0.5 keeping it off 0, then ``-log(-log(u))``, in fp32."""
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample_tokens(logits, *, uids, positions, seed, temperature, top_k, top_p):
    """→ (B,) int64 next tokens.

    logits (B, V); uids (B,) request ids; positions (B,) sequence index of
    the token being drawn; seed an int or 0-d tensor; temperature/top_p (B,)
    fp32, top_k (B,) integer.  All on the logits' device.  Rows with
    ``temperature <= 0`` take the argmax."""
    logits = logits.float()
    v = logits.shape[-1]
    greedy_tok = torch.argmax(logits, dim=-1)

    # per-(request, position) key, then a per-vocab-element counter draw
    k0, k1 = rng.threefry2x32(seed, SAMPLER_SALT, uids, positions)
    cols = torch.arange(v, dtype=torch.int64, device=logits.device)[None, :]
    bits, _ = rng.threefry2x32(k0[:, None], k1[:, None], cols, 0)
    gumbel = _gumbel(bits)

    filtered = _filter_logits(logits, top_k, top_p)
    temp = torch.clamp_min(temperature.float(), 1e-6)[:, None]
    sampled_tok = torch.argmax(filtered / temp + gumbel, dim=-1)
    return torch.where(temperature <= 0, greedy_tok, sampled_tok)
