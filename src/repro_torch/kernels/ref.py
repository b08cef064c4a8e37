"""Plain PyTorch versions of the kernels, forward and backward.

Each forward mirrors its oracle in ``repro/kernels/ref.py``; each backward
is what XLA's autodiff of that oracle computes (``matmul_bwd_ref``) or what
``repro/fusion/autodiff.py``'s recompute backward derives
(``attention_bwd_ref``).  On the CPU they are what ``kernels.ops`` runs
(``matmul``'s backward there runs ``matmul_ref`` on transposed views, as
K1 reads them on the card, and the tests hold it against
``matmul_bwd_ref``); on the GPU they are what ``chip_smoke.py`` holds each
CUDA kernel against.  They compute in fp32 from the stored inputs.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import tpp

__all__ = ["matmul_ref", "matmul_bwd_ref", "attention_ref", "attention_fwd_ref",
           "attention_bwd_ref", "decode_attention_ref", "paged_decode_attention_ref"]


def matmul_ref(a, b, *, bias=None, activation=None, out_dtype=None):
    """act(a @ b + bias) with an fp32 accumulator, cast to ``out_dtype``."""
    out_dtype = out_dtype or a.dtype
    acc = torch.matmul(a.float(), b.float())
    if bias is not None:
        acc = acc + bias.float()
    if activation is not None:
        acc = tpp.ACTIVATIONS[activation](acc)
    return acc.to(out_dtype)


def matmul_bwd_ref(a, b, dy, *, bias=None, activation=None):
    """Gradients of :func:`matmul_ref` for the output cotangent ``dy``:
    dZ = dy * act'(Z) at the fp32 pre-activation Z = a @ b + bias, then
    dA = dZ @ b^T, dB = a^T @ dZ and dbias = the sum of dZ's rows (None
    without a bias); all fp32."""
    z = None
    if activation is not None:
        z = torch.matmul(a.float(), b.float())
        if bias is not None:
            z = z + bias.float()
    dz = tpp.activation_grad(activation, dy, z if z is not None else dy)
    da = torch.matmul(dz, b.float().T)
    db = torch.matmul(a.float().T, dz)
    return da, db, dz.sum(0) if bias is not None else None


def _masked_scores(q, k, *, causal, window, scale):
    """Scaled fp32 scores (B, H, Sq, Skv) of q against the group-broadcast k,
    and the (Sq, Skv) keep mask; masked scores are -inf.  Masks align the
    ends of the query and key ranges (row i sits at key position
    i + Skv - Sq); ``window`` keeps keys within [i-window+1, i]."""
    sq, d = q.shape[2], q.shape[3]
    skv = k.shape[2]
    g = q.shape[1] // k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kq = k.repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) * scale
    rows = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    return s.masked_fill(~mask, float("-inf")), mask


def attention_ref(q, k, v, *, causal=True, window=None, scale=None,
                  out_dtype=None):
    """q (B, H, Sq, D); k/v (B, Hk, Skv, D) with H % Hk == 0.  A row with
    every key masked gives NaN here (softmax over -inf), 0 in the kernel."""
    s, _ = _masked_scores(q, k, causal=causal, window=window, scale=scale)
    p = torch.softmax(s, dim=-1)
    vq = v.repeat_interleave(q.shape[1] // k.shape[1], dim=1).float()
    o = torch.einsum("bhqk,bhkd->bhqd", p, vq)
    return o.to(out_dtype or q.dtype)


def attention_fwd_ref(q, k, v, *, causal=True, window=None, scale=None):
    """:func:`attention_ref` and each row's log-sum-exp of its scaled, masked
    scores, lse (B, H, Sq) fp32 (-inf for a row with every key masked): the
    training forward, whose lse the backward recomputes P from."""
    s, _ = _masked_scores(q, k, causal=causal, window=window, scale=scale)
    o = attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    return o, torch.logsumexp(s, dim=-1)


def attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=None,
                      scale=None):
    """Gradients of the attention for the output cotangent ``do``, from the
    forward's output ``o`` and row log-sum-exp ``lse``: P = exp(S - lse) on
    the kept keys, dP = dO V^T, dS = P * (dP - D) with D = rowsum(dO * O)
    (the softmax gradient of ``repro/fusion/autodiff.py``'s dz graph),
    dQ = scale dS K, dK = scale dS^T Q and dV = P^T dO, the last two summed
    over each kv head's group of query heads.  → (dq, dk, dv) fp32.  A row
    with every key masked gets zero gradients."""
    b, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    g = h // hk
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s, mask = _masked_scores(q, k, causal=causal, window=window, scale=scale)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), torch.zeros((), device=q.device))
    dof, qf = do.float(), q.float()
    kq = k.repeat_interleave(g, dim=1).float()
    vq = v.repeat_interleave(g, dim=1).float()
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vq)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kq) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return (dq, dk.view(b, hk, g, skv, d).sum(2), dv.view(b, hk, g, skv, d).sum(2))


def decode_attention_ref(q, k_cache, v_cache, *, length=None, window=None,
                         out_dtype=None):
    """One query token: q (B, H, D); caches (B, Hk, S, D); ``length`` (B,)
    valid prefix lengths (None = the whole cache); ``window`` keeps keys in
    [length-window, length).  Like the reference, p is cast to the cache
    dtype before p @ V."""
    b, h, d = q.shape
    hk = k_cache.shape[1]
    g = h // hk
    qg = q.reshape(b, hk, g, d).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.float()) / math.sqrt(d)
    if length is not None:
        cols = torch.arange(k_cache.shape[2], device=q.device)[None, None, None, :]
        lens = length.to(q.device)[:, None, None, None]
        mask = cols < lens
        if window is not None:
            mask = mask & (cols >= lens - window)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(b, h, d).to(out_dtype or q.dtype)


def paged_decode_attention_ref(q, k_pool, v_pool, page_table, *, page_size,
                               length, window=None, out_dtype=None):
    """One query token over token-major page pools: q (B, H, D); pools
    (P, page_size, Hk, D) shared by every slot; ``page_table`` (B, maxp)
    names each slot's pages (the trash page in unused entries); ``length``
    (B,) valid prefix lengths.  Gathers each slot's pages, swaps them to the
    head-major cache layout and calls :func:`decode_attention_ref`, which
    masks the positions past ``length``."""
    b, maxp = page_table.shape
    s = maxp * page_size
    idx = page_table.long()
    k = k_pool[idx].reshape(b, s, k_pool.shape[2], -1).transpose(1, 2)
    v = v_pool[idx].reshape(b, s, v_pool.shape[2], -1).transpose(1, 2)
    return decode_attention_ref(q, k, v, length=length, window=window,
                                out_dtype=out_dtype)
