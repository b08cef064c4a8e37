"""Plain PyTorch versions of the kernels on the serving path.

Each mirrors its oracle in ``repro/kernels/ref.py``.  On the CPU they are
what ``kernels.ops`` runs; on the GPU they are what ``chip_smoke.py`` holds
each CUDA kernel against.  They compute in fp32 from the stored inputs.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import tpp

__all__ = ["matmul_ref", "attention_ref", "decode_attention_ref",
           "paged_decode_attention_ref"]


def matmul_ref(a, b, *, bias=None, activation=None, out_dtype=None):
    """act(a @ b + bias) with an fp32 accumulator, cast to ``out_dtype``."""
    out_dtype = out_dtype or a.dtype
    acc = torch.matmul(a.float(), b.float())
    if bias is not None:
        acc = acc + bias.float()
    if activation is not None:
        acc = tpp.ACTIVATIONS[activation](acc)
    return acc.to(out_dtype)


def attention_ref(q, k, v, *, causal=True, window=None, scale=None,
                  out_dtype=None):
    """q (B, H, Sq, D); k/v (B, Hk, Skv, D) with H % Hk == 0.  Masks align
    the ends of the query and key ranges (row i sits at key position
    i + Skv - Sq); ``window`` keeps keys within [i-window+1, i].  A row with
    every key masked gives NaN here (softmax over -inf), 0 in the kernel."""
    b, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    g = h // hk
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kq = k.repeat_interleave(g, dim=1).float()
    vq = v.repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) * scale
    rows = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vq)
    return o.to(out_dtype or q.dtype)


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
