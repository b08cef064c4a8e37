"""K2 (prefill flash attention), K3 (dense-cache flash decode) and K4
(paged decode).

K2 replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``
(spec: ``_legacy_flash_attention_pallas``), K3 replaces
``flash_decode_pallas``, and K4 replaces the Pallas path of
``repro/kernels/ops.py::paged_decode_attention`` (a gather of the pages,
then ``flash_decode_pallas``).  The CUDA sources are
``csrc/flash_attention.cu`` (K2, K3) and ``csrc/paged_decode.cu`` (K4),
whose headers say what bounds each kernel on an H100 and what its design
does about it.  The plain versions are ``kernels.ref.attention_ref``,
``decode_attention_ref`` and ``paged_decode_attention_ref``;
``kernels.ops`` picks between kernel and plain version by the device of the
tensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention", "flash_decode", "paged_decode",
           "ATTENTION_LAUNCHES", "DECODE_LAUNCHES", "PAGED_DECODE_LAUNCHES",
           "HEAD_DIMS", "PAGED_HEAD_DIMS"]

# Launches of each CUDA kernel since import (or since a caller reset them).
ATTENTION_LAUNCHES = 0
DECODE_LAUNCHES = 0
PAGED_DECODE_LAUNCHES = 0

HEAD_DIMS = (16, 32, 64, 128, 256)
PAGED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
_DECODE_MAX_GROUP = 16      # query heads per kv head in one decode block
_DECODE_MAX_PAIRS = 2048    # group size x head dim one decode block holds


def _check(q, k, v):
    for t in (q, k, v):
        if t.device.type != "cuda":
            raise ValueError(f"flash attention needs CUDA tensors, got {t.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"flash attention dtypes {q.dtype}/{t.dtype}: need one of {_DTYPES}")
    d = q.shape[-1]
    if d not in HEAD_DIMS or k.shape[-1] != d or v.shape[-1] != d:
        raise ValueError(f"head dims {q.shape[-1]}/{k.shape[-1]}/{v.shape[-1]}: need one of {HEAD_DIMS}")
    h, hk = q.shape[1], k.shape[1]
    if v.shape[1] != hk or h % hk:
        raise ValueError(f"query heads {h} must be a multiple of kv heads {hk}")


def _rows(t):
    return t if t.stride(-1) == 1 else t.contiguous()


def _window(window):
    if window is None:
        return -1
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return int(window)


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    """q (B, H, Sq, D); k/v (B, Hk, Skv, D), any strides with a unit-stride
    last dim; → (B, H, Sq, D) in q's dtype (a view of a (B, Sq, H, D)
    buffer, so the caller's transpose back to tokens is free)."""
    global ATTENTION_LAUNCHES
    _check(q, k, v)
    q, k, v = _rows(q), _rows(k), _rows(v)
    b, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"attention shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    o = torch.empty(b, sq, h, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    if o.numel() == 0:
        return o
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    lib = _build.load("flash_attention")
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        int(q.dtype == torch.bfloat16), b, h, hk, sq, skv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(bool(causal)), _window(window), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    ATTENTION_LAUNCHES += 1
    return o


def flash_decode(q, k_cache, v_cache, *, length, window=None):
    """q (B, H, D); caches (B, Hk, S, D); ``length`` (B,) valid prefix
    lengths, read on the device; → (B, H, D) in q's dtype."""
    global DECODE_LAUNCHES
    _check(q[:, :, None], k_cache, v_cache)
    q, k_cache, v_cache = _rows(q), _rows(k_cache), _rows(v_cache)
    b, h, d = q.shape
    hk, s = k_cache.shape[1], k_cache.shape[2]
    g = h // hk
    if g > _DECODE_MAX_GROUP or g * d > _DECODE_MAX_PAIRS:
        raise ValueError(f"decode group of {g} heads x {d} dims exceeds one block")
    if k_cache.shape[0] != b or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode shapes q {tuple(q.shape)}, caches {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    if length.shape != (b,) or length.device != q.device:
        raise ValueError(f"length must be ({b},) on {q.device}")
    length = length.to(torch.int32).contiguous()
    o = torch.empty(b, h, d, dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    lib = _build.load("flash_attention")
    err = lib.flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), length.data_ptr(),
        o.data_ptr(), int(q.dtype == torch.bfloat16), b, h, hk, s, d,
        *q.stride()[:2], *k_cache.stride()[:3], *v_cache.stride()[:3],
        *o.stride()[:2], _window(window), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_decode")
    DECODE_LAUNCHES += 1
    return o


def paged_decode(q, k_pool, v_pool, page_table, *, page_size, length,
                 window=None):
    """q (B, H, D); contiguous token-major pools (P + 1, page_size, Hk, D);
    ``page_table`` (B, maxp) and ``length`` (B,) integer tensors on the
    device, read there; → (B, H, D) in q's dtype.  Page ids outside
    [0, P] are clamped, as the reference's gather clamps them."""
    global PAGED_DECODE_LAUNCHES
    _check(q[:, :, None], k_pool.transpose(1, 2), v_pool.transpose(1, 2))
    b, h, d = q.shape
    rows, ps, hk = k_pool.shape[:3]
    g = h // hk
    if d not in PAGED_HEAD_DIMS:
        raise ValueError(f"paged decode head dim {d}: need one of {PAGED_HEAD_DIMS}")
    if g > _DECODE_MAX_GROUP or g * d > _DECODE_MAX_PAIRS:
        raise ValueError(f"decode group of {g} heads x {d} dims exceeds one block")
    if v_pool.shape != k_pool.shape or ps != page_size:
        raise ValueError(f"pools {tuple(k_pool.shape)}, {tuple(v_pool.shape)} with page_size {page_size}")
    # the kernel reads whole 16-byte vectors of each pool row
    for pool in (k_pool, v_pool):
        if not pool.is_contiguous() or pool.data_ptr() % 16:
            raise ValueError("paged decode needs contiguous, 16-byte aligned pools")
    if page_table.dim() != 2 or page_table.shape[0] != b or length.shape != (b,):
        raise ValueError(f"page_table {tuple(page_table.shape)} and length "
                         f"{tuple(length.shape)} for batch {b}")
    for t in (page_table, length):
        if t.device != q.device or t.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"page_table and length must be integer tensors on {q.device}")
    table = page_table.to(torch.int32).contiguous()
    length = length.to(torch.int32).contiguous()
    q = _rows(q)
    o = torch.empty(b, h, d, dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    lib = _build.load("paged_decode")
    err = lib.paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
        length.data_ptr(), o.data_ptr(), int(q.dtype == torch.bfloat16),
        b, h, hk, d, ps, table.shape[1], rows, *q.stride()[:2], *o.stride()[:2],
        _window(window), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode")
    PAGED_DECODE_LAUNCHES += 1
    return o
