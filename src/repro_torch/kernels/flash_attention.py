"""K2 (prefill flash attention), K6 (its backward), K3 (dense-cache flash
decode) and K4 (paged decode).

K2 replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``
(spec: ``_legacy_flash_attention_pallas``), K3 replaces
``flash_decode_pallas``, and K4 replaces the Pallas path of
``repro/kernels/ops.py::paged_decode_attention`` (a gather of the pages,
then ``flash_decode_pallas``).  K6 replaces the attention backward that
``repro/fusion/autodiff.py::ChainedBackwardPlan`` derives (run by
``_run_backward_chained``, attached by ``compile_with_vjp``).  The CUDA
sources are ``csrc/flash_attention.cu`` (K2, K3),
``csrc/flash_attention_bwd.cu`` (K6) and ``csrc/paged_decode.cu`` (K4),
whose headers say what bounds each kernel on an H100 and what its design
does about it.  K2 has two kernels, chosen by dtype in
:func:`forward_plan`: bf16 on the tensor cores (wgmma, a TMA-fed K/V ring;
``ATTENTION_WGMMA_LAUNCHES`` counts its launches) and fp32 on the SIMT
cores; :func:`key_tile_range` is the spec of the key tiles both visit.
The plain versions are ``kernels.ref.attention_ref``,
``attention_bwd_ref``, ``decode_attention_ref`` and
``paged_decode_attention_ref``;
``kernels.ops`` picks between kernel and plain version by the device of the
tensors.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention", "flash_attention_bwd", "flash_decode", "paged_decode",
           "forward_plan", "key_tile_range", "ForwardPlan",
           "ATTENTION_LAUNCHES", "ATTENTION_WGMMA_LAUNCHES", "BACKWARD_LAUNCHES",
           "DECODE_LAUNCHES", "PAGED_DECODE_LAUNCHES",
           "HEAD_DIMS", "PAGED_HEAD_DIMS", "WGMMA_TILES", "SMEM_LIMIT"]

# Launches of each CUDA kernel since import (or since a caller reset them);
# ATTENTION_LAUNCHES counts both K2 kernels, ATTENTION_WGMMA_LAUNCHES the
# bf16 one of them.
ATTENTION_LAUNCHES = 0
ATTENTION_WGMMA_LAUNCHES = 0
BACKWARD_LAUNCHES = 0
DECODE_LAUNCHES = 0
PAGED_DECODE_LAUNCHES = 0

HEAD_DIMS = (16, 32, 64, 128, 256)
PAGED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
_DECODE_MAX_GROUP = 16      # query heads per kv head in one decode block
_DECODE_MAX_PAIRS = 2048    # group size x head dim one decode block holds

# K2's bf16 kernel by head dim: (consumer warpgroups of 64 query rows, keys
# a K/V tile, stages of the K/V ring), csrc/flash_attention.cu's FwdConfig.
WGMMA_TILES = {16: (2, 128, 2), 32: (2, 128, 2), 64: (2, 64, 4), 128: (1, 64, 2),
               256: (1, 64, 2)}
_SIMT_ROWS = _SIMT_KEYS = 32    # the fp32 kernel's query and key tiles
SMEM_LIMIT = 232448             # dynamic shared memory one H100 block may use


class ForwardPlan(NamedTuple):
    """How K2 runs one call: ``variant`` "wgmma" (bf16) or "simt" (fp32),
    ``rows`` query rows a CTA (64 a warpgroup for "wgmma"), ``bn`` keys a
    K/V tile, ``stages`` tiles in the K/V ring, ``smem_bytes`` of dynamic
    shared memory and ``grid`` (query tiles, H, B)."""
    variant: str
    rows: int
    bn: int
    stages: int
    smem_bytes: int
    grid: tuple


def _wgmma_smem(d, rows, bn, stages):
    """1024 bytes to align the swizzled panels, the bf16 Q tile, the K and
    V tiles of each stage, one 8-byte mbarrier for Q and each stage, and a
    4-byte count a stage of the warpgroups done with it."""
    return 1024 + rows * d * 2 + stages * 2 * bn * d * 2 + 8 * (stages + 1) + 4 * stages


def _aligned(t):
    """Whether the TMA copies can read ``t``: its base and the stride of
    every dimension longer than 1 but the last are multiples of 16 bytes."""
    if t.data_ptr() % 16:
        return False
    size = t.element_size()
    for n, st in zip(t.shape[:-1], t.stride()[:-1]):
        if n > 1 and (st <= 0 or st * size % 16):
            return False
    return True


def forward_plan(q, k, v):
    """K2's plan for q (B, H, Sq, D) and k/v (B, Hk, Skv, D), from their
    dtype, shapes, strides and base pointers alone (nothing is launched):
    bf16 runs the tensor-core kernel, fp32 the SIMT kernel.  Raises
    ``ValueError`` for a bf16 operand whose base pointer or strides (but
    the unit last one) are not multiples of 16 bytes: the K/V ring is
    filled by TMA, which reads 16-byte aligned rows."""
    b, h, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: need one of {HEAD_DIMS}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.stride(-1) != 1 or not _aligned(t):
                raise ValueError(
                    f"bf16 flash attention reads {name} by TMA: its base pointer and every"
                    f" stride but the unit last one must be multiples of 16 bytes (pointer"
                    f" {t.data_ptr()} % 16 = {t.data_ptr() % 16}, strides {tuple(t.stride())})")
        wg, bn, stages = WGMMA_TILES[d]
        rows = 64 * wg
        return ForwardPlan("wgmma", rows, bn, stages, _wgmma_smem(d, rows, bn, stages),
                           (-(-sq // rows), h, b))
    smem = 4 * (_SIMT_ROWS * (d + 1) + _SIMT_KEYS * (d + 1) + _SIMT_KEYS * d
                + _SIMT_ROWS * (_SIMT_KEYS + 1))
    return ForwardPlan("simt", _SIMT_ROWS, _SIMT_KEYS, 1, smem, (-(-sq // _SIMT_ROWS), h, b))


def key_tile_range(q0, rows, sq, skv, causal, window, bn):
    """The key tiles of ``bn`` keys that query rows [q0, q0 + rows) below
    ``sq`` can see under the masks (row i at key position i + skv - sq;
    ``window`` None or >= 1): every tile outside the range holds only
    masked (row, key) pairs.  Both K2 kernels visit exactly these tiles
    (``key_tiles`` in csrc/flash_attention.cu)."""
    last = min(q0 + rows, sq) - 1
    off = skv - sq
    end = min(skv, last + off + 1) if causal else skv
    begin = max(0, q0 + off - window + 1) if window else 0
    if last < q0 or end <= begin:
        return range(0)
    return range(begin // bn, -(-end // bn))


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


def flash_attention(q, k, v, *, causal=True, window=None, scale=None,
                    with_lse=False):
    """q (B, H, Sq, D); k/v (B, Hk, Skv, D), any strides with a unit-stride
    last dim; → (B, H, Sq, D) in q's dtype (a view of a (B, Sq, H, D)
    buffer, so the caller's transpose back to tokens is free).  bf16 runs
    on the tensor cores and needs 16-byte aligned operands
    (:func:`forward_plan`); fp32 on the SIMT cores.  With
    ``with_lse`` → (o, lse): lse (B, H, Sq) fp32 holds each row's
    log-sum-exp of its scaled, masked scores (-inf for a row with every key
    masked), what K6 needs."""
    global ATTENTION_LAUNCHES, ATTENTION_WGMMA_LAUNCHES
    _check(q, k, v)
    q, k, v = _rows(q), _rows(k), _rows(v)
    b, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"attention shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    plan = forward_plan(q, k, v)
    o = torch.empty(b, sq, h, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device) if with_lse else None
    if o.numel() == 0:
        return (o, lse) if with_lse else o
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    lib = _build.load("flash_attention")
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if with_lse else None,
        int(plan.variant == "wgmma"), b, h, hk, sq, skv, d,
        plan.rows, plan.bn, plan.stages, plan.smem_bytes,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(bool(causal)), _window(window), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    ATTENTION_LAUNCHES += 1
    if plan.variant == "wgmma":
        ATTENTION_WGMMA_LAUNCHES += 1
    return (o, lse) if with_lse else o


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=None,
                        scale=None):
    """K6: the gradients of :func:`flash_attention` for the output cotangent
    ``do``.  q, o and do (B, H, Sq, D), k/v (B, Hk, Skv, D), one dtype, any
    strides with a unit-stride last dim; ``lse`` the forward's (B, H, Sq)
    fp32 row log-sum-exp.  → (dq, dk, dv) in q's dtype, each a view of a
    (B, S, heads, D) buffer, so the gradient of the caller's
    token-to-head transpose is free."""
    global BACKWARD_LAUNCHES
    _check(q, k, v)
    _check(o, do, do)
    if o.dtype != q.dtype:
        raise ValueError(f"attention backward dtypes q {q.dtype}, o and do {o.dtype}")
    q, k, v, o, do = (_rows(t) for t in (q, k, v, o, do))
    b, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    if (k.shape[0] != b or v.shape[:3] != k.shape[:3] or o.shape != q.shape
            or do.shape != q.shape):
        raise ValueError(f"attention backward shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, o {tuple(o.shape)}, do {tuple(do.shape)}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be fp32 ({b}, {h}, {sq}) on {q.device}")
    lse = lse.contiguous()
    dq = torch.empty(b, sq, h, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty(b, skv, hk, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty(b, skv, hk, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    strides = torch.tensor([s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]],
                           dtype=torch.int64)
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    lib = _build.load("flash_attention_bwd")
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        do.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        int(q.dtype == torch.bfloat16), b, h, hk, sq, skv, d, strides.data_ptr(),
        int(bool(causal)), _window(window), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd")
    BACKWARD_LAUNCHES += 1
    return dq, dk, dv


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
