"""K2 (prefill flash attention), K6 (its backward), K3 (dense-cache flash
decode) and K4 (paged decode).

K2 replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``
(spec: ``_legacy_flash_attention_pallas``), K3 replaces
``flash_decode_pallas``, and K4 replaces the Pallas path of
``repro/kernels/ops.py::paged_decode_attention`` (a gather of the pages,
then ``flash_decode_pallas``).  K6 replaces the attention backward that
``repro/fusion/autodiff.py::ChainedBackwardPlan`` derives (run by
``_run_backward_chained``, attached by ``compile_with_vjp``).  The CUDA
sources are ``csrc/flash_attention.cu`` (K2 on the forward mainloop of
``csrc/attention_fwd.cuh``), ``csrc/flash_decode.cu`` (K3, split over the
key axis in fixed chunks of :data:`DECODE_CHUNK` keys and combined in chunk
order by the last block of each (batch, kv head): :func:`decode_plan`),
``csrc/flash_attention_bwd.cu`` (K6, on the backward mainloop of
``csrc/attention_bwd.cuh``) and ``csrc/paged_decode.cu`` (K4, K3's split
stream of ``csrc/decode_split.cuh`` over the page table:
:func:`paged_decode_plan`), whose headers say what bounds each kernel on an
H100 and what its design does about it.
K2 and K6 each have two routes, chosen by dtype in :func:`forward_plan` and
:func:`backward_plan`: bf16 on the tensor cores (wgmma, TMA-fed rings;
``ATTENTION_WGMMA_LAUNCHES`` and ``ATTENTION_BWD_WGMMA_LAUNCHES`` count
those launches) and fp32 on the SIMT cores; :func:`key_tile_range` is the
spec of the key tiles K2 visits, :func:`query_tile_range` of the query
tiles K6's dk/dv kernel visits.  :func:`attention_backward` launches the
backward mainloop of any source built on it, K6's or a K5 chained graph's
(``kernels/fused_gemm.py``).
The plain versions are ``kernels.ref.attention_ref``,
``attention_bwd_ref``, ``decode_attention_ref`` and
``paged_decode_attention_ref``;
``kernels.ops`` picks between kernel and plain version by the device of the
tensors.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.brgemm import _decode_counters

__all__ = ["flash_attention", "flash_attention_bwd", "attention_backward", "flash_decode",
           "paged_decode", "forward_plan", "backward_plan", "decode_plan", "key_tile_range",
           "query_tile_range", "tma_readable", "wgmma_smem", "paged_decode_plan", "ForwardPlan",
           "BackwardPlan", "DecodePlan", "PagedDecodePlan", "DECODE_CHUNK",
           "ATTENTION_LAUNCHES", "ATTENTION_WGMMA_LAUNCHES", "BACKWARD_LAUNCHES",
           "ATTENTION_BWD_WGMMA_LAUNCHES", "DECODE_LAUNCHES", "PAGED_DECODE_LAUNCHES",
           "HEAD_DIMS", "PAGED_HEAD_DIMS", "WGMMA_TILES", "BWD_TILES", "SMEM_LIMIT"]

# Launches of each CUDA kernel since import (or since a caller reset them);
# ATTENTION_LAUNCHES counts both K2 kernels, ATTENTION_WGMMA_LAUNCHES the
# bf16 one of them; BACKWARD_LAUNCHES counts K6's calls,
# ATTENTION_BWD_WGMMA_LAUNCHES those on the tensor cores.
ATTENTION_LAUNCHES = 0
ATTENTION_WGMMA_LAUNCHES = 0
BACKWARD_LAUNCHES = 0
ATTENTION_BWD_WGMMA_LAUNCHES = 0
DECODE_LAUNCHES = 0
PAGED_DECODE_LAUNCHES = 0

HEAD_DIMS = (16, 32, 64, 128, 256)
PAGED_HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
_DECODE_MAX_GROUP = 16      # query heads per kv head in one decode block
_DECODE_MAX_PAIRS = 2048    # group size x head dim one decode block holds
# K3's keys and K4's key positions a block (kChunk of csrc/flash_decode.cu
# and csrc/paged_decode.cu, which flash_decode and paged_decode check
# against each library once): a constant, never a function of B, of the
# page size, of the SM count or of the lengths, so a decoded row has the
# same bits in any batch
DECODE_CHUNK = 64

# K2's bf16 kernel (and K5's chained forward on the same mainloop) by head
# dim: (consumer warpgroups of 64 query rows, keys a K/V tile, stages of the
# K/V ring), csrc/attention_fwd.cuh's FwdConfig.
WGMMA_TILES = {16: (2, 128, 2), 32: (2, 128, 2), 64: (2, 64, 4), 128: (1, 64, 2),
               256: (1, 64, 2)}
_SIMT_ROWS = _SIMT_KEYS = 32    # the fp32 kernels' query and key tiles
SMEM_LIMIT = 232448             # dynamic shared memory one H100 block may use
# The bf16 backward by head dim: the dk/dv kernel's warpgroups, warpgroups
# sharing one 64-key block (each holding D / dsplit of dK's and dV's
# columns) and ring stages of 64 queries; the dq kernel's warpgroups of 64
# query rows, keys a K/V tile and ring stages (csrc/attention_bwd.cuh's
# BwdConfig: the C entry refuses a plan that differs).
BWD_TILES = {16: (2, 1, 4, 2, 64, 4), 32: (2, 1, 4, 2, 64, 4), 64: (2, 1, 4, 2, 64, 4),
             128: (2, 1, 3, 2, 64, 2), 256: (2, 2, 2, 1, 64, 2)}
_BWD_QUERIES = 64               # queries a ring tile of the bf16 dk/dv kernel
_SQ_ALIGN = 128                 # Sq padded to whole query tiles of every kernel


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


def wgmma_smem(d, rows, bn, stages):
    """Dynamic shared memory of the forward mainloop (csrc/attention_fwd.cuh,
    K2's and K5's chained forward): 1024 bytes to align the swizzled panels,
    the bf16 Q tile, the K and V tiles of each stage, one 8-byte mbarrier
    for Q and each stage, and a 4-byte count a stage of the warpgroups done
    with it."""
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


def tma_readable(name, t):
    """Raise ``ValueError`` unless TMA can read the bf16 operand ``t``: a
    unit last stride, and the base pointer and every other stride of a
    dimension longer than 1 multiples of 16 bytes.  No silent copy."""
    if t.stride(-1) != 1 or not _aligned(t):
        raise ValueError(
            f"bf16 flash attention reads {name} by TMA: its base pointer and every"
            f" stride but the unit last one must be multiples of 16 bytes (pointer"
            f" {t.data_ptr()} % 16 = {t.data_ptr() % 16}, strides {tuple(t.stride())})")


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
            tma_readable(name, t)
        wg, bn, stages = WGMMA_TILES[d]
        rows = 64 * wg
        return ForwardPlan("wgmma", rows, bn, stages, wgmma_smem(d, rows, bn, stages),
                           (-(-sq // rows), h, b))
    smem = 4 * (_SIMT_ROWS * (d + 1) + _SIMT_KEYS * (d + 1) + _SIMT_KEYS * d
                + _SIMT_ROWS * (_SIMT_KEYS + 1))
    return ForwardPlan("simt", _SIMT_ROWS, _SIMT_KEYS, 1, smem, (-(-sq // _SIMT_ROWS), h, b))


class BackwardPlan(NamedTuple):
    """How K6 (or a chained graph's backward) runs one call: ``variant``
    "wgmma" (bf16) or "simt" (fp32); the dk/dv kernel's ``kv_rows`` keys a
    CTA, ``kv_stages`` ring stages and ``kv_smem`` bytes of dynamic shared
    memory; the dq kernel's ``q_rows`` query rows a CTA, ``q_bn`` keys a
    tile, ``q_stages`` and ``q_smem``; ``sq_pad``, Sq padded to whole
    tiles (the rows of the stats scratch); and both grids."""
    variant: str
    kv_rows: int
    kv_stages: int
    kv_smem: int
    q_rows: int
    q_bn: int
    q_stages: int
    q_smem: int
    sq_pad: int
    kv_grid: tuple
    q_grid: tuple

    def ints(self):
        """The 8 ints the C entry point reads (attn_bwd::Plan)."""
        return (self.kv_rows, self.kv_stages, self.kv_smem, self.q_rows, self.q_bn,
                self.q_stages, self.q_smem, self.sq_pad)


def _bwd_smem(d, wg, dsplit, stages, qwg, qbn, qstages):
    """(dk/dv, dq) dynamic shared memory: 1024 bytes to align the panels;
    K and V of the key block, a ring of (Q, dO, lse and D rows) tiles, one
    mbarrier for K/V and each stage and a count a stage; Q and dO of the
    query rows, a ring of (K, V) tiles, the same mbarriers and counts."""
    bn, bm = 64 * wg // dsplit, _BWD_QUERIES
    kv = 1024 + 2 * bn * d * 2 + stages * (2 * bm * d * 2 + 2 * bm * 4) + 8 * (stages + 1) \
        + 4 * stages
    q = 1024 + 2 * 64 * qwg * d * 2 + qstages * 2 * qbn * d * 2 + 8 * (qstages + 1) + 4 * qstages
    return kv, q


def backward_plan(q, k, v):
    """The attention backward's plan for q (B, H, Sq, D) and k/v (B, Hk,
    Skv, D), from their dtype, shapes, strides and base pointers alone
    (nothing is launched): bf16 runs the tensor-core kernels, fp32 the SIMT
    kernels.  Raises ``ValueError`` for a head dim the kernels do not
    build and for a bf16 operand whose base pointer or strides (but the
    unit last one) are not multiples of 16 bytes: q, k, v and dO are read
    by TMA (the caller checks dO with :func:`tma_readable`)."""
    b, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: need one of {HEAD_DIMS}")
    sq_pad = -(-max(sq, 1) // _SQ_ALIGN) * _SQ_ALIGN
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            tma_readable(name, t)
        wg, dsplit, stages, qwg, qbn, qstages = BWD_TILES[d]
        kv_smem, q_smem = _bwd_smem(d, wg, dsplit, stages, qwg, qbn, qstages)
        kv_rows, q_rows = 64 * wg // dsplit, 64 * qwg
        return BackwardPlan("wgmma", kv_rows, stages, kv_smem, q_rows, qbn, qstages, q_smem,
                            sq_pad, (-(-skv // kv_rows), hk, b), (-(-sq // q_rows), h, b))
    kv_smem = 4 * (4 * 32 * (d + 1) + 2 * _SIMT_ROWS * (_SIMT_KEYS + 1) + 2 * _SIMT_ROWS)
    q_smem = 4 * (4 * 32 * (d + 1) + _SIMT_ROWS * (_SIMT_KEYS + 1) + 2 * _SIMT_ROWS)
    return BackwardPlan("simt", _SIMT_KEYS, 1, kv_smem, _SIMT_ROWS, _SIMT_KEYS, 1, q_smem,
                        sq_pad, (-(-skv // _SIMT_KEYS), hk, b), (-(-sq // _SIMT_ROWS), h, b))


def _tile_dead(m0, bm, n0, bn, sq, skv, causal, window):
    """K6's ``tile_dead`` (csrc/flash_attention_bwd.cu): queries [m0, m0 +
    bm) and keys [n0, n0 + bn) hold no live pair under the masks."""
    off = skv - sq
    return bool((causal and n0 > m0 + bm - 1 + off)
                or (window and n0 + bn - 1 <= m0 + off - window))


def query_tile_range(n0, keys, sq, skv, causal, window, bm):
    """The query tiles of ``bm`` rows that K6's dk/dv kernel visits for the
    keys [n0, n0 + keys) (row i at key position i + skv - sq; ``window``
    None or >= 1): from the first tile ``tile_dead`` leaves live to the
    last, as ``query_range`` in csrc/attention_bwd.cuh scans them; every
    tile outside the range holds only masked (row, key) pairs."""
    live = [t for t in range(-(-sq // bm))
            if not _tile_dead(t * bm, bm, n0, keys, sq, skv, causal, window)]
    return range(live[0], live[-1] + 1) if live else range(0)


def key_tile_range(q0, rows, sq, skv, causal, window, bn):
    """The key tiles of ``bn`` keys that query rows [q0, q0 + rows) below
    ``sq`` can see under the masks (row i at key position i + skv - sq;
    ``window`` None or >= 1): every tile outside the range holds only
    masked (row, key) pairs.  Both K2 kernels visit exactly these tiles
    (``key_tiles`` in csrc/attention_fwd.cuh)."""
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
    strides with a unit-stride last dim (bf16: 16-byte aligned, as
    :func:`backward_plan` checks); ``lse`` the forward's (B, H, Sq) fp32
    row log-sum-exp.  → (dq, dk, dv) in q's dtype, each a view of a (B, S,
    heads, D) buffer, so the gradient of the caller's token-to-head
    transpose is free."""
    global BACKWARD_LAUNCHES, ATTENTION_BWD_WGMMA_LAUNCHES
    grads, variant = attention_backward(lambda: _build.load("flash_attention_bwd"),
                                        "flash_attention_bwd", q, k, v, o, lse, do,
                                        causal=causal, window=window, scale=scale)
    BACKWARD_LAUNCHES += 1
    if variant == "wgmma":
        ATTENTION_BWD_WGMMA_LAUNCHES += 1
    return grads


def attention_backward(load, what, q, k, v, o, lse, do, *, causal=True, window=None,
                       scale=None):
    """Launch the backward mainloop (csrc/attention_bwd.cuh) of the library
    ``load()`` returns, K6's or a chained graph's generated source (whose
    ``Epi`` has its own scale and masks baked in and ignores ``causal``,
    ``window`` and ``scale``), with the shapes and layouts of
    :func:`flash_attention_bwd`; → ((dq, dk, dv), the plan's variant).
    Raises before launching on what the kernels do not take."""
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
    plan = backward_plan(q, k, v)
    if plan.variant == "wgmma":
        tma_readable("do", do)
    lse = lse.contiguous()
    dq = torch.empty(b, sq, h, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty(b, skv, hk, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty(b, skv, hk, d, dtype=q.dtype, device=q.device).transpose(1, 2)
    if dq.numel() == 0 or dk.numel() == 0:
        return (dq.zero_(), dk.zero_(), dv.zero_()), plan.variant
    stats = torch.empty(2, b * h * plan.sq_pad, dtype=torch.float32, device=q.device)
    strides = torch.tensor([s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]],
                           dtype=torch.int64)
    ints = torch.tensor(plan.ints(), dtype=torch.int32)
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    err = load().attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        do.data_ptr(), stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        int(q.dtype == torch.bfloat16), b, h, hk, sq, skv, d, ints.data_ptr(),
        strides.data_ptr(), int(bool(causal)), _window(window), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, what)
    return (dq, dk, dv), plan.variant


class DecodePlan(NamedTuple):
    """How K3 runs one call: ``kernel`` (its device name), ``chunk`` keys a
    block, ``chunks`` blocks a (batch, kv head) over the cache's S keys,
    ``workspace_bytes`` of fp32 partials (m, l, acc) the last block of a
    (batch, kv head) combines (0 for one chunk, written directly),
    ``smem_bytes`` of dynamic shared memory and ``grid`` (chunks, Hk, B)."""
    kernel: str
    chunk: int
    chunks: int
    workspace_bytes: int
    smem_bytes: int
    grid: tuple


def decode_plan(q, k_cache, v_cache):
    """K3's plan for q (B, H, D) and caches (B, Hk, S, D), from their dtype,
    shapes, strides and base pointers alone (nothing is launched).  The
    chunk is :data:`DECODE_CHUNK` whatever B, the card or the lengths.
    Raises ``ValueError`` for a head dim or GQA group one block does not
    take, and for a cache the 16-byte loads cannot read: a last stride other
    than 1, or a base pointer or batch, head or seq stride (of an axis
    longer than 1) that is not a multiple of 16 bytes.  No silent copy."""
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash decode reads {name} in 16-byte loads: its base pointer"
                             f" {t.data_ptr()} is not a multiple of 16 bytes")
    return _decode_plan(tuple(q.shape), tuple(k_cache.shape), k_cache.stride(), v_cache.stride(),
                        k_cache.element_size(), DECODE_CHUNK)


@functools.lru_cache(maxsize=256)
def _decode_plan(q_shape, k_shape, k_stride, v_stride, size, chunk):
    """The part of :func:`decode_plan` that shapes and strides fix (a
    decode step asks for the same 40 times)."""
    b, h, d = q_shape
    hk, s = k_shape[1], k_shape[2]
    g = h // hk
    if d not in HEAD_DIMS:
        raise ValueError(f"decode head dim {d}: need one of {HEAD_DIMS}")
    if g > _DECODE_MAX_GROUP or g * d > _DECODE_MAX_PAIRS:
        raise ValueError(f"decode group of {g} heads x {d} dims exceeds one block")
    for name, st in (("k_cache", k_stride), ("v_cache", v_stride)):
        if st[-1] != 1 or any(n > 1 and (x <= 0 or x * size % 16)
                              for n, x in zip(k_shape[:3], st[:3])):
            raise ValueError(f"flash decode reads {name} in 16-byte loads: its last stride must"
                             f" be 1 and its batch, head and seq strides multiples of 16 bytes"
                             f" (strides {st}, {size}-byte elements)")
    chunks = max(1, -(-s // chunk))
    smem = size * (g * d + 2 * chunk * d) + 4 * (2 * g * chunk + 2 * g)
    workspace = 4 * b * h * chunks * (d + 2) if chunks > 1 else 0
    return DecodePlan("flash_decode_split_kernel", chunk, chunks, workspace, smem,
                      (chunks, hk, b))


def flash_decode(q, k_cache, v_cache, *, length, window=None):
    """q (B, H, D); caches (B, Hk, S, D), 16-byte aligned as
    :func:`decode_plan` checks; ``length`` (B,) valid prefix lengths, read
    on the device (clamped to S); → (B, H, D) in q's dtype.  One launch."""
    global DECODE_LAUNCHES
    _check(q[:, :, None], k_cache, v_cache)
    q = _rows(q)
    b, h, d = q.shape
    hk, s = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode shapes q {tuple(q.shape)}, caches {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    if length.shape != (b,) or length.device != q.device:
        raise ValueError(f"length must be ({b},) on {q.device}")
    plan = decode_plan(q, k_cache, v_cache)
    length = length.to(torch.int32).contiguous()
    o = torch.empty(b, h, d, dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)  # current_stream's, cheaper
    ws = counters = None
    if plan.chunks > 1:
        ws = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32, device=q.device)
        counters = _decode_counters(q.device, stream, b * hk)
    err = _split_library("flash_decode").flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), length.data_ptr(), o.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        counters.data_ptr() if counters is not None else None,
        int(q.dtype == torch.bfloat16), b, h, hk, s, d,
        *q.stride()[:2], *k_cache.stride()[:3], *v_cache.stride()[:3],
        *o.stride()[:2], _window(window), 1.0 / math.sqrt(d), stream)
    _build.check(err, "flash_decode")
    DECODE_LAUNCHES += 1
    return o


@functools.lru_cache(maxsize=2)
def _split_library(name):
    """K3's (``flash_decode``) or K4's (``paged_decode``) library, once the
    chunk its source cuts the keys in is checked to be :data:`DECODE_CHUNK`
    (the plans size the workspace by it)."""
    lib = _build.load(name)
    chunk = getattr(lib, f"{name}_chunk")()
    if chunk != DECODE_CHUNK:
        raise RuntimeError(f"csrc/{name}.cu cuts the keys in chunks of {chunk}, its plan in"
                           f" {DECODE_CHUNK}")
    return lib


class PagedDecodePlan(NamedTuple):
    """How K4 runs one call: ``kernel`` (its device name), ``chunk`` key
    positions a block, ``chunks`` blocks a (slot, kv head) over the table's
    maxp * page_size positions, ``workspace_bytes`` of fp32 partials (m, l,
    acc) the last block of a (slot, kv head) combines (0 for one chunk,
    written directly), ``smem_bytes`` of dynamic shared memory and ``grid``
    (chunks, Hk, B)."""
    kernel: str
    chunk: int
    chunks: int
    workspace_bytes: int
    smem_bytes: int
    grid: tuple


def paged_decode_plan(q, k_pool, v_pool, page_table, *, page_size):
    """K4's plan for q (B, H, D), pools (P + 1, page_size, Hk, D) and
    ``page_table`` (B, maxp), from their dtype, shapes and the pools' layout
    alone (nothing is launched).  The chunk is :data:`DECODE_CHUNK`
    whatever B, the page size, the card or the lengths.  Raises
    ``ValueError`` for a head dim or GQA group one block does not take, and
    for pools the 16-byte loads cannot read in place: not contiguous, or a
    base pointer that is not a multiple of 16 bytes.  No silent copy."""
    for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
        if not pool.is_contiguous() or pool.data_ptr() % 16:
            raise ValueError(f"paged decode reads {name} in 16-byte loads: it must be contiguous"
                             f" with a 16-byte aligned base (strides {pool.stride()}, base"
                             f" {pool.data_ptr()})")
    if v_pool.shape != k_pool.shape or k_pool.dim() != 4 or k_pool.shape[1] != page_size:
        raise ValueError(f"pools {tuple(k_pool.shape)}, {tuple(v_pool.shape)} with page_size"
                         f" {page_size}")
    return _paged_plan(tuple(q.shape), tuple(k_pool.shape), page_table.shape[-1],
                       k_pool.element_size(), DECODE_CHUNK)


@functools.lru_cache(maxsize=256)
def _paged_plan(q_shape, pool_shape, maxp, size, chunk):
    """The part of :func:`paged_decode_plan` that shapes fix (a decode step
    asks for the same once a layer)."""
    b, h, d = q_shape
    ps, hk = pool_shape[1], pool_shape[2]
    g = h // hk
    if d not in PAGED_HEAD_DIMS:
        raise ValueError(f"paged decode head dim {d}: need one of {PAGED_HEAD_DIMS}")
    if g > _DECODE_MAX_GROUP or g * d > _DECODE_MAX_PAIRS:
        raise ValueError(f"decode group of {g} heads x {d} dims exceeds one block")
    chunks = max(1, -(-(maxp * ps) // chunk))
    smem = size * (g * d + 2 * chunk * d) + 4 * (2 * g * chunk + 2 * g)
    workspace = 4 * b * h * chunks * (d + 2) if chunks > 1 else 0
    return PagedDecodePlan("paged_decode_split_kernel", chunk, chunks, workspace, smem,
                           (chunks, hk, b))


def paged_decode(q, k_pool, v_pool, page_table, *, page_size, length,
                 window=None):
    """q (B, H, D); contiguous token-major pools (P + 1, page_size, Hk, D),
    16-byte aligned as :func:`paged_decode_plan` checks; ``page_table``
    (B, maxp) and ``length`` (B,) int32 or int64 tensors on the device, read
    there as they lie; → (B, H, D) in q's dtype.  Page ids outside [0, P]
    are clamped, as the reference's gather clamps them.  One launch."""
    global PAGED_DECODE_LAUNCHES
    _check(q[:, :, None], k_pool.transpose(1, 2), v_pool.transpose(1, 2))
    b, h, d = q.shape
    rows, ps, hk = k_pool.shape[:3]
    if page_table.dim() != 2 or page_table.shape[0] != b or length.shape != (b,):
        raise ValueError(f"page_table {tuple(page_table.shape)} and length "
                         f"{tuple(length.shape)} for batch {b}")
    for t in (page_table, length):
        if t.device != q.device or t.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"page_table and length must be int32 or int64 tensors on {q.device}")
    if page_table.stride(1) != 1 and page_table.shape[1] > 1:
        raise ValueError(f"page_table must have a unit column stride, not {page_table.stride()}")
    plan = paged_decode_plan(q, k_pool, v_pool, page_table, page_size=page_size)
    q = _rows(q)
    o = torch.empty(b, h, d, dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)  # current_stream's, cheaper
    ws = counters = None
    if plan.chunks > 1:
        ws = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32, device=q.device)
        counters = _decode_counters(q.device, stream, b * hk)
    err = _split_library("paged_decode").paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
        length.data_ptr(), o.data_ptr(), ws.data_ptr() if ws is not None else None,
        counters.data_ptr() if counters is not None else None,
        int(q.dtype == torch.bfloat16), int(page_table.dtype == torch.int64),
        int(length.dtype == torch.int64), b, h, hk, d, ps, page_table.shape[1], rows,
        page_table.stride(0), *q.stride()[:2], *o.stride()[:2], _window(window),
        1.0 / math.sqrt(d), stream)
    _build.check(err, "paged_decode")
    PAGED_DECODE_LAUNCHES += 1
    return o
