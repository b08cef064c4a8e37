"""Kernel API, dispatched by device, with the gradients training needs.

A CPU tensor runs the plain PyTorch version (``kernels/ref.py``); a CUDA
tensor runs the hand-written CUDA kernel, which launches or raises.  There is
no backend switch and no fallback: a kernel that fails to build or launch
fails the call.  Counterpart of ``repro/kernels/ops.py`` (``matmul``,
``attention``, ``decode_attention``, ``paged_decode_attention``,
``mamba_scan``, ``block_spmm``, ``grouped_matmul``, ``conv2d``), plus
``brgemm_blocked`` (paper Listing 1, K11).

``matmul``, ``attention``, ``mamba_scan`` and ``grouped_matmul`` are
``torch.autograd.Function``s when an input requires a gradient.  Their
forward and backward dispatch by device too, so the CPU tests run the same
Function, saved tensors and backward wiring as the card: ``matmul``'s
backward is K1 on transposed operands, ``attention``'s is K6 fed by K2's row
log-sum-exp, ``mamba_scan``'s is K8's backward kernel fed by the states K8's
forward writes at its chunk boundaries, and ``grouped_matmul``'s is K9's
backward (dX and dW kernels reading the same operands transposed, in
place).  When no input requires a gradient they call the forward alone and
save nothing.  ``block_spmm``, ``conv2d``, ``brgemm_blocked`` and a
``matmul`` scheduled by a spec string have no gradient in the reference:
each raises when an input requires a gradient.
"""
from __future__ import annotations

import torch

from repro_torch.core import tpp
from repro_torch.kernels import block_spmm as spmm
from repro_torch.kernels import brgemm, conv, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as scan

__all__ = ["matmul", "attention", "decode_attention", "paged_decode_attention",
           "mamba_scan", "block_spmm", "grouped_matmul", "conv2d", "brgemm_blocked"]


def _on_cpu(*tensors) -> bool:
    """True for CPU tensors, False for CUDA tensors; raises otherwise."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors on {sorted(kinds)}: need all on cpu or all on cuda")


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _matmul_fwd(a, b, bias, activation, out_dtype, spec_string=None, tiles=None,
                block_steps=None):
    if _on_cpu(a, b, bias):
        # the card's schedule, validated so that the CPU raises where it would
        brgemm.schedule(a.shape[0], a.shape[1], b.shape[1], a.dtype, spec_string, tiles,
                        block_steps)
        return ref.matmul_ref(a, b, bias=bias, activation=activation,
                              out_dtype=out_dtype)
    return brgemm.matmul(a, b, bias=bias, activation=activation, out_dtype=out_dtype,
                         spec_string=spec_string, tiles=tiles, block_steps=block_steps)


def _cast(t, dtype):
    return t if t is None or t.dtype == dtype else t.to(dtype)


class _Matmul(torch.autograd.Function):
    """act(a @ b + bias) with b and bias cast to a's dtype inside, so the
    gradients of fp32 master weights come back in fp32 (K1 writes dW in
    fp32) rather than rounded to the compute dtype first."""

    @staticmethod
    def forward(ctx, a, b, bias, activation, out_dtype):
        ctx.activation = activation
        ctx.save_for_backward(a, b, bias)
        return _matmul_fwd(a, _cast(b, a.dtype), _cast(bias, a.dtype), activation,
                           out_dtype)

    @staticmethod
    def backward(ctx, dy):
        # dZ at the fp32 pre-activation (recomputed), rounded to a's dtype;
        # then dA = dZ b^T and dB = a^T dZ (fp32) from transposed views,
        # which K1 reads in place.
        a, b, bias = ctx.saved_tensors
        act = ctx.activation
        bc, biasc = _cast(b, a.dtype), _cast(bias, a.dtype)
        z = _matmul_fwd(a, bc, biasc, None, torch.float32) if act else dy
        dz = tpp.activation_grad(act, dy, z)
        dzc = _cast(dz, a.dtype)
        da = _matmul_fwd(dzc, bc.T, None, None, None) if ctx.needs_input_grad[0] else None
        db = None
        if ctx.needs_input_grad[1]:
            if bc.stride(-1) != 1:      # b is a transposed view: write dB^T
                db = _matmul_fwd(dzc.T, a, None, None, torch.float32).T
            else:
                db = _matmul_fwd(a.T, dzc, None, None, torch.float32)
        dbias = dz.sum(0) if bias is not None else None
        return (_cast(da, a.dtype), _cast(db, b.dtype),
                _cast(dbias, bias.dtype) if bias is not None else None, None, None)


def matmul(a, b, *, bias=None, activation=None, out_dtype=None, spec_string=None,
           tiles=None, block_steps=None):
    """act(a @ b + bias) with an fp32 accumulator (K1).  ``b`` and ``bias``
    may be fp32 master weights: they are cast to ``a``'s dtype at use, as the
    reference's blocks cast their parameters (``repro/models/blocks.py``
    ``_cast``).  ``spec_string``, ``tiles`` (bm, bk, bn) and ``block_steps``
    schedule K1's blocks as the reference's ``matmul_pallas`` plans its grid
    (``brgemm.schedule``); on the CPU the schedule is validated too, so an
    illegal one raises on either device.  A scheduled product has no
    gradient."""
    if spec_string is not None or tiles is not None or block_steps:
        _no_grad("matmul with a spec string", a, b, bias)
    elif _wants_grad(a, b, bias):
        return _Matmul.apply(a, b, bias, activation, out_dtype)
    return _matmul_fwd(a, _cast(b, a.dtype), _cast(bias, a.dtype), activation, out_dtype,
                       spec_string, tiles, block_steps)


class _Attention(torch.autograd.Function):
    """Flash attention (K2, writing its row log-sum-exp) and its backward
    (K6) on the card; ``attention_fwd_ref`` and ``attention_bwd_ref`` on the
    CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        if _on_cpu(q, k, v):
            o, lse = ref.attention_fwd_ref(q, k, v, causal=causal, window=window, scale=scale)
        else:
            o, lse = fa.flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                                        with_lse=True)
        ctx.mask = (causal, window, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        if _on_cpu(q, k, v, do):
            grads = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window,
                                          scale=scale)
        else:
            grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window,
                                           scale=scale)
        dq, dk, dv = (_cast(g, t.dtype) for g, t in zip(grads, (q, k, v)))
        return dq, dk, dv, None, None, None


def attention(q, k, v, *, causal=True, window=None, scale=None):
    """Prefill and training attention, q (B,H,Sq,D), k/v (B,Hk,Skv,D) (K2;
    its gradient K6).  On the CPU, once the scores would be large (Sq·Skv >
    512·1024 and Sq > 512, the reference's test), the plain version runs in
    query blocks (``ref.attention_chunked``); a CUDA tensor goes to K2
    whatever its size."""
    if _on_cpu(q, k, v) and q.shape[2] * k.shape[2] > 512 * 1024 and q.shape[2] > 512:
        return ref.attention_chunked(q, k, v, causal=causal, window=window, scale=scale)
    if _wants_grad(q, k, v):
        return _Attention.apply(q, k, v, causal, window, scale)
    if _on_cpu(q, k, v):
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale)
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              scale=scale)


def decode_attention(q, k_cache, v_cache, *, length, window=None):
    """One-token attention over dense caches, q (B,H,D) (K3)."""
    if _on_cpu(q, k_cache, v_cache, length):
        return ref.decode_attention_ref(q, k_cache, v_cache, length=length,
                                        window=window)
    return fa.flash_decode(q, k_cache, v_cache, length=length, window=window)


def paged_decode_attention(q, k_pool, v_pool, page_table, *, page_size,
                           length, window=None):
    """One-token attention over token-major page pools (P + 1, page_size,
    Hk, D) through ``page_table`` (B, maxp), q (B,H,D) (K4)."""
    if _on_cpu(q, k_pool, v_pool, page_table, length):
        return ref.paged_decode_attention_ref(
            q, k_pool, v_pool, page_table, page_size=page_size,
            length=length, window=window)
    return fa.paged_decode(q, k_pool, v_pool, page_table, page_size=page_size,
                           length=length, window=window)


class _MambaScan(torch.autograd.Function):
    """The selective scan and its backward.  On the card: K8's forward
    writing the state entering each chunk of ``SCAN_STEPS`` steps, and K8's
    backward kernel walking those chunks in reverse.  On the CPU: the
    reference's rule for the forward (``mamba_scan_chunked`` past 64 steps,
    else ``mamba_scan_ref`` as one chunk) and ``mamba_scan_bwd_ref``.
    Saves the operands, h0 and the boundary states; nothing per step."""

    @staticmethod
    def forward(ctx, x, dt, a, b_in, c_in, d_skip, h0):
        if _on_cpu(x, dt, a, b_in, c_in, d_skip, h0):
            if x.shape[1] > 64:
                y, h, states, chunk = ref.mamba_scan_chunked(x, dt, a, b_in, c_in, d_skip,
                                                             h0=h0, states=True)
            else:
                y, h = ref.mamba_scan_ref(x, dt, a, b_in, c_in, d_skip, h0=h0)
                start = h.new_zeros(h.shape) if h0 is None else h0.float()
                states, chunk = start[:, None], max(x.shape[1], 1)
        else:
            y, h, states = scan.mamba_scan(x, dt, a, b_in, c_in, d_skip, h0=h0, states=True)
            chunk = scan.SCAN_STEPS
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, a, b_in, c_in, d_skip, h0, states)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, a, b_in, c_in, d_skip, h0, states = ctx.saved_tensors
        dy = dy.contiguous()
        if _on_cpu(x, dy, dh):
            grads = ref.mamba_scan_bwd_ref(x, dt, a, b_in, c_in, d_skip, h0, states, dy, dh,
                                           chunk=ctx.chunk)
        else:
            grads = scan.mamba_scan_bwd(x, dt, a, b_in, c_in, d_skip, states, dy,
                                        dh_final=dh, with_dh0=h0 is not None)
        dx, ddt, da, db, dc, dd, dh0 = grads
        return dx, ddt, da, db, dc, dd, dh0 if h0 is not None else None


def mamba_scan(x, dt, a, b_in, c_in, d_skip, *, h0=None, h_out=None):
    """The selective scan of a Mamba-1 layer, x, dt (B, L, D), a (D, N),
    b_in, c_in (B, L, N), d_skip (D,), h0 (B, D, N) or None; → (y (B, L, D)
    in x's dtype, h_final (B, D, N) fp32) (K8).  ``h_out`` (B, D, N) fp32,
    contiguous, receives h_final when given and may be ``h0``: a cache's
    state is then updated in place.  When an input requires a gradient the
    scan is differentiable (K8's backward on the card); ``h_out`` then
    raises ``ValueError``, since an in-place cache update is for serving."""
    if _wants_grad(x, dt, a, b_in, c_in, d_skip, h0):
        if h_out is not None:
            raise ValueError("mamba_scan: h_out updates a cache in place, for serving only;"
                             " it takes no gradient")
        return _MambaScan.apply(x, dt, a, b_in, c_in, d_skip, h0)
    if _on_cpu(x, dt, a, b_in, c_in, d_skip, h0, h_out):
        y, h = ref.mamba_scan_ref(x, dt, a, b_in, c_in, d_skip, h0=h0)
        return (y, h) if h_out is None else (y, h_out.copy_(h))
    return scan.mamba_scan(x, dt, a, b_in, c_in, d_skip, h0=h0, h_out=h_out)


def _no_grad(name, *tensors, why="the reference differentiates neither its Pallas kernel"
             " nor this one"):
    if _wants_grad(*tensors):
        raise NotImplementedError(f"{name} has no backward: {why}")


def block_spmm(blocks, row_id, col_id, b, *, nrows_b, bn=128, out_dtype=None):
    """C = A_sparse @ B, A a BCSR work list (``blocks`` (nnzb, bm, bk),
    ``row_id``/``col_id`` (nnzb,) int32, sorted row-major), b (K, N),
    possibly a transposed view; → (nrows_b·bm, N) in ``out_dtype`` (default
    ``b.dtype``) (K10).  ``bn`` is the reference's N tile; the CUDA kernel
    tiles N by 128 and masks a ragged last tile, so it takes any N.  On the
    card bf16 blocks of 64 rows run on wgmma (``block_spmm.spmm_plan``):
    store a matrix pruned in 8x8 or 16x16 blocks once as
    ``densify_to_bcsr(a, 64, bk)``.
    Inference only: an input that requires a gradient raises."""
    _no_grad("block_spmm", blocks, b)
    if _on_cpu(blocks, row_id, col_id, b):
        return ref.block_spmm_ref(blocks, row_id, col_id, b, nrows_b=nrows_b,
                                  out_dtype=out_dtype)
    return spmm.block_spmm(blocks, row_id, col_id, b, nrows_b=nrows_b, out_dtype=out_dtype)


def _grouped_fwd(x, group_id, w, out_dtype):
    if _on_cpu(x, group_id, w):
        return ref.grouped_matmul_ref(x, group_id, w, out_dtype=out_dtype)
    return spmm.grouped_matmul(x, group_id, w, out_dtype=out_dtype)


class _GroupedMatmul(torch.autograd.Function):
    """The per-row-tile expert product with w cast to x's dtype inside, so
    the gradient of fp32 master experts comes back in fp32 (K9's dW writes
    fp32) rather than rounded to the compute dtype first.  Backward: the
    incoming gradient rounded to x's dtype, then dX (K9's dX kernel, in x's
    dtype) and dW (K9's dW kernel, fp32) on the card, their plain versions
    on the CPU; ``group_id`` takes no gradient."""

    @staticmethod
    def forward(ctx, x, group_id, w, out_dtype):
        ctx.save_for_backward(x, group_id, w)
        return _grouped_fwd(x, group_id, _cast(w, x.dtype), out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, group_id, w = ctx.saved_tensors
        dyc = _cast(dy, x.dtype).contiguous()
        cpu = _on_cpu(x, group_id, w, dyc)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wc = _cast(w, x.dtype)
            dx = (ref.grouped_matmul_dx_ref(dyc, group_id, wc) if cpu
                  else spmm.grouped_matmul_dx(dyc, group_id, wc))
        if ctx.needs_input_grad[2]:
            dw = (ref.grouped_matmul_dw_ref(x, group_id, dyc, w.shape[0]) if cpu
                  else spmm.grouped_matmul_dw(x, group_id, dyc, w.shape[0]))
        return dx, None, _cast(dw, w.dtype), None


def grouped_matmul(x, group_id, w, *, bf=128, out_dtype=None):
    """Per-row-tile expert product: x (T, d) in ``len(group_id)`` row tiles,
    ``group_id`` (tiles,) int32, w (E, d, f); → (T, f) in ``out_dtype``
    (default ``x.dtype``) (K9).  ``w`` may be fp32 master weights: it is
    cast to ``x``'s dtype at use.  ``bf`` is the reference's f tile; the
    CUDA kernel tiles f by 128 (bf16) or 64 (fp32) and masks the edge.
    With a gradient wanted it is the autograd Function ``_GroupedMatmul``,
    whose backward is K9's dX and dW kernels on the card."""
    if _wants_grad(x, w):
        return _GroupedMatmul.apply(x, group_id, w, out_dtype)
    return _grouped_fwd(x, group_id, _cast(w, x.dtype), out_dtype)


def brgemm_blocked(a, b, *, spec_string="bca", k_step=1, block_steps=None, out_dtype=None):
    """Paper Listing 1: A (Mb, Kb, bm, bk) × B (Nb, Kb, bk, bn) → C (Nb, Mb,
    bm, bn) in ``out_dtype`` (default ``a.dtype``), each visit batch-reducing
    ``k_step`` blocks under ``spec_string`` (K11).  On the CPU the plain
    version, after the schedule is validated.  No gradient."""
    _no_grad("brgemm_blocked", a, b)
    if _on_cpu(a, b):
        brgemm.blocked_schedule(tuple(a.shape), tuple(b.shape), spec_string, k_step,
                                block_steps)
        return ref.brgemm_blocked_ref(a, b, out_dtype=out_dtype)
    return brgemm.brgemm_blocked(a, b, spec_string=spec_string, k_step=k_step,
                                 block_steps=block_steps, out_dtype=out_dtype)


def conv2d(x_nhwc, w_rsck, *, stride=1, out_dtype=None):
    """VALID convolution of x (N, H, W, C) with w (R, S, C, K) → (N, P, Q, K)
    in ``out_dtype`` (default x's dtype), through the paper's blocked
    layouts (bc = min(32, C), bk = min(32, K), as the reference): R = S = 1
    runs K12 (``conv.conv2d_1x1``, on K1), other filters Listing 4 on the
    executor (``conv.conv2d_parlooper``).  No gradient."""
    _no_grad("conv2d", x_nhwc, w_rsck)
    _on_cpu(x_nhwc, w_rsck)
    r, s = w_rsck.shape[:2]
    bc = min(32, x_nhwc.shape[-1])
    bk = min(32, w_rsck.shape[-1])
    xb, wb = conv.block_conv_tensors(x_nhwc, w_rsck, bc, bk)
    if r == 1 and s == 1:
        ob = conv.conv2d_1x1(xb, wb, stride=stride, out_dtype=out_dtype)
    else:
        ob = conv.conv2d_parlooper(xb, wb, stride=stride, out_dtype=out_dtype)
    n, kb, p, q, bko = ob.shape
    return ob.permute(0, 2, 3, 1, 4).reshape(n, p, q, kb * bko)
