"""Kernel API, dispatched by device, with the gradients training needs.

A CPU tensor runs the plain PyTorch version (``kernels/ref.py``); a CUDA
tensor runs the hand-written CUDA kernel, which launches or raises.  There is
no backend switch and no fallback: a kernel that fails to build or launch
fails the call.  Counterpart of ``repro/kernels/ops.py`` (``matmul``,
``attention``, ``decode_attention``, ``paged_decode_attention``).

``matmul`` and ``attention`` are ``torch.autograd.Function``s when an input
requires a gradient.  Their forward and backward dispatch by device too, so
the CPU tests run the same Function, saved tensors and backward wiring as
the card: ``matmul``'s backward is K1 on transposed operands, ``attention``'s
is K6 fed by K2's row log-sum-exp.  When no input requires a gradient they
call the forward alone and save nothing.
"""
from __future__ import annotations

import torch

from repro_torch.core import tpp
from repro_torch.kernels import brgemm, ref
from repro_torch.kernels import flash_attention as fa

__all__ = ["matmul", "attention", "decode_attention", "paged_decode_attention"]


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


def _matmul_fwd(a, b, bias, activation, out_dtype):
    if _on_cpu(a, b, bias):
        return ref.matmul_ref(a, b, bias=bias, activation=activation,
                              out_dtype=out_dtype)
    return brgemm.matmul(a, b, bias=bias, activation=activation,
                         out_dtype=out_dtype)


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


def matmul(a, b, *, bias=None, activation=None, out_dtype=None):
    """act(a @ b + bias) with an fp32 accumulator (K1).  ``b`` and ``bias``
    may be fp32 master weights: they are cast to ``a``'s dtype at use, as the
    reference's blocks cast their parameters (``repro/models/blocks.py``
    ``_cast``)."""
    if _wants_grad(a, b, bias):
        return _Matmul.apply(a, b, bias, activation, out_dtype)
    return _matmul_fwd(a, _cast(b, a.dtype), _cast(bias, a.dtype), activation, out_dtype)


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
    its gradient K6)."""
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
