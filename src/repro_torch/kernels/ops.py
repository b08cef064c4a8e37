"""Kernel API of the serving path, dispatched by device.

A CPU tensor runs the plain PyTorch version (``kernels/ref.py``); a CUDA
tensor runs the hand-written CUDA kernel, which launches or raises.  There is
no backend switch and no fallback: a kernel that fails to build or launch
fails the call.  Counterpart of ``repro/kernels/ops.py`` (``matmul``,
``attention``, ``decode_attention``, ``paged_decode_attention``).
"""
from __future__ import annotations

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


def matmul(a, b, *, bias=None, activation=None, out_dtype=None):
    """act(a @ b + bias) with an fp32 accumulator (K1)."""
    if _on_cpu(a, b, bias):
        return ref.matmul_ref(a, b, bias=bias, activation=activation,
                              out_dtype=out_dtype)
    return brgemm.matmul(a, b, bias=bias, activation=activation,
                         out_dtype=out_dtype)


def attention(q, k, v, *, causal=True, window=None, scale=None):
    """Prefill attention, q (B,H,Sq,D), k/v (B,Hk,Skv,D) (K2)."""
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
