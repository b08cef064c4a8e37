"""K7: the fused Bert-Output / Bert-SelfOutput layer (paper Listing 6),
``layernorm(dropout(x @ w + bias) + residual)`` in one kernel.

Replaces ``repro/kernels/fused_output.py::fused_output_pallas`` (line 48).
The CUDA source is ``csrc/fused_output.cu``, whose header says what bounds
the kernel on an H100 and what its design does about it: one block owns 32
rows and all N, keeping the fp32 row panel in shared memory (or, for N
wider than the C function ``fused_output_smem_max_n()`` gives, 1664 on an
H100, in a device-memory scratch the wrapper allocates).
``fused_output_ref`` is its plain version, the counterpart of the
reference's oracle of the same name; ``fused_output`` takes a CPU tensor to
the plain version and a CUDA tensor to the kernel.  Dropout
takes the caller's ``keep_mask``, as the reference's kernel does: there are
no random bits in the kernel (``fusion.library.fused_output_apply`` is the
fused-graph form with counter-based bits).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["fused_output", "fused_output_ref", "LAUNCHES"]

# Launches of the CUDA kernel since import (or since a caller reset it).
LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)


def fused_output_ref(x, w, bias, residual, gamma, beta, *, keep_mask=None,
                     dropout_rate: float = 0.0, eps: float = 1e-5, out_dtype=None):
    """x (M, K) @ w (K, N) + bias, dropout by ``keep_mask`` (kept values
    scaled by 1 / (1 - rate)) when both are given, + residual, layernorm
    over N with gamma and beta; all in fp32, cast to ``out_dtype`` (default
    ``x.dtype``)."""
    acc = torch.matmul(x.float(), w.float()) + bias.float()
    if keep_mask is not None and dropout_rate > 0.0:
        acc = torch.where(keep_mask, acc / (1.0 - dropout_rate), 0.0)
    acc = acc + residual.float()
    mu = acc.mean(-1, keepdim=True)
    var = ((acc - mu) ** 2).mean(-1, keepdim=True)
    y = (acc - mu) * torch.rsqrt(var + eps)
    y = y * gamma.float() + beta.float()
    return y.to(out_dtype or x.dtype)


def fused_output(x, w, bias, residual, gamma, beta, *, keep_mask=None,
                 dropout_rate: float = 0.0, eps: float = 1e-5, out_dtype=None):
    """Listing 6: CPU tensors run ``fused_output_ref``; CUDA tensors launch
    K7.  On the card x (M, K), w (K, N) and residual (M, N) are contiguous
    and of one dtype (fp32 or bf16); bias, gamma and beta (N,) any float
    dtype (read in fp32); ``keep_mask`` (M, N) bool or None; → (M, N) in
    ``out_dtype`` (default ``x.dtype``).  Raises on anything the kernel
    does not take."""
    global LAUNCHES
    tensors = (x, w, bias, residual, gamma, beta, keep_mask)
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return fused_output_ref(x, w, bias, residual, gamma, beta, keep_mask=keep_mask,
                                dropout_rate=dropout_rate, eps=eps, out_dtype=out_dtype)
    if kinds != {"cuda"}:
        raise ValueError(f"fused_output tensors on {sorted(kinds)}: need all on cpu or all on cuda")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fused_output shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if residual.shape != (m, n) or any(t.shape != (n,) for t in (bias, gamma, beta)):
        raise ValueError(f"fused_output residual {tuple(residual.shape)}, bias/gamma/beta "
                         f"{[tuple(t.shape) for t in (bias, gamma, beta)]} for ({m}, {n})")
    if x.dtype not in _DTYPES or w.dtype != x.dtype or residual.dtype != x.dtype:
        raise ValueError(f"fused_output dtypes x {x.dtype}, w {w.dtype}, residual "
                         f"{residual.dtype}: need one of {_DTYPES}, all alike")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _DTYPES:
        raise ValueError(f"fused_output out_dtype {out_dtype}: need one of {_DTYPES}")
    if not (x.is_contiguous() and w.is_contiguous() and residual.is_contiguous()):
        raise ValueError("fused_output: x, w and residual must be contiguous")
    dropping = keep_mask is not None and dropout_rate > 0.0
    if dropping and (keep_mask.shape != (m, n) or keep_mask.dtype != torch.bool
                     or not keep_mask.is_contiguous()):
        raise ValueError(f"fused_output keep_mask {tuple(keep_mask.shape)} {keep_mask.dtype}:"
                         f" want a contiguous ({m}, {n}) bool")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"fused_output dropout_rate {dropout_rate}: need 0 <= rate < 1")
    if m * max(n, k) >= 2 ** 31:
        raise ValueError(f"fused_output: ({m}, {n}, {k}) is too large for 32-bit indices")
    bias, gamma, beta = (t.float().contiguous() for t in (bias, gamma, beta))
    out = torch.empty(m, n, dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load("fused_output")
    scratch = None
    if n > lib.fused_output_smem_max_n():     # the row panel in device memory
        scratch = torch.empty(-(-m // 32) * 32, -(-n // 128) * 128, dtype=torch.float32,
                              device=x.device)
    vec = k % 8 == 0 and n % 8 == 0 and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    err = lib.fused_output(x.data_ptr(), w.data_ptr(), bias.data_ptr(), residual.data_ptr(),
                           keep_mask.data_ptr() if dropping else None, gamma.data_ptr(),
                           beta.data_ptr(), out.data_ptr(),
                           scratch.data_ptr() if scratch is not None else None,
                           int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
                           m, n, k, 1.0 / (1.0 - dropout_rate), eps, int(vec),
                           torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_output")
    LAUNCHES += 1
    return out
