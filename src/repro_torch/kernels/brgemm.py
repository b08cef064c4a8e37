"""K1: the GEMM kernel, ``C[M,N] = act(A[M,K] @ B[K,N] + bias)``.

Replaces ``repro/kernels/brgemm.py::matmul_pallas`` under its default
schedule ``"bca"`` (output-stationary, K innermost).  The CUDA source is
``csrc/gemm.cu``, whose header says what bounds the kernel on an H100 and
what its design does about it.  The plain version is
``kernels.ref.matmul_ref``; ``kernels.ops.matmul`` picks between the two by
the device of the tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["matmul", "LAUNCHES", "ACT_CODES"]

# Launches of the CUDA kernel since import (or since a caller reset it).
LAUNCHES = 0

ACT_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "sigmoid": 4}
_DTYPES = (torch.float32, torch.bfloat16)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if its rows are unit-stride, else a contiguous copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


def matmul(a, b, *, bias=None, activation=None, out_dtype=None):
    """act(a @ b + bias) on the GPU: a (M, K) and b (K, N) CUDA tensors of
    one dtype (fp32 or bf16), bias (N,); returns (M, N) in ``out_dtype``
    (default ``a.dtype``).  Raises on anything the kernel does not take."""
    global LAUNCHES
    if a.device.type != "cuda" or b.device.type != "cuda":
        raise ValueError(f"brgemm.matmul needs CUDA tensors, got {a.device} and {b.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"matmul dtypes {a.dtype}, {b.dtype}: need one of {_DTYPES}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _DTYPES:
        raise ValueError(f"matmul out_dtype {out_dtype}: need one of {_DTYPES}")
    if activation not in ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    m, k = a.shape
    n = b.shape[1]
    a, b = _rows(a), _rows(b)
    if bias is not None:
        if bias.shape != (n,):
            raise ValueError(f"bias shape {tuple(bias.shape)}, want ({n},)")
        bias = bias.to(a.dtype).contiguous()
    c = torch.empty(m, n, dtype=out_dtype, device=a.device)
    if c.numel() == 0:
        return c
    # 16-byte vector loads need 16-byte aligned rows (bf16 only).
    vec = (a.dtype == torch.bfloat16 and a.stride(0) % 8 == 0 and b.stride(0) % 8 == 0
           and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    lib = _build.load("gemm")
    err = lib.gemm(a.data_ptr(), b.data_ptr(),
                   bias.data_ptr() if bias is not None else None, c.data_ptr(),
                   int(a.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
                   m, n, k, a.stride(0), b.stride(0), ACT_CODES[activation], int(vec),
                   torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "gemm")
    LAUNCHES += 1
    return c
