"""K8: the selective scan of a Mamba-1 layer (prefill and decode).

Replaces ``repro/kernels/mamba_scan.py::mamba_scan_pallas`` (line 27).  The
CUDA source is ``csrc/mamba_scan.cu``.  HBM bytes bound the scan on an H100
(one read of x, dt, B, C and the carried state, one write of y and the new
state; about 16 flops per byte in bf16 at N = 16).  The TPU kernel carries
the (D, N) state in VMEM across a sequential grid axis of time chunks; here
one block owns 32 channels of one row for the whole sequence and walks time
in a loop, four threads to a channel with N / 4 states each in registers,
staging 64 steps of x, dt, B and C in shared memory at a time.  B and C are
read in place as column slices of the x projection.  The plain version is
``kernels.ref.mamba_scan_ref``; ``kernels.ops.mamba_scan`` picks between
the two by the device of the tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["mamba_scan", "SCAN_LAUNCHES", "STATE_SIZES"]

# Launches of the CUDA kernel since import (or since a caller reset it).
SCAN_LAUNCHES = 0

STATE_SIZES = (8, 16)
_DTYPES = (torch.float32, torch.bfloat16)


def _rows(t):
    return t if t.stride(-1) == 1 else t.contiguous()


def mamba_scan(x, dt, a, b_in, c_in, d_skip, *, h0=None, h_out=None):
    """x, dt (B, L, D) and b_in, c_in (B, L, N) CUDA tensors of one dtype
    (fp32 or bf16), any (batch, step) strides; a (D, N), d_skip (D,) and h0
    (B, D, N) or None in fp32.  → (y (B, L, D) in x's dtype, h_final
    (B, D, N) fp32), h_final written into ``h_out`` (contiguous fp32, may
    be ``h0``) when given.  Raises on anything the kernel does not take."""
    global SCAN_LAUNCHES
    tensors = (x, dt, a, b_in, c_in, d_skip, h0, h_out)
    if any(t is not None and t.device.type != "cuda" for t in tensors):
        raise ValueError("mamba_scan needs CUDA tensors")
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"mamba_scan x {tuple(x.shape)}, dt {tuple(dt.shape)}")
    bsz, l, dch = x.shape
    if a.dim() != 2 or a.shape[0] != dch:
        raise ValueError(f"mamba_scan a {tuple(a.shape)} for {dch} channels")
    n = a.shape[1]
    if n not in STATE_SIZES:
        raise ValueError(f"mamba_scan state size {n}: need one of {STATE_SIZES}")
    for name, t in (("b_in", b_in), ("c_in", c_in)):
        if t.shape != (bsz, l, n):
            raise ValueError(f"mamba_scan {name} {tuple(t.shape)}, want {(bsz, l, n)}")
    if d_skip.shape != (dch,) or (h0 is not None and h0.shape != (bsz, dch, n)):
        raise ValueError(f"mamba_scan d_skip {tuple(d_skip.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (dt, b_in, c_in)):
        raise ValueError(f"mamba_scan dtypes {x.dtype}, {dt.dtype}, {b_in.dtype}, {c_in.dtype}:"
                         f" need one of {_DTYPES}, all alike")
    if any(t is not None and t.dtype != torch.float32 for t in (a, d_skip, h0, h_out)):
        raise ValueError("mamba_scan a, d_skip, h0 and h_out must be fp32")
    if h_out is not None and (h_out.shape != (bsz, dch, n) or not h_out.is_contiguous()):
        raise ValueError(f"mamba_scan h_out {tuple(h_out.shape)}: want a contiguous "
                         f"{(bsz, dch, n)}")
    x, dt, b_in, c_in = (_rows(t) for t in (x, dt, b_in, c_in))
    a, d_skip = a.contiguous(), d_skip.contiguous()
    h0 = h0.contiguous() if h0 is not None else None
    y = torch.empty(bsz, l, dch, dtype=x.dtype, device=x.device)
    h = (torch.empty(bsz, dch, n, dtype=torch.float32, device=x.device)
         if h_out is None else h_out)
    if h.numel() == 0:
        return y, h
    lib = _build.load("mamba_scan")
    err = lib.mamba_scan(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_in.data_ptr(), c_in.data_ptr(),
        d_skip.data_ptr(), h0.data_ptr() if h0 is not None else None, y.data_ptr(),
        h.data_ptr(), int(x.dtype == torch.bfloat16), bsz, l, dch, n,
        *x.stride()[:2], *dt.stride()[:2], *b_in.stride()[:2], *c_in.stride()[:2],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "mamba_scan")
    SCAN_LAUNCHES += 1
    return y, h
