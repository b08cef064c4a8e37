"""K8: the selective scan of a Mamba-1 layer (prefill and decode).

Replaces ``repro/kernels/mamba_scan.py::mamba_scan_pallas`` (line 27).  The
CUDA source is ``csrc/mamba_scan.cu``, whose header says what bounds the
scan on an H100 (HBM bytes, and the B·L·D·N exponentials on the
special-function units) and what its design does about it.  The TPU kernel
carries the (D, N) state in VMEM across a sequential grid axis of time
chunks; here a block owns a run of channels of one row for the whole
sequence and walks time in a loop, its states in registers.
:func:`scan_plan` names the kernel a call runs: ``prefill`` (L > 1: x and
dt staged by ``cp.async`` a chunk of :data:`SCAN_STEPS` steps ahead, B and
C widened to fp32 in shared memory, ``lanes`` threads a channel) or
``decode`` (L = 1: no staging, 4 states a thread).  Both give a row the same
bits at any B.  B and C are read in place as column slices of the x
projection.  The plain version is ``kernels.ref.mamba_scan_ref``;
``kernels.ops.mamba_scan`` picks between the two by the device of the
tensors.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

__all__ = ["mamba_scan", "scan_plan", "ScanPlan", "SCAN_LAUNCHES", "SCAN_PREFILL_LAUNCHES",
           "SCAN_DECODE_LAUNCHES", "STATE_SIZES", "SCAN_STEPS", "KERNEL_NAMES"]

# Launches of the CUDA kernels since import (or since a caller reset them):
# all of them, and those of each variant.
SCAN_LAUNCHES = 0
SCAN_PREFILL_LAUNCHES = 0
SCAN_DECODE_LAUNCHES = 0

STATE_SIZES = (8, 16)
_DTYPES = (torch.float32, torch.bfloat16)
# Steps a prefill chunk stages (csrc/mamba_scan.cu kSteps, which the
# wrapper checks against the library once).
SCAN_STEPS = 32
# The device kernel of each variant, as a profiler names it.
KERNEL_NAMES = {"prefill": "mamba_scan_prefill_kernel", "decode": "mamba_scan_decode_kernel"}

_THREADS = 128
_SMS = 132                    # an H100 SXM's SMs
_SM_SMEM = 233472             # shared memory an SM holds (228 KB)
_BLOCK_RESERVED = 1024        # and reserves for each resident block
# Blocks an SM the prefill on each lane count asks ptxas to keep resident
# (csrc/mamba_scan.cu MinBlocks, which the wrapper checks against the
# library's mamba_scan_min_blocks() once): its register budget.
_MIN_BLOCKS = {1: 2, 2: 4}


class ScanPlan(NamedTuple):
    """How K8 runs one call: ``variant`` ("prefill" or "decode"),
    ``lanes`` threads a channel, ``grid`` (channel blocks, B) of
    ``threads`` threads, ``smem_bytes`` of dynamic shared memory,
    ``blocks_per_sm`` resident at least (by threads, shared memory and the
    kernel's register budget) and the ``waves`` the grid takes on 132
    SMs."""
    variant: str
    lanes: int
    grid: tuple
    threads: int
    smem_bytes: int
    blocks_per_sm: int
    waves: int


@functools.lru_cache(maxsize=256)
def scan_plan(b, l, d, n, dtype):
    """K8's plan for x, dt (b, l, d) and a state of n, in ``dtype``: a pure
    function of these (nothing is launched).  L = 1 is ``decode``, n / 4
    lanes a channel (4 states a thread); L > 1 is ``prefill``, on 1 lane a
    channel where that grid keeps at least 7/8 of the card's SMs busy (more
    states a thread, no shuffles), else 2: 1 lane at falcon-mamba-7b's B 4
    prefill, 2 at its batch-1 prefill, the fastest of 1, 2 and 4 at each
    on an H100 (PERF.md).  Raises ``ValueError`` for a dtype or state size
    the kernels do not take, and for a prefill whose x and dt rows the
    16-byte copies cannot cover (d elements not a multiple of 16 bytes)."""
    if dtype not in _DTYPES:
        raise ValueError(f"mamba_scan dtype {dtype}: need one of {_DTYPES}")
    if n not in STATE_SIZES:
        raise ValueError(f"mamba_scan state size {n}: need one of {STATE_SIZES}")
    if l < 1:
        raise ValueError(f"mamba_scan needs at least one step, not {l}")
    size = torch.finfo(dtype).bits // 8
    if l == 1:
        lanes = n // 4
        variant, smem, resident = "decode", 0, 2048 // _THREADS
    else:
        if d * size % 16:
            raise ValueError(f"mamba_scan prefill copies x and dt rows in 16-byte vectors:"
                             f" {d} channels of {size} bytes are not whole vectors")
        lanes = 1 if 8 * b * -(-d // _THREADS) >= 7 * _SMS else 2
        variant = "prefill"
        smem = 2 * 2 * SCAN_STEPS * (_THREADS // lanes) * size + SCAN_STEPS * 2 * n * 4
        resident = min(2048 // _THREADS, _SM_SMEM // (smem + _BLOCK_RESERVED), _MIN_BLOCKS[lanes])
    grid = (-(-d // (_THREADS // lanes)), b)
    waves = -(-grid[0] * grid[1] // (_SMS * resident))
    return ScanPlan(variant, lanes, grid, _THREADS, smem, resident, waves)


def _operands(plan, x, dt, a, d_skip, h0, h_out):
    """Raise ``ValueError`` for an operand the plan's kernel cannot read in
    place (no silent copy): x and dt need a unit stride along D, and for
    the prefill's 16-byte copies a 16-byte aligned base and (batch, step)
    strides; a, d_skip, h0 and h_out must be contiguous, the states with a
    16-byte aligned base (the kernels move them in 16-byte vectors)."""
    size = x.element_size()
    for name, t in (("x", x), ("dt", dt)):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"mamba_scan reads {name} along D in place: its last stride must be"
                             f" 1, not {t.stride(-1)}")
        if plan.variant == "prefill" and (
                t.data_ptr() % 16 or any(n > 1 and t.stride(i) * size % 16
                                         for i, n in enumerate(t.shape[:2]))):
            raise ValueError(f"mamba_scan prefill copies {name} in 16-byte vectors: its base"
                             f" {t.data_ptr()} and (batch, step) strides {t.stride()[:2]} must be"
                             f" multiples of 16 bytes")
    for name, t in (("a", a), ("d_skip", d_skip), ("h0", h0), ("h_out", h_out)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"mamba_scan {name} must be contiguous")
    for name, t in (("a", a), ("h0", h0), ("h_out", h_out)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"mamba_scan reads {name} in 16-byte vectors: its base"
                             f" {t.data_ptr()} is not a multiple of 16 bytes")


def mamba_scan(x, dt, a, b_in, c_in, d_skip, *, h0=None, h_out=None):
    """x, dt (B, L, D) and b_in, c_in (B, L, N) CUDA tensors of one dtype
    (fp32 or bf16); x and dt with a unit stride along D (16-byte aligned
    rows for L > 1), b_in and c_in any strides; a (D, N), d_skip (D,) and
    h0 (B, D, N) or None, contiguous fp32.  → (y (B, L, D) in x's dtype,
    h_final (B, D, N) fp32), h_final written into ``h_out`` (contiguous
    fp32, may be ``h0``) when given.  One launch, on the kernel
    :func:`scan_plan` names.  Raises on anything the kernels do not take."""
    global SCAN_LAUNCHES, SCAN_PREFILL_LAUNCHES, SCAN_DECODE_LAUNCHES
    tensors = (x, dt, a, b_in, c_in, d_skip, h0, h_out)
    if any(t is not None and t.device.type != "cuda" for t in tensors):
        raise ValueError("mamba_scan needs CUDA tensors")
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"mamba_scan x {tuple(x.shape)}, dt {tuple(dt.shape)}")
    bsz, l, dch = x.shape
    if a.dim() != 2 or a.shape[0] != dch:
        raise ValueError(f"mamba_scan a {tuple(a.shape)} for {dch} channels")
    n = a.shape[1]
    for name, t in (("b_in", b_in), ("c_in", c_in)):
        if t.shape != (bsz, l, n):
            raise ValueError(f"mamba_scan {name} {tuple(t.shape)}, want {(bsz, l, n)}")
    if d_skip.shape != (dch,) or (h0 is not None and h0.shape != (bsz, dch, n)):
        raise ValueError(f"mamba_scan d_skip {tuple(d_skip.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    if any(t.dtype != x.dtype for t in (dt, b_in, c_in)):
        raise ValueError(f"mamba_scan dtypes {x.dtype}, {dt.dtype}, {b_in.dtype}, {c_in.dtype}:"
                         f" need all alike")
    if any(t is not None and t.dtype != torch.float32 for t in (a, d_skip, h0, h_out)):
        raise ValueError("mamba_scan a, d_skip, h0 and h_out must be fp32")
    if h_out is not None and h_out.shape != (bsz, dch, n):
        raise ValueError(f"mamba_scan h_out {tuple(h_out.shape)}: want {(bsz, dch, n)}")
    y = torch.empty(bsz, l, dch, dtype=x.dtype, device=x.device)
    h = (torch.empty(bsz, dch, n, dtype=torch.float32, device=x.device)
         if h_out is None else h_out)
    if h.numel() == 0:
        return y, h
    if l == 0:     # no step: the state as it was
        return y, h.copy_(h0) if h0 is not None else h.zero_()
    plan = scan_plan(bsz, l, dch, n, x.dtype)
    _operands(plan, x, dt, a, d_skip, h0, h_out)
    err = _library().mamba_scan(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_in.data_ptr(), c_in.data_ptr(),
        d_skip.data_ptr(), h0.data_ptr() if h0 is not None else None, y.data_ptr(),
        h.data_ptr(), int(x.dtype == torch.bfloat16), bsz, l, dch, n, plan.lanes,
        *x.stride()[:2], *dt.stride()[:2], *b_in.stride(), *c_in.stride(),
        torch._C._cuda_getCurrentRawStream(x.device.index))
    _build.check(err, "mamba_scan")
    SCAN_LAUNCHES += 1
    if plan.variant == "decode":
        SCAN_DECODE_LAUNCHES += 1
    else:
        SCAN_PREFILL_LAUNCHES += 1
    return y, h


@functools.lru_cache(maxsize=1)
def _library():
    """K8's library, once its chunk of steps is checked to be
    :data:`SCAN_STEPS` (the plan sizes shared memory by it) and its
    prefill's register budgets to be :data:`_MIN_BLOCKS` (the plan counts
    resident blocks and waves by them)."""
    lib = _build.load("mamba_scan")
    if lib.mamba_scan_steps() != SCAN_STEPS:
        raise RuntimeError(f"csrc/mamba_scan.cu stages {lib.mamba_scan_steps()} steps a chunk,"
                           f" scan_plan {SCAN_STEPS}")
    built = {k: lib.mamba_scan_min_blocks(k) for k in _MIN_BLOCKS}
    if built != _MIN_BLOCKS:
        raise RuntimeError(f"csrc/mamba_scan.cu keeps {built} prefill blocks an SM by lanes,"
                           f" scan_plan {_MIN_BLOCKS}")
    return lib
