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

For training, :func:`mamba_scan` with ``states=True`` also returns the
state entering each chunk of :data:`SCAN_STEPS` steps, which the prefill
stores as it walks, and :func:`mamba_scan_bwd` runs the backward kernel
(no TPU counterpart: the reference differentiates its XLA scan), whose plan
:func:`scan_bwd_plan` gives.  What bounds it is each channel's serial walk
and the states it recomputes (the reverse walk needs h_{t-1}, and keeping
every step's state would take gigabytes), so its design gives the card as
much to issue as it holds: 4 states a thread (N / 4 lanes a channel), a
block of 128 threads on 128 / lanes channels of one row, 4 blocks an SM;
the next chunk's x, dt and dy staged by ``cp.async`` (B and C in
registers) while one is walked in reverse; each chunk walked forward once
from its boundary state to the states entering its sub-chunks of
:data:`SCAN_BWD_SUB` steps, and each sub-chunk recomputed in registers
(the forward's arithmetic, so the forward's bits) and walked back from
there.  dB and dC (sums over D) are summed over a block's channels once a
sub-chunk and, by a second launch, over the channel blocks in block order;
dA and dD (sums over B and L) over the rows in row order: a row has the
same bits at any B.  Its plain version is
``kernels.ref.mamba_scan_bwd_ref``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

__all__ = ["mamba_scan", "mamba_scan_bwd", "scan_plan", "scan_bwd_plan", "ScanPlan",
           "ScanBwdPlan", "SCAN_LAUNCHES", "SCAN_PREFILL_LAUNCHES", "SCAN_DECODE_LAUNCHES",
           "SCAN_BWD_LAUNCHES", "STATE_SIZES", "SCAN_STEPS", "SCAN_BWD_SUB", "KERNEL_NAMES"]

# Launches of the CUDA kernels since import (or since a caller reset them):
# all of the forward's, those of each of its variants, and the backward's
# (two a call: the walk and the combine).
SCAN_LAUNCHES = 0
SCAN_PREFILL_LAUNCHES = 0
SCAN_DECODE_LAUNCHES = 0
SCAN_BWD_LAUNCHES = 0

STATE_SIZES = (8, 16)
_DTYPES = (torch.float32, torch.bfloat16)
# Steps a prefill chunk stages (csrc/mamba_scan.cu kSteps, which the
# wrapper checks against the library once).
SCAN_STEPS = 32
# Steps of a chunk the backward holds in registers at once
# (csrc/mamba_scan.cu kSub, checked the same way).
SCAN_BWD_SUB = 4
# The device kernel of each variant, as a profiler names it.
KERNEL_NAMES = {"prefill": "mamba_scan_prefill_kernel", "decode": "mamba_scan_decode_kernel",
                "backward": "mamba_scan_bwd_kernel"}

_THREADS = 128
_SMS = 132                    # an H100 SXM's SMs
_SM_SMEM = 233472             # shared memory an SM holds (228 KB)
_BLOCK_RESERVED = 1024        # and reserves for each resident block
# Blocks an SM the prefill on each lane count asks ptxas to keep resident
# (csrc/mamba_scan.cu MinBlocks, which the wrapper checks against the
# library's mamba_scan_min_blocks() once): its register budget.
_MIN_BLOCKS = {1: 2, 2: 4}
# The backward's (csrc/mamba_scan.cu kBwdMinBlocks): 128 registers a thread.
_BWD_MIN_BLOCKS = 4


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


def mamba_scan(x, dt, a, b_in, c_in, d_skip, *, h0=None, h_out=None, states=False):
    """x, dt (B, L, D) and b_in, c_in (B, L, N) CUDA tensors of one dtype
    (fp32 or bf16); x and dt with a unit stride along D (16-byte aligned
    rows for L > 1), b_in and c_in any strides; a (D, N), d_skip (D,) and
    h0 (B, D, N) or None, contiguous fp32.  → (y (B, L, D) in x's dtype,
    h_final (B, D, N) fp32), h_final written into ``h_out`` (contiguous
    fp32, may be ``h0``) when given; with ``states`` also (B, ceil(L /
    SCAN_STEPS), D, N) fp32, the state entering each chunk, which the
    backward starts from.  One launch, on the kernel :func:`scan_plan`
    names.  Raises on anything the kernels do not take."""
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
    bounds = (torch.empty(bsz, -(-l // SCAN_STEPS), dch, n, dtype=torch.float32,
                          device=x.device) if states else None)
    if h.numel() == 0 or l == 0:
        if l == 0:     # no step: the state as it was
            h = h.copy_(h0) if h0 is not None else h.zero_()
        return (y, h, bounds) if states else (y, h)
    plan = scan_plan(bsz, l, dch, n, x.dtype)
    _operands(plan, x, dt, a, d_skip, h0, h_out)
    if states and plan.variant == "decode":   # one step: the state entering it is h0
        if h0 is not None:
            bounds[:, 0].copy_(h0)
        else:
            bounds.zero_()
    err = _library().mamba_scan(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_in.data_ptr(), c_in.data_ptr(),
        d_skip.data_ptr(), h0.data_ptr() if h0 is not None else None, y.data_ptr(),
        h.data_ptr(), bounds.data_ptr() if states else None,
        int(x.dtype == torch.bfloat16), bsz, l, dch, n, plan.lanes,
        *x.stride()[:2], *dt.stride()[:2], *b_in.stride(), *c_in.stride(),
        torch._C._cuda_getCurrentRawStream(x.device.index))
    _build.check(err, "mamba_scan")
    SCAN_LAUNCHES += 1
    if plan.variant == "decode":
        SCAN_DECODE_LAUNCHES += 1
    else:
        SCAN_PREFILL_LAUNCHES += 1
    return (y, h, bounds) if states else (y, h)


class ScanBwdPlan(NamedTuple):
    """How K8's backward runs one call: ``grid`` (channel blocks of 128 /
    (N / 4) channels, B) of ``threads`` threads, N / 4 a channel (4 states
    each), ``smem_bytes`` of dynamic shared memory (x, dt and dy of two
    chunks, a chunk's dx and ddt, its B and C in fp32, the states entering
    its sub-chunks, a sub-chunk's dB and dC terms), ``blocks_per_sm``
    resident (by threads, shared memory and the kernel's register budget),
    the ``waves`` the grid takes on 132 SMs, ``chunks`` of
    :data:`SCAN_STEPS` steps walked in reverse, each in sub-chunks of
    :data:`SCAN_BWD_SUB`, and ``partial_bytes``, the workspace the wrapper
    allocates for the dB/dC sums of every (row, step, channel block) and
    the dA/dD of every row, which a second launch adds in block and row
    order."""
    variant: str
    grid: tuple
    threads: int
    smem_bytes: int
    blocks_per_sm: int
    waves: int
    chunks: int
    partial_bytes: int


@functools.lru_cache(maxsize=256)
def scan_bwd_plan(b, l, d, n, dtype):
    """K8's backward plan for x, dt (b, l, d) and a state of n in
    ``dtype``: a pure function of these (nothing is launched).  Lanes are n
    / 4 at every b: 4 states a thread, 4 lanes at N 16 and 2 at N 8.  A
    block's shared memory grows with the states it holds, not with its
    threads, so fewer lanes would hold more states a block and fewer warps
    an SM; 4 lanes put falcon-mamba-7b's B 2 layer (D 8192) in 512 blocks,
    4 an SM, one wave.  Raises ``ValueError`` for a dtype or state size the
    kernel does not take, or no step."""
    if dtype not in _DTYPES:
        raise ValueError(f"mamba_scan_bwd dtype {dtype}: need one of {_DTYPES}")
    if n not in STATE_SIZES:
        raise ValueError(f"mamba_scan_bwd state size {n}: need one of {STATE_SIZES}")
    if l < 1:
        raise ValueError(f"mamba_scan_bwd needs at least one step, not {l}")
    size = torch.finfo(dtype).bits // 8
    channels = _THREADS // (n // 4)
    gx = -(-d // channels)
    chunks = -(-l // SCAN_STEPS)
    # x, dt, dy in two buffers, dx and ddt, in the operands' type; B and C in
    # fp32; the states entering sub-chunks 1, 2, ...; a sub-chunk's dB and dC
    # terms and the 64 bytes between them, a float4 a thread and step
    smem = ((3 * 2 + 2) * SCAN_STEPS * channels * size + SCAN_STEPS * 2 * n * 4
            + (SCAN_STEPS // SCAN_BWD_SUB - 1 + 2 * SCAN_BWD_SUB) * _THREADS * 16 + 64)
    resident = min(2048 // _THREADS, _SM_SMEM // (smem + _BLOCK_RESERVED), _BWD_MIN_BLOCKS)
    waves = -(-gx * b // (_SMS * resident))
    partial = b * chunks * gx * SCAN_STEPS * 2 * n * 4 + b * d * (n + 1) * 4
    return ScanBwdPlan("backward", (gx, b), _THREADS, smem, resident, waves, chunks, partial)


def _rows_vectorisable(*tensors):
    """Whether the backward's 16-byte copies can stage these (B, L, D) rows:
    16-byte aligned bases, (batch, step) strides and D·size."""
    t = tensors[0]
    size = t.element_size()
    return (t.shape[-1] * size % 16 == 0
            and all(u.data_ptr() % 16 == 0
                    and all(m == 1 or u.stride(i) * size % 16 == 0
                            for i, m in enumerate(u.shape[:2]))
                    for u in tensors))


def mamba_scan_bwd(x, dt, a, b_in, c_in, d_skip, states, dy, *, dh_final=None, with_dh0=True):
    """The backward of :func:`mamba_scan` on CUDA tensors: its operands
    (x, dt, b_in, c_in as the forward read them), ``states`` (B, ceil(L /
    SCAN_STEPS), D, N) fp32 from the forward's ``states=True``, ``dy`` (B,
    L, D) in x's dtype with a unit stride along D, ``dh_final`` (B, D, N)
    fp32 or None.  → (dx, ddt (B, L, D) in x's dtype, da (D, N) fp32, db,
    dc (B, L, N) contiguous in x's dtype, dd (D,) fp32, dh0 (B, D, N) fp32
    or None without ``with_dh0``).  Two launches: the kernel
    :func:`scan_bwd_plan` plans (x, dt and dy rows that are not whole
    16-byte vectors are staged an element at a time), then the combine of
    its per-block sums.  Raises on anything it does not take."""
    global SCAN_BWD_LAUNCHES
    tensors = (x, dt, a, b_in, c_in, d_skip, states, dy, dh_final)
    if any(t is not None and t.device.type != "cuda" for t in tensors):
        raise ValueError("mamba_scan_bwd needs CUDA tensors")
    bsz, l, dch = x.shape
    n = a.shape[1]
    plan = scan_bwd_plan(bsz, l, dch, n, x.dtype)
    if dt.shape != x.shape or dy.shape != x.shape or a.shape != (dch, n):
        raise ValueError(f"mamba_scan_bwd x {tuple(x.shape)}, dt {tuple(dt.shape)},"
                         f" dy {tuple(dy.shape)}, a {tuple(a.shape)}")
    if b_in.shape != (bsz, l, n) or c_in.shape != (bsz, l, n) or d_skip.shape != (dch,):
        raise ValueError(f"mamba_scan_bwd b_in {tuple(b_in.shape)}, c_in {tuple(c_in.shape)},"
                         f" d_skip {tuple(d_skip.shape)}")
    if states.shape != (bsz, plan.chunks, dch, n):
        raise ValueError(f"mamba_scan_bwd states {tuple(states.shape)}:"
                         f" want {(bsz, plan.chunks, dch, n)}")
    if dh_final is not None and dh_final.shape != (bsz, dch, n):
        raise ValueError(f"mamba_scan_bwd dh_final {tuple(dh_final.shape)}")
    if any(t.dtype != x.dtype for t in (dt, b_in, c_in, dy)):
        raise ValueError("mamba_scan_bwd x, dt, b_in, c_in and dy must share a dtype")
    if any(t is not None and (t.dtype != torch.float32 or not t.is_contiguous()
                              or t.data_ptr() % 16)
           for t in (a, d_skip, states, dh_final)):
        raise ValueError("mamba_scan_bwd a, d_skip, states and dh_final must be contiguous fp32"
                         " with 16-byte aligned bases")
    for name, t in (("x", x), ("dt", dt), ("dy", dy)):
        if t.stride(-1) != 1 and dch > 1:
            raise ValueError(f"mamba_scan_bwd reads {name} along D in place: its last stride"
                             f" must be 1, not {t.stride(-1)}")
    dev = x.device
    dx = torch.empty(bsz, l, dch, dtype=x.dtype, device=dev)
    ddt = torch.empty_like(dx)
    db = torch.empty(bsz, l, n, dtype=x.dtype, device=dev)
    dc = torch.empty_like(db)
    da = torch.empty(dch, n, dtype=torch.float32, device=dev)
    dd = torch.empty(dch, dtype=torch.float32, device=dev)
    dh0 = torch.empty(bsz, dch, n, dtype=torch.float32, device=dev) if with_dh0 else None
    part = torch.empty(plan.partial_bytes // 4, dtype=torch.float32, device=dev)
    rows_part = part[part.numel() - bsz * dch * (n + 1):]     # the rows' dA and dD
    lib = _library()
    err = lib.mamba_scan_bwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_in.data_ptr(), c_in.data_ptr(),
        d_skip.data_ptr(), states.data_ptr(), dy.data_ptr(),
        dh_final.data_ptr() if dh_final is not None else None, dx.data_ptr(), ddt.data_ptr(),
        db.data_ptr(), dc.data_ptr(), da.data_ptr(), dd.data_ptr(),
        dh0.data_ptr() if dh0 is not None else None, part.data_ptr(), rows_part.data_ptr(),
        int(x.dtype == torch.bfloat16), int(_rows_vectorisable(x, dt, dy)),
        bsz, l, dch, n, *x.stride()[:2], *dt.stride()[:2], *b_in.stride(), *c_in.stride(),
        *dy.stride()[:2], torch._C._cuda_getCurrentRawStream(dev.index))
    _build.check(err, "mamba_scan_bwd")
    SCAN_BWD_LAUNCHES += 2
    return dx, ddt, da, db, dc, dd, dh0


@functools.lru_cache(maxsize=1)
def _library():
    """K8's library, once its chunk of steps is checked to be
    :data:`SCAN_STEPS` (the plans size shared memory by it), its prefill's
    register budgets to be :data:`_MIN_BLOCKS` (the plan counts resident
    blocks and waves by them), and its backward's sub-chunk, register
    budget, shared memory and resident blocks an SM, by dtype and state
    size, to be :func:`scan_bwd_plan`'s."""
    lib = _build.load("mamba_scan")
    if lib.mamba_scan_steps() != SCAN_STEPS:
        raise RuntimeError(f"csrc/mamba_scan.cu stages {lib.mamba_scan_steps()} steps a chunk,"
                           f" scan_plan {SCAN_STEPS}")
    built = {k: lib.mamba_scan_min_blocks(k) for k in _MIN_BLOCKS}
    if built != _MIN_BLOCKS:
        raise RuntimeError(f"csrc/mamba_scan.cu keeps {built} prefill blocks an SM by lanes,"
                           f" scan_plan {_MIN_BLOCKS}")
    if (lib.mamba_scan_bwd_sub(), lib.mamba_scan_bwd_min_blocks()) != (SCAN_BWD_SUB,
                                                                        _BWD_MIN_BLOCKS):
        raise RuntimeError(f"csrc/mamba_scan.cu's backward walks sub-chunks of"
                           f" {lib.mamba_scan_bwd_sub()} steps and keeps"
                           f" {lib.mamba_scan_bwd_min_blocks()} blocks an SM, scan_bwd_plan"
                           f" {SCAN_BWD_SUB} and {_BWD_MIN_BLOCKS}")
    for dtype in _DTYPES:
        for n in STATE_SIZES:
            plan = scan_bwd_plan(1, 1, 1, n, dtype)
            bf16 = int(dtype == torch.bfloat16)
            smem, regs, blocks = (lib.mamba_scan_bwd_info(bf16, n, w) for w in range(3))
            if (smem, blocks) != (plan.smem_bytes, plan.blocks_per_sm) or not 0 < regs <= (
                    65536 // (_THREADS * _BWD_MIN_BLOCKS)):
                raise RuntimeError(
                    f"csrc/mamba_scan.cu's backward in {dtype} at N {n}: {smem} bytes of shared"
                    f" memory, {regs} registers a thread, {blocks} blocks an SM; scan_bwd_plan"
                    f" {plan.smem_bytes} bytes, {plan.blocks_per_sm} blocks")
    return lib
