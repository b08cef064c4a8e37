"""K1, the GEMM kernel ``C[M,N] = act(A[M,K] @ B[K,N] + bias)``, scheduled
by a PARLOOPER spec string; and K11, the paper's blocked BRGEMM (Listing 1).

K1 replaces ``repro/kernels/brgemm.py::matmul_pallas``.  Either operand may
be a transposed view (unit stride along its first axis, as ``w.T`` or
``x.T``): the kernel reads it in place, so the backward of a projection
(``dX = dY @ W.T``, ``dW = X.T @ dY``) copies nothing.  Without a spec
string, tiles or block steps it launches its fixed grid, whose raster
(block rows outer, block columns inner) is ``DEFAULT_SPEC``'s order.  With
any of them, ``matmul`` plans the reference's nest over (K, M, N) blocks
(``schedule``: ``ThreadedLoop`` + ``plan_cuda``, validated as the reference
validates it), maps the plan's output visit order onto K1's CTA tiles
(``cta_order``) and launches one block per entry of that table: the spec
string sets the order in which the tiles are rasterised.  Each tile is still
computed by one block in one K order, so every legal spec gives the same
bits.  ``autotune_matmul`` ranks those schedules by the performance model.

K1 has four variants (``gemm_variant``), chosen from the dtype, M and
whether TMA can read the operands where they lie, never from a build or
launch that failed: ``wgmma`` (bf16, M > 16) and ``wgmma_decode`` (bf16,
M <= 16: the split-K weight stream, ``decode_splits``) on the Hopper
mainloop ``csrc/gemm_mainloop.cuh``; ``wmma`` for bf16 operands TMA cannot
read; ``simt`` for fp32.

K11 (``brgemm_blocked``) replaces ``brgemm_blocked_pallas``: A (Mb, Kb, bm,
bk) × B (Nb, Kb, bk, bn) → C (Nb, Mb, bm, bn), each visit batch-reducing
``k_step`` block pairs, read in the paper's layouts in place; its bf16
blocks of 64 or 128 rows run on the same mainloop (``blocked_variant``).
The CUDA sources are ``csrc/gemm.cu`` and ``csrc/brgemm_blocked.cu``, whose
headers say what bounds each kernel on an H100 and what its design does
about it.
The plain versions are ``kernels.ref.matmul_ref`` and
``kernels.ref.brgemm_blocked_ref``; ``kernels.ops`` picks between kernel
and plain version by the device of the tensors.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.cuda_lowering import TensorMap, plan_cuda, validate_reduction_innermost
from repro_torch.core.executor import require_no_mesh
from repro_torch.core.legality import LegalityError
from repro_torch.core.loops import LoopSpec, ThreadedLoop
from repro_torch.kernels import _build

__all__ = ["matmul", "brgemm_blocked", "schedule", "autotune_matmul", "nest_inputs",
           "blocked_schedule", "cta_tile",
           "cta_order", "tile_order", "pick_tiles", "gemm_variant", "variant_of",
           "decode_splits", "blocked_variant", "blocked_pairs", "DEFAULT_SPEC", "VARIANTS",
           "WGMMA_TILE", "DECODE_ROWS", "DECODE_COLUMNS", "VARIANT_COUNTERS", "BLOCKED_COUNTERS",
           "LAUNCHES", "TRANSPOSED_LAUNCHES", "GEMM_WGMMA_LAUNCHES", "GEMM_WGMMA_DECODE_LAUNCHES",
           "GEMM_WMMA_LAUNCHES", "GEMM_SIMT_LAUNCHES", "BLOCKED_LAUNCHES", "BLOCKED_WGMMA_LAUNCHES",
           "BLOCKED_WMMA_LAUNCHES", "BLOCKED_SIMT_LAUNCHES", "ACT_CODES"]

DEFAULT_SPEC = "bca"  # output-stationary: M, N outer; K (reduction) innermost

# Launches of K1 since import (or since a caller reset it), how many of
# them read a transposed operand, and how many ran each variant.
LAUNCHES = 0
TRANSPOSED_LAUNCHES = 0
GEMM_WGMMA_LAUNCHES = 0
GEMM_WGMMA_DECODE_LAUNCHES = 0
GEMM_WMMA_LAUNCHES = 0
GEMM_SIMT_LAUNCHES = 0
# Launches of K11, and of each of its variants (wgmma, WMMA, SIMT).
BLOCKED_LAUNCHES = 0
BLOCKED_WGMMA_LAUNCHES = 0
BLOCKED_WMMA_LAUNCHES = 0
BLOCKED_SIMT_LAUNCHES = 0

# K1's variants, by the code the C entry takes (wmma and simt share 0: the
# dtype tells them apart), and the counter each adds to.
VARIANTS = {"wgmma": 1, "wgmma_decode": 2, "wmma": 0, "simt": 0}
VARIANT_COUNTERS = {"wgmma": "GEMM_WGMMA_LAUNCHES", "wgmma_decode": "GEMM_WGMMA_DECODE_LAUNCHES",
                    "wmma": "GEMM_WMMA_LAUNCHES", "simt": "GEMM_SIMT_LAUNCHES"}
# The wgmma variant's CTA tile (rows, columns), as csrc/gemm.cu builds it
# (K1_BN); the C entry refuses an order table made for another.
WGMMA_TILE = (128, 128)
# wgmma_decode: M <= DECODE_ROWS, DECODE_COLUMNS columns of C a CTA, K split
# so that about _DECODE_CTAS_PER_SM CTAs land on each of _SMS SMs.
DECODE_ROWS = 16
DECODE_COLUMNS = 128
_SMS = 132
_DECODE_CTAS_PER_SM = 2
_K_STEP = 64   # the mainloop's k-step (csrc/gemm_mainloop.cuh::BK)

ACT_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "sigmoid": 4}
_DTYPES = (torch.float32, torch.bfloat16)
# K11's limits: fragments of 16x16 a block (4 warps of at most 16), output
# elements a block in SIMT (256 threads of at most 32), shared memory.
_WMMA_MAX_FRAGMENTS = 64
_SIMT_MAX_ELEMENTS = 8192
_SMEM_MAX = 232448


def _divisors_desc(n: int, cands) -> int:
    for c in cands:
        if n % c == 0:
            return c
    return n


def pick_tiles(m: int, k: int, n: int, dtype=torch.bfloat16, vmem_budget: int = 96 * 2 ** 20):
    """The reference's tile choice (``repro/kernels/brgemm.py::pick_tiles``),
    so that a spec string without ``tiles`` plans the reference's nest:
    multiples of 128 on M and N where they divide, deep K blocks, within the
    TPU's VMEM budget with double buffering."""
    bm = _divisors_desc(m, (512, 256, 128, 64, 32, 16, 8, 4, 2))
    bn = _divisors_desc(n, (512, 256, 128, 64, 32, 16, 8, 4, 2))
    bk = _divisors_desc(k, (2048, 1024, 512, 256, 128, 64, 32, 16, 8, 4, 2))
    db = torch.empty((), dtype=dtype).element_size()
    while 2 * (bm * bk + bk * bn) * db + bm * bn * 4 > vmem_budget and bk > 8:
        bk //= 2
    return bm, bk, bn


def _steps_key(block_steps):
    return tuple(sorted((k, tuple(v)) for k, v in (block_steps or {}).items()))


def nest_inputs(m, k, n, tiles, steps=()):
    """(loops, [A's map, B's map], C's map): the reference's nest over
    (K, M, N) blocks of ``tiles`` = (bm, bk, bn), with ``steps``
    ((letter, block steps) pairs) as its blockings."""
    bm, bk, bn = tiles
    if m % bm or k % bk or n % bn:
        raise LegalityError(
            f"matmul {m}x{k}x{n} is not divisible by the tiles (bm {bm}, bk {bk}, bn {bn})",
            code="TPP108")
    steps = dict(steps)
    loops = [
        LoopSpec(0, k // bk, 1, block_steps=steps.get("a", ()), name="K"),
        LoopSpec(0, m // bm, 1, block_steps=steps.get("b", ()), name="M"),
        LoopSpec(0, n // bn, 1, block_steps=steps.get("c", ()), name="N"),
    ]
    return (loops, [TensorMap(("b", "a"), (bm, bk), layout="flat"),
                    TensorMap(("a", "c"), (bk, bn), layout="flat")],
            TensorMap(("b", "c"), (bm, bn), layout="flat"))


def _validate(tl):
    """What K1 launches: the reduction inside the output blocks, no mesh."""
    validate_reduction_innermost(tl.nest, ("b", "c"), ("a",))
    require_no_mesh(tl.nest)


@functools.lru_cache(maxsize=256)
def _matmul_plan(m, k, n, itemsize, spec_string, tiles, steps):
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    loops, in_maps, out_map = nest_inputs(m, k, n, tiles or pick_tiles(m, k, n, dtype), steps)
    tl = ThreadedLoop(loops, spec_string, reduction_letters=("a",))
    _validate(tl)
    return plan_cuda(tl.nest, in_maps, out_map, reduction_letters=("a",))


def autotune_matmul(m, k, n, *, dtype=torch.bfloat16, tiles=None, target=None,
                    max_candidates=64, top_k=8, cache=None, cache_dir=None,
                    use_cache=True, return_stats=False):
    """K1's schedules for an (m, k) @ (k, n) product of ``dtype``, ranked
    best-first by the performance model (``core.autotune`` under
    ``target``, default ``perf_model.H100Target()``): the nest ``schedule``
    plans over (K, M, N) blocks of ``tiles`` (default ``pick_tiles``), with
    only the plans K1 launches (the reduction inside the output blocks).
    Returns the ``TuneResult``s (and the ``SearchStats`` with
    ``return_stats``); ``matmul(a, b, tiles=tiles,
    **fusion.schedule_kwargs(result.candidate))`` launches one.  The search
    persists in the tune cache under a key of K1's own."""
    from repro_torch.core import autotune, perf_model

    tiles = tuple(tiles or pick_tiles(m, k, n, dtype))
    bm, bk, bn = tiles
    loops, in_maps, out_map = nest_inputs(m, k, n, tiles)
    results, stats = autotune.autotune_with_stats(
        loops, in_maps, out_map, dtype=dtype, flops_per_body=2.0 * bm * bk * bn,
        tile_mnk=(bm, bn, bk), reduction_letters=("a",),
        target=target or perf_model.H100Target(), max_candidates=max_candidates,
        top_k=top_k,
        spec_filter=lambda perm, _par, mesh: autotune.reduction_inside_outputs(perm, mesh),
        validate_fn=_validate, cache=cache, cache_dir=cache_dir, use_cache=use_cache,
        cache_extra=("brgemm.matmul",))
    return (results, stats) if return_stats else results


def schedule(m, k, n, dtype, spec_string=None, tiles=None, block_steps=None):
    """K1's plan for an (m, k) @ (k, n) product: None when no spec string,
    tiles or block steps are given (the fixed grid); else the ``CudaPlan``
    of the reference's nest over (K, M, N) blocks of ``tiles`` (default
    ``pick_tiles``), under ``spec_string`` (default ``DEFAULT_SPEC``).
    Raises ``LegalityError`` where the reference raises: ``TPP101``,
    ``TPP102``, ``TPP107``, ``TPP108`` (also for tiles that do not divide
    the shape, where the reference asserts), and for a mesh level, which
    the port does not run."""
    if spec_string is None and tiles is None and not block_steps:
        return None
    itemsize = torch.empty((), dtype=dtype).element_size()
    return _matmul_plan(m, k, n, itemsize, spec_string or DEFAULT_SPEC,
                        tuple(tiles) if tiles else None, _steps_key(block_steps))


def gemm_variant(m: int, n: int, k: int, dtype, trans_a: bool = False, trans_b: bool = False,
                 aligned: bool = True) -> str:
    """Which variant of K1 computes an (m, k) @ (k, n) product of ``dtype``
    operands: ``"simt"`` for fp32; for bf16, ``"wmma"`` when TMA cannot read
    an operand where it lies (``aligned`` false: a base pointer, or the row
    stride of a stored matrix with more than one row, not a multiple of 16
    bytes), else ``"wgmma_decode"`` for m <= ``DECODE_ROWS`` and ``"wgmma"``
    above.  Every transposition runs on every variant, and n and k choose
    nothing: the choice follows the dtype, M and the layout alone."""
    if dtype != torch.bfloat16:
        return "simt"
    if not aligned:
        return "wmma"
    return "wgmma_decode" if m <= DECODE_ROWS else "wgmma"


def decode_splits(k: int, n: int) -> tuple[int, int]:
    """→ (splits, steps a split) of wgmma_decode's K: from (k, n) alone,
    never from M, so that a row of C has the same bits at every M <= 16.
    The ``ceil(n / DECODE_COLUMNS)`` column panels times the splits fill
    the SMs about ``_DECODE_CTAS_PER_SM`` times over, and no more; a split
    holds at least one 64-deep step, and every split some."""
    steps = -(-k // _K_STEP)
    panels = -(-n // DECODE_COLUMNS)
    if steps == 0:
        return 1, 1
    want = max(1, min(steps, _SMS * _DECODE_CTAS_PER_SM // panels))
    per = -(-steps // want)
    return -(-steps // per), per


def cta_tile(m: int, variant: str) -> tuple[int, int]:
    """The (rows, columns) of C that one K1 block of ``variant`` computes,
    as ``csrc/gemm.cu``'s launch picks them: ``WGMMA_TILE`` for wgmma,
    (16, 128) for wgmma_decode (its K splits share one tile), 128x128 in
    WMMA (16x64 for M <= 16), 64x64 in fp32."""
    if variant == "simt":
        return 64, 64
    if variant == "wmma":
        return (16, 64) if m <= 16 else (128, 128)
    if variant == "wgmma":
        return WGMMA_TILE
    if variant == "wgmma_decode":
        return DECODE_ROWS, DECODE_COLUMNS
    raise ValueError(f"unknown K1 variant {variant!r}")


def tile_order(visits, block: tuple[int, int], cta: tuple[int, int]) -> torch.Tensor:
    """(T, 2) int32 (row, column) origins of CTA tiles of shape ``cta`` in
    the order output blocks of shape ``block`` at block indices ``visits``
    first touch them: each visited block, in order, lists the CTA tiles it
    touches row by row, and a tile shared with an earlier block keeps its
    first place.  Every tile appears once."""
    block_m, block_n = block
    cta_m, cta_n = cta
    seen, order = set(), []
    for i, j in visits:
        for ti in range(i * block_m // cta_m, ((i + 1) * block_m - 1) // cta_m + 1):
            for tj in range(j * block_n // cta_n, ((j + 1) * block_n - 1) // cta_n + 1):
                if (ti, tj) not in seen:
                    seen.add((ti, tj))
                    order.append((ti * cta_m, tj * cta_n))
    return torch.tensor(order, dtype=torch.int32)


@functools.lru_cache(maxsize=256)
def cta_order(plan, m: int, n: int, cta: tuple[int, int]) -> torch.Tensor:
    """(T, 2) int32 (row, column) origins of K1's CTA tiles in the order the
    plan first visits them (``tile_order`` over its output blocks)."""
    return tile_order(plan.visit_order.tolist(), plan.out_block, cta)


# Order tables on the card, by (plan, shape, tile, device).
_DEVICE_TABLES: dict = {}


def _device_table(key, make, device):
    table = _DEVICE_TABLES.get((key, device))
    if table is None:
        table = _DEVICE_TABLES[(key, device)] = make().to(device)
    return table


def _layout(t: torch.Tensor):
    """→ (tensor, transposed, leading dimension) for a 2-D operand: rows of
    unit stride as they are, a transposed view (unit stride down its
    columns) as its stored matrix, anything else as a contiguous copy."""
    if t.stride(-1) == 1 and (t.shape[0] <= 1 or t.stride(0) >= max(t.shape[1], 1)):
        return t, False, max(t.stride(0), 1)
    if t.stride(0) == 1 and t.stride(1) >= max(t.shape[0], 1):
        return t, True, t.stride(1)
    t = t.contiguous()
    return t, False, max(t.stride(0), 1)


def _tma_readable(t: torch.Tensor, ld: int, rows: int) -> bool:
    """Whether TMA reads the stored matrix of ``rows`` rows (row stride
    ``ld``) under ``t``: a 16-byte aligned base, and a 16-byte multiple row
    stride when there is more than one row."""
    return t.data_ptr() % 16 == 0 and (rows <= 1 or ld * t.element_size() % 16 == 0)


def _operands(a, b):
    """→ (a, trans_a, lda, b, trans_b, ldb, aligned) for ``a @ b``: each
    operand as ``_layout`` reads it, and whether TMA can read both (bf16
    only)."""
    m, k = a.shape
    n = b.shape[1]
    a, trans_a, lda = _layout(a)
    b, trans_b, ldb = _layout(b)
    aligned = (a.dtype == torch.bfloat16 and _tma_readable(a, lda, k if trans_a else m)
               and _tma_readable(b, ldb, n if trans_b else k))
    return a, trans_a, lda, b, trans_b, ldb, aligned


def variant_of(a, b) -> str:
    """The variant ``matmul`` launches for ``a @ b`` (2-D tensors of one
    dtype, on any device): ``gemm_variant`` of their dtype, M,
    transpositions and whether TMA reads them where they lie."""
    _, trans_a, _, _, trans_b, _, aligned = _operands(a, b)
    return gemm_variant(a.shape[0], b.shape[1], a.shape[1], a.dtype, trans_a, trans_b, aligned)


# wgmma_decode's split counters by (device, stream): one zero int32 a
# column panel, reset by the kernel's last split.  A launch on one stream
# follows the one before it, so launches on a stream may share them.
_DECODE_COUNTERS: dict = {}


def _decode_counters(device, stream, panels: int) -> torch.Tensor:
    key = (device, stream)
    counters = _DECODE_COUNTERS.get(key)
    if counters is None or counters.numel() < panels:
        counters = _DECODE_COUNTERS[key] = torch.zeros(max(panels, 256), dtype=torch.int32,
                                                       device=device)
    return counters


def matmul(a, b, *, bias=None, activation=None, out_dtype=None, spec_string=None,
           tiles=None, block_steps=None, variant=None):
    """act(a @ b + bias) on the GPU: a (M, K) and b (K, N) CUDA tensors of
    one dtype (fp32 or bf16), each row-major or a transposed view, bias
    (N,); returns (M, N) in ``out_dtype`` (default ``a.dtype``).
    ``spec_string``, ``tiles`` (bm, bk, bn) and ``block_steps`` (per-letter
    blocking lists, in tiles) schedule the blocks as ``schedule`` plans
    them.  ``variant`` is ``gemm_variant``'s choice unless given (to time
    one variant beside another on the same operands); one the operands'
    dtype, M or layout does not allow raises.  Raises on anything the
    kernel does not take."""
    global LAUNCHES, TRANSPOSED_LAUNCHES
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
    plan = schedule(m, k, n, a.dtype, spec_string, tiles, block_steps)
    a, trans_a, lda, b, trans_b, ldb, aligned = _operands(a, b)
    bf16 = a.dtype == torch.bfloat16
    variant = variant or gemm_variant(m, n, k, a.dtype, trans_a, trans_b, aligned)
    if not bf16:
        allowed = {"simt"}
    elif not aligned:
        allowed = {"wmma"}
    else:
        allowed = {"wmma", "wgmma"} | ({"wgmma_decode"} if m <= DECODE_ROWS else set())
    if variant not in allowed:
        raise ValueError(f"K1 variant {variant!r} does not take this product ({a.dtype}, M {m},"
                         f" TMA-readable {aligned}): {sorted(allowed)}")
    if bias is not None:
        if bias.shape != (n,):
            raise ValueError(f"bias shape {tuple(bias.shape)}, want ({n},)")
        bias = bias.to(a.dtype).contiguous()
    c = torch.empty(m, n, dtype=out_dtype, device=a.device)
    if c.numel() == 0:
        return c
    cta = cta_tile(m, variant)
    order, n_order = None, 0
    if plan is not None:
        order = _device_table((plan, m, n, cta), lambda: cta_order(plan, m, n, cta), a.device)
        n_order = order.shape[0]
    stream = torch._C._cuda_getCurrentRawStream(a.device.index)  # current_stream's, cheaper
    ws, counters, splits, split_steps = None, None, 1, 1
    if variant == "wgmma_decode":
        splits, split_steps = decode_splits(k, n)
        if splits > 1:
            ws = torch.empty(splits, m, n, dtype=torch.float32, device=a.device)
            counters = _decode_counters(a.device, stream, -(-n // DECODE_COLUMNS))
    # wmma's 16-byte vector loads need 16-byte aligned stored rows
    vec = (bf16 and lda % 8 == 0 and ldb % 8 == 0
           and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    lib = _build.load("gemm")
    err = lib.gemm(a.data_ptr(), b.data_ptr(),
                   bias.data_ptr() if bias is not None else None, c.data_ptr(),
                   int(bf16), int(out_dtype == torch.bfloat16),
                   m, n, k, lda, ldb, int(trans_a), int(trans_b), ACT_CODES[activation], int(vec),
                   order.data_ptr() if order is not None else None, n_order,
                   VARIANTS[variant], cta[1], ws.data_ptr() if ws is not None else None,
                   counters.data_ptr() if counters is not None else None, splits, split_steps,
                   stream)
    _build.check(err, "gemm")
    LAUNCHES += 1
    if trans_a or trans_b:
        TRANSPOSED_LAUNCHES += 1
    globals()[VARIANT_COUNTERS[variant]] += 1
    return c


@functools.lru_cache(maxsize=256)
def _blocked_plan(mb, kb, nb, bm, bk, bn, spec_string, k_step, steps):
    steps = dict(steps)
    loops = [
        LoopSpec(0, kb, k_step, block_steps=steps.get("a", ()), name="K"),
        LoopSpec(0, mb, 1, block_steps=steps.get("b", ()), name="M"),
        LoopSpec(0, nb, 1, block_steps=steps.get("c", ()), name="N"),
    ]
    tl = ThreadedLoop(loops, spec_string, reduction_letters=("a",))
    validate_reduction_innermost(tl.nest, ("b", "c"), ("a",))
    require_no_mesh(tl.nest)
    return plan_cuda(
        tl.nest,
        [TensorMap(("b", "a"), (bm, bk), layout="blocked"),
         TensorMap(("c", "a"), (bk, bn), layout="blocked")],
        TensorMap(("c", "b"), (bm, bn), layout="blocked"),
        reduction_letters=("a",))


def blocked_schedule(a_shape, b_shape, spec_string="bca", k_step=1, block_steps=None):
    """K11's plan for A ``a_shape`` (Mb, Kb, bm, bk) and B ``b_shape`` (Nb,
    Kb, bk, bn): the reference's nest (K by ``k_step`` blocks, M, N) under
    ``spec_string``, validated as the reference validates it; its visit
    order lists (n, m) output blocks.  Raises ``ValueError`` on shapes that
    do not match and ``LegalityError`` on an illegal schedule."""
    if len(a_shape) != 4 or len(b_shape) != 4:
        raise ValueError(f"brgemm_blocked wants 4-D blocked operands, got {a_shape}, {b_shape}")
    mb, kb, bm, bk = a_shape
    nb, kb2, bk2, bn = b_shape
    if kb != kb2 or bk != bk2:
        raise ValueError(f"brgemm_blocked shapes {tuple(a_shape)} x {tuple(b_shape)}")
    return _blocked_plan(mb, kb, nb, bm, bk, bn, spec_string, k_step, _steps_key(block_steps))


def blocked_variant(dtype, bm, bk, bn, aligned: bool = True) -> str:
    """Which variant of K11 runs: ``"wgmma"`` (bf16, bm 64 or 128, bn a
    multiple of 16 up to 256, bk a multiple of 16, operands TMA can read:
    ``aligned``), ``"wmma"`` (other bf16 blocks with bm, bn, bk multiples of
    16) or ``"simt"``; raises for a block K11 does not take."""
    if (dtype == torch.bfloat16 and aligned and bm in (64, 128) and bn % 16 == 0
            and bn <= 256 and bk % 16 == 0):
        return "wgmma"
    if (dtype == torch.bfloat16 and bm % 16 == 0 and bn % 16 == 0 and bk % 16 == 0
            and (bm // 16) * (bn // 16) <= _WMMA_MAX_FRAGMENTS):
        return "wmma"
    if bm * bn > _SIMT_MAX_ELEMENTS or (bm + bn) * 16 * 4 > _SMEM_MAX:
        raise ValueError(f"brgemm_blocked takes output blocks of at most {_SIMT_MAX_ELEMENTS} "
                         f"elements in SIMT (or {_WMMA_MAX_FRAGMENTS} 16x16 fragments in bf16, "
                         f"or bm 64 or 128 by bn up to 256 on wgmma), got {bm}x{bn}")
    return "simt"


def blocked_pairs(visits) -> torch.Tensor:
    """(P, 3) int32 (n, m, n_hi): the output blocks of ``visits`` ((n, m),
    each once) in order, two that follow one another in one block row m
    joined into one entry (n_hi the second's n), a block alone with n_hi
    -1.  The wgmma variant of K11 computes an entry a CTA, loading A's block
    row once for both blocks."""
    out, i = [], 0
    while i < len(visits):
        n, m = visits[i]
        if i + 1 < len(visits) and visits[i + 1][1] == m:
            out.append((n, m, visits[i + 1][0]))
            i += 2
        else:
            out.append((n, m, -1))
            i += 1
    return torch.tensor(out, dtype=torch.int32).reshape(-1, 3)


_BLOCKED_CODES = {"simt": 0, "wmma": 1, "wgmma": 2}
BLOCKED_COUNTERS = {"simt": "BLOCKED_SIMT_LAUNCHES", "wmma": "BLOCKED_WMMA_LAUNCHES",
                    "wgmma": "BLOCKED_WGMMA_LAUNCHES"}


def brgemm_blocked(a, b, *, spec_string="bca", k_step=1, block_steps=None, out_dtype=None,
                   variant=None, pairs=True):
    """Paper Listing 1 on the GPU: A (Mb, Kb, bm, bk) × B (Nb, Kb, bk, bn) →
    C (Nb, Mb, bm, bn) in ``out_dtype`` (default ``a.dtype``), fp32
    accumulator; contiguous CUDA tensors of one dtype (fp32 or bf16).
    ``spec_string`` over a = K (``k_step`` blocks a visit), b = M, c = N
    sets the order of the output blocks; ``block_steps`` the multi-level
    blocking.  ``variant`` is ``blocked_variant``'s choice unless given (to
    time one variant beside another; the kernel refuses a block its
    variant does not take).  With ``pairs``, the wgmma variant at 64-row
    blocks at most 64 wide computes two blocks of one block row a CTA where
    the order table lists them one after the other (``blocked_pairs``):
    the same bits, A's loads shared.  Raises on anything the kernel does
    not take."""
    global BLOCKED_LAUNCHES
    if a.device.type != "cuda" or b.device.type != "cuda":
        raise ValueError(f"brgemm_blocked needs CUDA tensors, got {a.device} and {b.device}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"brgemm_blocked dtypes {a.dtype}, {b.dtype}: need one of {_DTYPES}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("brgemm_blocked reads the blocked layouts in place: pass contiguous "
                         "tensors")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _DTYPES:
        raise ValueError(f"brgemm_blocked out_dtype {out_dtype}: need one of {_DTYPES}")
    plan = blocked_schedule(tuple(a.shape), tuple(b.shape), spec_string, k_step, block_steps)
    mb, kb, bm, bk = a.shape
    nb, bn = b.shape[0], b.shape[3]
    vec = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    variant = variant or blocked_variant(a.dtype, bm, bk, bn, aligned=vec)
    c = torch.empty(nb, mb, bm, bn, dtype=out_dtype, device=a.device)
    if c.numel() == 0:
        return c
    paired = pairs and variant == "wgmma" and bm == 64 and bn <= 64
    if paired:
        order = _device_table(("pairs", plan), lambda: blocked_pairs(plan.visit_order.tolist()),
                              a.device)
    else:
        order = _device_table(plan, lambda: plan.visit_order.contiguous(), a.device)
    lib = _build.load("brgemm_blocked")
    err = lib.brgemm_blocked(a.data_ptr(), b.data_ptr(), c.data_ptr(), order.data_ptr(),
                             order.shape[0], int(paired), int(a.dtype == torch.bfloat16),
                             int(out_dtype == torch.bfloat16), _BLOCKED_CODES[variant],
                             mb, nb, kb, bm, bn, bk, k_step, int(vec),
                             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "brgemm_blocked")
    BLOCKED_LAUNCHES += 1
    globals()[BLOCKED_COUNTERS[variant]] += 1
    return c
