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
bits.

K11 (``brgemm_blocked``) replaces ``brgemm_blocked_pallas``: A (Mb, Kb, bm,
bk) × B (Nb, Kb, bk, bn) → C (Nb, Mb, bm, bn), each visit batch-reducing
``k_step`` block pairs, read in the paper's layouts in place.  The CUDA
sources are ``csrc/gemm.cu`` and ``csrc/brgemm_blocked.cu``, whose headers
say what bounds each kernel on an H100 and what its design does about it.
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

__all__ = ["matmul", "brgemm_blocked", "schedule", "blocked_schedule", "cta_tile",
           "cta_order", "tile_order", "pick_tiles", "DEFAULT_SPEC", "LAUNCHES", "TRANSPOSED_LAUNCHES",
           "BLOCKED_LAUNCHES", "BLOCKED_WMMA_LAUNCHES", "BLOCKED_SIMT_LAUNCHES", "ACT_CODES"]

DEFAULT_SPEC = "bca"  # output-stationary: M, N outer; K (reduction) innermost

# Launches of K1 since import (or since a caller reset it), and how many of
# them read a transposed operand.
LAUNCHES = 0
TRANSPOSED_LAUNCHES = 0
# Launches of K11, and of each of its variants (tensor cores, SIMT).
BLOCKED_LAUNCHES = 0
BLOCKED_WMMA_LAUNCHES = 0
BLOCKED_SIMT_LAUNCHES = 0

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


@functools.lru_cache(maxsize=256)
def _matmul_plan(m, k, n, itemsize, spec_string, tiles, steps):
    dtype = torch.bfloat16 if itemsize == 2 else torch.float32
    bm, bk, bn = tiles or pick_tiles(m, k, n, dtype)
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
    tl = ThreadedLoop(loops, spec_string, reduction_letters=("a",))
    validate_reduction_innermost(tl.nest, ("b", "c"), ("a",))
    require_no_mesh(tl.nest)
    return plan_cuda(
        tl.nest,
        [TensorMap(("b", "a"), (bm, bk), layout="flat"),
         TensorMap(("a", "c"), (bk, bn), layout="flat")],
        TensorMap(("b", "c"), (bm, bn), layout="flat"),
        reduction_letters=("a",))


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


def cta_tile(m: int, in_bf16: bool) -> tuple[int, int]:
    """The (rows, columns) of C that one K1 block computes, as
    ``csrc/gemm.cu``'s launch picks them: 128x128 on the tensor cores, 16x64
    for M <= 16 (decode), 64x64 in fp32."""
    if not in_bf16:
        return 64, 64
    return (16, 64) if m <= 16 else (128, 128)


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


def matmul(a, b, *, bias=None, activation=None, out_dtype=None, spec_string=None,
           tiles=None, block_steps=None):
    """act(a @ b + bias) on the GPU: a (M, K) and b (K, N) CUDA tensors of
    one dtype (fp32 or bf16), each row-major or a transposed view, bias
    (N,); returns (M, N) in ``out_dtype`` (default ``a.dtype``).
    ``spec_string``, ``tiles`` (bm, bk, bn) and ``block_steps`` (per-letter
    blocking lists, in tiles) schedule the blocks as ``schedule`` plans
    them.  Raises on anything the kernel does not take."""
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
    a, trans_a, lda = _layout(a)
    b, trans_b, ldb = _layout(b)
    if bias is not None:
        if bias.shape != (n,):
            raise ValueError(f"bias shape {tuple(bias.shape)}, want ({n},)")
        bias = bias.to(a.dtype).contiguous()
    c = torch.empty(m, n, dtype=out_dtype, device=a.device)
    if c.numel() == 0:
        return c
    order, n_order = None, 0
    if plan is not None:
        cta = cta_tile(m, a.dtype == torch.bfloat16)
        order = _device_table((plan, m, n, cta), lambda: cta_order(plan, m, n, cta), a.device)
        n_order = order.shape[0]
    # 16-byte vector loads need 16-byte aligned stored rows (bf16 only).
    vec = (a.dtype == torch.bfloat16 and lda % 8 == 0 and ldb % 8 == 0
           and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)
    lib = _build.load("gemm")
    err = lib.gemm(a.data_ptr(), b.data_ptr(),
                   bias.data_ptr() if bias is not None else None, c.data_ptr(),
                   int(a.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
                   m, n, k, lda, ldb, int(trans_a), int(trans_b), ACT_CODES[activation], int(vec),
                   order.data_ptr() if order is not None else None, n_order,
                   torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "gemm")
    LAUNCHES += 1
    if trans_a or trans_b:
        TRANSPOSED_LAUNCHES += 1
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


def blocked_variant(dtype, bm, bk, bn) -> str:
    """Which variant of K11 runs: ``"wmma"`` (bf16 with bm, bn, bk multiples
    of 16) or ``"simt"``; raises for a block K11 does not take."""
    if (dtype == torch.bfloat16 and bm % 16 == 0 and bn % 16 == 0 and bk % 16 == 0
            and (bm // 16) * (bn // 16) <= _WMMA_MAX_FRAGMENTS):
        return "wmma"
    if bm * bn > _SIMT_MAX_ELEMENTS or (bm + bn) * 16 * 4 > _SMEM_MAX:
        raise ValueError(f"brgemm_blocked takes output blocks of at most {_SIMT_MAX_ELEMENTS} "
                         f"elements in SIMT (or {_WMMA_MAX_FRAGMENTS} 16x16 fragments in bf16), "
                         f"got {bm}x{bn}")
    return "simt"


def brgemm_blocked(a, b, *, spec_string="bca", k_step=1, block_steps=None, out_dtype=None):
    """Paper Listing 1 on the GPU: A (Mb, Kb, bm, bk) × B (Nb, Kb, bk, bn) →
    C (Nb, Mb, bm, bn) in ``out_dtype`` (default ``a.dtype``), fp32
    accumulator; contiguous CUDA tensors of one dtype (fp32 or bf16).
    ``spec_string`` over a = K (``k_step`` blocks a visit), b = M, c = N
    sets the order of the output blocks; ``block_steps`` the multi-level
    blocking.  Raises on anything the kernel does not take."""
    global BLOCKED_LAUNCHES, BLOCKED_WMMA_LAUNCHES, BLOCKED_SIMT_LAUNCHES
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
    variant = blocked_variant(a.dtype, bm, bk, bn)
    c = torch.empty(nb, mb, bm, bn, dtype=out_dtype, device=a.device)
    if c.numel() == 0:
        return c
    order = _device_table(plan, lambda: plan.visit_order.contiguous(), a.device)
    vec = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    lib = _build.load("brgemm_blocked")
    err = lib.brgemm_blocked(a.data_ptr(), b.data_ptr(), c.data_ptr(), order.data_ptr(),
                             order.shape[0], int(a.dtype == torch.bfloat16),
                             int(out_dtype == torch.bfloat16), int(variant == "wmma"),
                             mb, kb, bm, bn, bk, k_step, int(vec),
                             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "brgemm_blocked")
    BLOCKED_LAUNCHES += 1
    if variant == "wmma":
        BLOCKED_WMMA_LAUNCHES += 1
    else:
        BLOCKED_SIMT_LAUNCHES += 1
    return c
