"""K10: the block-sparse product (paper §III-C, Block-SpMM), and K9: the
grouped per-row-tile expert product.

Replaces ``repro/kernels/block_spmm.py::block_spmm_pallas`` (line 72) and
``::grouped_matmul_pallas`` (line 137).  The CUDA source is
``csrc/block_spmm.cu``, whose header says what bounds each kernel on an
H100 and what its design does about it: for K10 in bf16 a wgmma kernel fed
by a TMA ring over a work list of 64-row blocks (``spmm_plan``: 128
columns of C and a run of block rows a CTA; a matrix pruned in 8x8 or
16x16 blocks is stored once as ``densify_to_bcsr(a, 64, bk)``, each block
the union of 8 or 4 pruned block rows at one column; two 8-deep items or
one 16-deep item a k16 step, ``paired_steps``), WMMA for bf16 blocks of 8
or 16 rows and for operands TMA cannot read, SIMT for fp32; for K9 in
bf16 the GEMM mainloop ``csrc/gemm_mainloop.cuh`` under a Policy that reads
each row tile's expert through tensor maps over x (d, rows, tiles) and w
(f, d, E) (``grouped_plan``: one 64-row chunk of a row tile by 128 columns a
CTA), K1's WMMA tile for bf16 operands TMA cannot read, SIMT for fp32.  The
plain versions are
``kernels.ref.block_spmm_ref`` and ``kernels.ref.grouped_matmul_ref``;
``kernels.ops.block_spmm`` and ``kernels.ops.grouped_matmul`` pick between
kernel and plain version by the device of the tensors.

``densify_to_bcsr`` builds the BCSR work list from a dense matrix on the
host, as the reference's helper of the same name does.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import _build

__all__ = ["densify_to_bcsr", "block_spmm", "grouped_matmul", "spmm_plan", "paired_steps",
           "grouped_plan", "SpmmPlan", "GroupedPlan", "WGMMA_ROWS", "SPMM_LAUNCHES",
           "SPMM_WGMMA_LAUNCHES", "SPMM_WMMA_LAUNCHES", "SPMM_SIMT_LAUNCHES", "SPMM_COUNTERS",
           "GROUPED_LAUNCHES", "GROUPED_WGMMA_LAUNCHES", "GROUPED_WMMA_LAUNCHES",
           "GROUPED_SIMT_LAUNCHES", "GROUPED_COUNTERS", "GROUPED_TILE", "BLOCK_SHAPES"]

# Launches of each CUDA kernel since import (or since a caller reset them),
# and K10's and K9's by variant.
SPMM_LAUNCHES = 0
SPMM_WGMMA_LAUNCHES = 0
SPMM_WMMA_LAUNCHES = 0
SPMM_SIMT_LAUNCHES = 0
GROUPED_LAUNCHES = 0
GROUPED_WGMMA_LAUNCHES = 0
GROUPED_WMMA_LAUNCHES = 0
GROUPED_SIMT_LAUNCHES = 0

WGMMA_ROWS = 64              # wgmma: rows of a block (csrc/block_spmm.cu spmm_wg::BM)
BLOCK_SHAPES = ((8, 8), (16, 16), (WGMMA_ROWS, 8), (WGMMA_ROWS, 16))   # K10's (bm, bk)
_DTYPES = (torch.float32, torch.bfloat16)
SPMM_VARIANTS = {"wgmma": 1, "wmma": 0, "simt": 0}
SPMM_COUNTERS = {"wgmma": "SPMM_WGMMA_LAUNCHES", "wmma": "SPMM_WMMA_LAUNCHES",
                 "simt": "SPMM_SIMT_LAUNCHES"}
_TILE_N = 128                # wgmma: columns of C a CTA (spmm_wg::BN)
_TARGET_CTAS = 4 * 132       # wgmma: about four CTAs on each of the H100's SMs
GROUPED_VARIANTS = {"wgmma": 1, "wmma": 0, "simt": 0}
GROUPED_COUNTERS = {"wgmma": "GROUPED_WGMMA_LAUNCHES", "wmma": "GROUPED_WMMA_LAUNCHES",
                    "simt": "GROUPED_SIMT_LAUNCHES"}
# K9's wgmma tile: columns of out a CTA and TMA ring stages (csrc/block_spmm.cu
# grouped_wg::Cfg, which grouped_matmul checks against the library once); a
# CTA computes 64 rows of a row tile (one consumer warpgroup).
GROUPED_TILE = (128, 4)
_GROUPED_ROWS = 64


class SpmmPlan(NamedTuple):
    """How K10 runs one call: ``variant`` (wgmma, wmma or simt); for wgmma
    ``rows_per_cta`` block rows a CTA walks, and its ``grid`` (runs of block
    rows, 128-column tiles of C)."""
    variant: str
    rows_per_cta: int
    grid: tuple


def spmm_plan(nrows: int, n: int, dtype, aligned: bool = True, nnzb: int = 1,
              bm: int = WGMMA_ROWS) -> SpmmPlan:
    """K10's plan for ``nrows`` block rows of ``bm`` rows times an N =
    ``n`` wide B of ``dtype``: fp32 → ``simt``; bf16 → ``wgmma`` for
    64-row blocks where TMA reads B and the blocks where they lie
    (``aligned``: 16-byte aligned bases and B's row stride) and there is an
    item (``nnzb`` > 0), else ``wmma``.  The grid holds every 128-column
    tile of C by runs of consecutive block rows, sized so that about
    ``_TARGET_CTAS`` CTAs share the card; each CTA walks its run through one
    ring, so a short block row costs no launch of its own."""
    cols = -(-n // _TILE_N)
    if dtype != torch.bfloat16:
        return SpmmPlan("simt", 1, (nrows, cols))
    if bm != WGMMA_ROWS or not aligned or nnzb < 1:
        return SpmmPlan("wmma", 1, (nrows, cols))
    runs = max(1, min(nrows, _TARGET_CTAS // cols))
    per = -(-nrows // runs)
    return SpmmPlan("wgmma", per, (-(-nrows // per), cols))


class GroupedPlan(NamedTuple):
    """How K9 runs one call: ``variant`` (wgmma, wmma or simt), its
    ``grid``, and for wgmma the (bn, stages) ``tile`` and the extents of
    the tensor maps the kernel reads x and w through, innermost first:
    ``x_map`` (d, rows, tiles), so a tile's rows past its end read as
    zeros, and ``w_map`` (f, d, E), each expert's slab where it lies."""
    variant: str
    grid: tuple
    tile: tuple = ()
    x_map: tuple = ()
    w_map: tuple = ()


def grouped_plan(tiles: int, rows: int, d: int, f: int, e: int, dtype,
                 aligned: bool = True) -> GroupedPlan:
    """K9's plan for x (tiles·rows, d) and w (e, d, f) of ``dtype``: fp32 →
    ``simt`` (64 x 64 blocks); bf16 → ``wgmma`` where TMA reads both in
    place (``aligned``: 16-byte aligned bases; d and f multiples of 8, so
    every row stride is a multiple of 16 bytes), a grid of (column tiles of
    ``GROUPED_TILE[0]``, 64-row chunks of a row tile, row tiles): the
    column tiles of one row tile run together and share its x chunk, sorted
    adjacent row tiles share their expert's slab through L2; else ``wmma``
    (64 x 128 blocks).  Never names a variant because a launch failed."""
    chunks = -(-rows // _GROUPED_ROWS)
    if dtype != torch.bfloat16:
        return GroupedPlan("simt", (-(-f // 64), tiles, chunks))
    if not aligned or d % 8 or f % 8:
        return GroupedPlan("wmma", (-(-f // 128), tiles, chunks))
    bn = GROUPED_TILE[0]
    return GroupedPlan("wgmma", (-(-f // bn), chunks, tiles), GROUPED_TILE, (d, rows, tiles),
                       (f, d, e))


def paired_steps(row_ptr, bk: int) -> list[list[tuple[int, int]]]:
    """The k16 steps the wgmma variant takes for each block row of a
    row-sorted work list (``row_ptr``: the first item of each block row, and
    the end): a 16-deep item alone (its second slot -1), two consecutive
    8-deep items of one block row together, an odd last item with -1 (a
    zero block against zero rows of B).  A block row without items has no
    step and comes out zero."""
    ptr = [int(x) for x in row_ptr]
    per = 2 if bk == 8 else 1
    out = []
    for beg, end in zip(ptr[:-1], ptr[1:]):
        steps = []
        for t in range(beg, end, per):
            steps.append((t, t + 1 if per == 2 and t + 1 < end else -1))
        out.append(steps)
    return out


def densify_to_bcsr(a, bm: int, bk: int, *, pad_empty_rows: bool = True, device="cuda"):
    """A dense (M, K) matrix (numpy array or tensor) → its BCSR work list
    ``(blocks (nnzb, bm, bk), row_id (nnzb,), col_id (nnzb,))``, sorted
    row-major, with one all-zero block at column 0 for every block row
    without a nonzero block when ``pad_empty_rows``.  Works in numpy on the
    host; returns tensors on ``device`` (CUDA unless given), the blocks in
    the input's dtype, the ids int32."""
    dtype = a.dtype if isinstance(a, torch.Tensor) else None
    arr = a.detach().float().cpu().numpy() if dtype is not None else np.asarray(a)
    m, k = arr.shape
    if m % bm or k % bk:
        raise ValueError(f"densify_to_bcsr: ({m}, {k}) is not a whole number of {bm}x{bk} blocks")
    nr, nc = m // bm, k // bk
    tiles = arr.reshape(nr, bm, nc, bk).transpose(0, 2, 1, 3)
    nz = np.abs(tiles).sum(axis=(2, 3)) != 0
    if pad_empty_rows:
        nz[~nz.any(axis=1), 0] = True        # the dummy block: column 0, all zeros
    rows, cols = np.nonzero(nz)              # row-major order
    blocks = np.ascontiguousarray(tiles[rows, cols])
    dev = resolve_device(device)
    out = torch.from_numpy(blocks).to(dev)
    return (out.to(dtype) if dtype is not None else out,
            torch.from_numpy(rows.astype(np.int32)).to(dev),
            torch.from_numpy(cols.astype(np.int32)).to(dev))


def _check_cuda(name, *tensors):
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{name} needs CUDA tensors, got {[str(t.device) for t in tensors]}")


def _dtype_code(name, dtype, out_dtype):
    if dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"{name} dtypes {dtype} -> {out_dtype}: need {_DTYPES}")
    return int(dtype == torch.bfloat16), int(out_dtype == torch.bfloat16)


def _ids(name, t, n):
    if t.shape != (n,) or t.dtype != torch.int32:
        raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, want ({n},) int32")
    return t.contiguous()


def block_spmm(blocks, row_id, col_id, b, *, nrows_b, out_dtype=None):
    """C = A_sparse @ B on the GPU.  ``blocks`` (nnzb, bm, bk) of one of
    ``BLOCK_SHAPES`` (64-row blocks run on wgmma in bf16:
    ``densify_to_bcsr(a, 64, bk)`` of a matrix pruned in bk x bk blocks);
    ``row_id``/``col_id`` (nnzb,) int32, sorted row-major as
    ``densify_to_bcsr`` gives them; ``b`` (K, N) of the blocks' dtype (fp32
    or bf16), row-major or a transposed view (read in place), K a multiple
    of bk; → (nrows_b·bm, N) in ``out_dtype`` (default ``b.dtype``).  A
    block row without items comes out zero.  The variant is ``spmm_plan``'s.
    Raises on anything the kernel does not take."""
    global SPMM_LAUNCHES
    _check_cuda("block_spmm", blocks, row_id, col_id, b)
    if blocks.dim() != 3 or b.dim() != 2:
        raise ValueError(f"block_spmm blocks {tuple(blocks.shape)}, b {tuple(b.shape)}")
    nnzb, bm, bk = blocks.shape
    k, n = b.shape
    if (bm, bk) not in BLOCK_SHAPES:
        raise ValueError(f"block_spmm {bm}x{bk} blocks: need one of {BLOCK_SHAPES}")
    if k % bk:
        raise ValueError(f"block_spmm: K {k} is not a multiple of bk {bk}")
    if blocks.dtype != b.dtype:
        raise ValueError(f"block_spmm dtypes: blocks {blocks.dtype}, b {b.dtype}")
    out_dtype = out_dtype or b.dtype
    codes = _dtype_code("block_spmm", b.dtype, out_dtype)
    row_id, col_id = _ids("block_spmm row_id", row_id, nnzb), _ids("block_spmm col_id", col_id, nnzb)
    if not blocks.is_contiguous():
        raise ValueError("block_spmm: blocks must be contiguous")
    if b.stride(1) == 1 and (k <= 1 or b.stride(0) >= n):
        trans, ldb = False, max(b.stride(0), 1)
    elif b.stride(0) == 1 and b.stride(1) >= k:
        trans, ldb = True, b.stride(1)
    else:
        raise ValueError(f"block_spmm: b strides {b.stride()}: need rows or columns of unit stride")
    c = torch.empty(nrows_b * bm, n, dtype=out_dtype, device=b.device)
    if c.numel() == 0:
        return c
    # the first item of every block row (index bookkeeping, not the product)
    row_ptr = torch.searchsorted(
        row_id, torch.arange(nrows_b + 1, dtype=torch.int32, device=b.device), out_int32=True)
    vec = ldb % 8 == 0 and b.data_ptr() % 16 == 0
    stored_rows = n if trans else k
    aligned = (b.data_ptr() % 16 == 0 and blocks.data_ptr() % 16 == 0
               and (stored_rows <= 1 or ldb * b.element_size() % 16 == 0))
    plan = spmm_plan(nrows_b, n, b.dtype, aligned, nnzb, bm)
    # wgmma's scratch: for B stored (N, K) against 8-deep items the (K, N)
    # copy the kernel writes (bf16)
    workspace = None
    if plan.variant == "wgmma" and trans and bk == 8:
        workspace = torch.empty(k, -(-n // 8) * 8, dtype=torch.bfloat16, device=b.device)
    lib = _build.load("block_spmm")
    err = lib.block_spmm(blocks.data_ptr(), row_ptr.data_ptr(), col_id.data_ptr(), b.data_ptr(),
                         c.data_ptr(), *codes, nrows_b, bm, bk, n, k, ldb, int(trans), int(vec),
                         SPMM_VARIANTS[plan.variant], nnzb, plan.rows_per_cta,
                         workspace.data_ptr() if workspace is not None else None,
                         torch.cuda.current_stream(b.device).cuda_stream)
    _build.check(err, "block_spmm")
    SPMM_LAUNCHES += 1
    globals()[SPMM_COUNTERS[plan.variant]] += 1
    return c


@functools.lru_cache(maxsize=1)
def _grouped_library():
    """K9's library, once its wgmma tile is checked to be
    :data:`GROUPED_TILE` (the plan's)."""
    lib = _build.load("block_spmm")
    tile = (ctypes.c_int * 2)()
    lib.grouped_tile(tile)
    if tuple(tile) != GROUPED_TILE:
        raise RuntimeError(f"csrc/block_spmm.cu's K9 tile is {tuple(tile)}, grouped_plan's"
                           f" {GROUPED_TILE}")
    return lib


def grouped_matmul(x, group_id, w, *, out_dtype=None):
    """Per-row-tile expert product on the GPU: x (T, d) in ``len(group_id)``
    row tiles of T / len(group_id) rows, ``group_id`` (tiles,) int32 the
    expert of each tile (clamped into [0, E)), w (E, d, f) of x's dtype
    (fp32 or bf16), both contiguous; → (T, f) in ``out_dtype`` (default
    ``x.dtype``), on the variant ``grouped_plan`` names.  Raises on
    anything the kernel does not take."""
    global GROUPED_LAUNCHES
    _check_cuda("grouped_matmul", x, group_id, w)
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"grouped_matmul x {tuple(x.shape)}, w {tuple(w.shape)}")
    tiles = group_id.shape[0] if group_id.dim() == 1 else 0
    if tiles == 0 or x.shape[0] % tiles:
        raise ValueError(f"grouped_matmul: {x.shape[0]} rows in {tuple(group_id.shape)} tiles")
    group_id = _ids("grouped_matmul group_id", group_id, tiles)
    if w.dtype != x.dtype:
        raise ValueError(f"grouped_matmul dtypes: x {x.dtype}, w {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("grouped_matmul: x and w must be contiguous")
    out_dtype = out_dtype or x.dtype
    codes = _dtype_code("grouped_matmul", x.dtype, out_dtype)
    t, d = x.shape
    e, _, f = w.shape
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    plan = grouped_plan(tiles, t // tiles, d, f, e, x.dtype, aligned)
    out = torch.empty(t, f, dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = _grouped_library().grouped_matmul(
        x.data_ptr(), group_id.data_ptr(), w.data_ptr(), out.data_ptr(), *codes, tiles,
        t // tiles, e, d, f, GROUPED_VARIANTS[plan.variant],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "grouped_matmul")
    GROUPED_LAUNCHES += 1
    globals()[GROUPED_COUNTERS[plan.variant]] += 1
    return out
