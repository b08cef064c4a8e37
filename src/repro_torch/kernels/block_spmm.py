"""K10: the block-sparse product (paper §III-C, Block-SpMM), and K9: the
grouped per-row-tile expert product.

Replaces ``repro/kernels/block_spmm.py::block_spmm_pallas`` (line 72) and
``::grouped_matmul_pallas`` (line 137).  The CUDA source is
``csrc/block_spmm.cu``, whose header says what bounds each kernel on an
H100 and what its design does about it: one block per (block row, 128
columns) looping over that row's work items for K10, K1's mainloop on each
row tile's expert for K9.  The plain versions are
``kernels.ref.block_spmm_ref`` and ``kernels.ref.grouped_matmul_ref``;
``kernels.ops.block_spmm`` and ``kernels.ops.grouped_matmul`` pick between
kernel and plain version by the device of the tensors.

``densify_to_bcsr`` builds the BCSR work list from a dense matrix on the
host, as the reference's helper of the same name does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import _build

__all__ = ["densify_to_bcsr", "block_spmm", "grouped_matmul", "SPMM_LAUNCHES",
           "GROUPED_LAUNCHES", "BLOCK_SIZES"]

# Launches of each CUDA kernel since import (or since a caller reset them).
SPMM_LAUNCHES = 0
GROUPED_LAUNCHES = 0

BLOCK_SIZES = (8, 16)        # K10 has kernels for 8x8 and 16x16 blocks
_DTYPES = (torch.float32, torch.bfloat16)


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
    """C = A_sparse @ B on the GPU.  ``blocks`` (nnzb, bm, bk), 8x8 or
    16x16; ``row_id``/``col_id`` (nnzb,) int32, sorted row-major
    as ``densify_to_bcsr`` gives them; ``b`` (K, N) of the blocks' dtype
    (fp32 or bf16), row-major or a transposed view (read in place), K a
    multiple of bk; → (nrows_b·bm, N) in ``out_dtype`` (default ``b.dtype``).
    A block row without items comes out zero.  Raises on anything the
    kernel does not take."""
    global SPMM_LAUNCHES
    _check_cuda("block_spmm", blocks, row_id, col_id, b)
    if blocks.dim() != 3 or b.dim() != 2:
        raise ValueError(f"block_spmm blocks {tuple(blocks.shape)}, b {tuple(b.shape)}")
    nnzb, bm, bk = blocks.shape
    k, n = b.shape
    if bm != bk or bm not in BLOCK_SIZES:
        raise ValueError(f"block_spmm {bm}x{bk} blocks: need square blocks of {BLOCK_SIZES}")
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
    lib = _build.load("block_spmm")
    err = lib.block_spmm(blocks.data_ptr(), row_ptr.data_ptr(), col_id.data_ptr(), b.data_ptr(),
                         c.data_ptr(), *codes, nrows_b, bm, bk, n, k, ldb, int(trans), int(vec),
                         torch.cuda.current_stream(b.device).cuda_stream)
    _build.check(err, "block_spmm")
    SPMM_LAUNCHES += 1
    return c


def grouped_matmul(x, group_id, w, *, out_dtype=None):
    """Per-row-tile expert product on the GPU: x (T, d) in ``len(group_id)``
    row tiles of T / len(group_id) rows, ``group_id`` (tiles,) int32 the
    expert of each tile (clamped into [0, E)), w (E, d, f) of x's dtype
    (fp32 or bf16), both contiguous; → (T, f) in ``out_dtype`` (default
    ``x.dtype``).  Raises on anything the kernel does not take."""
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
    out = torch.empty(t, f, dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    vec = d % 8 == 0 and f % 8 == 0 and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    lib = _build.load("block_spmm")
    err = lib.grouped_matmul(x.data_ptr(), group_id.data_ptr(), w.data_ptr(), out.data_ptr(),
                             *codes, tiles, t // tiles, e, d, f, int(vec),
                             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "grouped_matmul")
    GROUPED_LAUNCHES += 1
    return out
