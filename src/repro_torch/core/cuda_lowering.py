"""Plan a PARLOOPER ``LoopNest`` for a CUDA kernel.

The planning half of ``repro/core/pallas_lowering.py``.  There a spec
string becomes a Pallas grid: character order is grid order (the last
dimension fastest), a repeated character adds grid dimensions over the same
loop, the innermost occurrence sets each operand's block shape, and an
uppercase letter marks its dimension PARALLEL.  A CUDA grid has no order:
its blocks run at once, on every SM.  What a spec string can still set on
the card is the order in which the blocks are rasterised, and so which
output blocks share the L2 cache at a time.  :func:`plan_cuda` keeps the
reference plan's grid, semantics and block shapes, and adds the **output
visit order**: the output blocks in the order the reference's grid first
visits them (``out_specs.index_map`` over the grid, row-major).  A kernel
takes that order as an int32 table and gives block i the i-th entry, so
the spec string sets the rasterisation; the reduction levels stay inside a
block, in nest order.  ``validate_reduction_innermost`` (``TPP102``) makes
sure every reduction level is below every output level, which that needs.

Mesh levels (``{axis:N}``) plan with their local trip counts, as in the
reference; a launch raises (``executor.require_no_mesh``) until distributed
execution is ported.  ``make_pallas_fn`` has no counterpart here: each
kernel's wrapper launches its own kernel with the plan.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis import footprint
from repro_torch.core.legality import LegalityError

__all__ = ["TensorMap", "CudaPlan", "plan_cuda", "validate_reduction_innermost"]


def validate_reduction_innermost(nest, out_letters, reduction_letters):
    """``TPP102``: output-block visits must be consecutive, so every in-grid
    reduction level must sit strictly below the deepest output-indexing
    level.  On the card one block owns an output block and walks its
    reduction inside."""
    footprint.enforce(
        footprint.check_reduction_innermost(nest, out_letters, reduction_letters),
        exc=LegalityError,
    )


@dataclasses.dataclass(frozen=True)
class TensorMap:
    """Binding of one operand to the logical loops.

    ``letters``: per *block-index* dimension, the loop letter that indexes
    it (``None`` = the whole dimension is visible to every body call).
    ``tile``: the trailing physical tile shape (the TPP base block, e.g.
    ``(bm, bk)``) for ``layout='blocked'``; the base block sizes of the
    corresponding flat dims for ``layout='flat'``.

    blocked layout: array shape = (*num_blocks_per_dim, *tile), the paper's
    ``A[Mb][Kb][bm][bk]``; flat layout: array shape = num_blocks * tile
    elementwise.
    """

    letters: tuple[Optional[str], ...]
    tile: tuple[int, ...]
    layout: str = "blocked"  # or "flat"

    def __post_init__(self):
        assert self.layout in ("blocked", "flat")
        assert len(self.letters) == len(self.tile)


@dataclasses.dataclass(frozen=True, eq=False)
class CudaPlan:
    """A nest planned for a kernel.  ``grid``, ``dimension_semantics`` and
    the block shapes are the reference plan's (``plan_pallas``);
    ``visit_order`` (V, len(out_map.letters)) int32 holds the output's block
    indices (in units of ``out_block``'s letter dims) in first-visit
    order.  Plans compare and hash by identity, so a cached plan keys the
    tables made from it."""

    nest: object
    grid: tuple[int, ...]
    dimension_semantics: tuple[str, ...]
    in_blocks: tuple[tuple[int, ...], ...]
    out_block: tuple[int, ...]
    visit_order: torch.Tensor
    sharded_reduction_axes: tuple[str, ...]


def _local_trip(lvl) -> int:
    return lvl.trip_count // lvl.ways if lvl.mesh_axis is not None else lvl.trip_count


def _block_shape(nest, tm: TensorMap):
    shape = []
    for letter, t in zip(tm.letters, tm.tile):
        nblocks = 1 if letter is None else nest.innermost_step(letter)
        shape.append(nblocks * t if tm.layout == "flat" else nblocks)
    if tm.layout == "blocked":
        shape.extend(tm.tile)
    return tuple(shape)


def _visit_order(nest, grid, letters) -> torch.Tensor:
    """The output's block indices in the order a row-major walk of ``grid``
    first reaches them.  A block's index depends only on the levels of its
    letters, and its first visit has every other level at 0, so the first
    visits are the row-major walk of those levels alone."""
    levels = nest.levels
    pos = [p for p, l in enumerate(levels) if l.letter in letters]
    sub = (np.indices(tuple(grid[p] for p in pos)).reshape(len(pos), -1) if pos
           else np.zeros((0, 1), dtype=np.int64))
    order = np.zeros((sub.shape[1], len(letters)), dtype=np.int64)
    for d, letter in enumerate(letters):
        if letter is None:
            continue
        inner = nest.innermost_step(letter)
        for i, p in enumerate(pos):
            if levels[p].letter == letter:
                order[:, d] += sub[i] * (levels[p].step // inner)
    return torch.from_numpy(order.astype(np.int32))


def plan_cuda(nest, in_maps: Sequence[TensorMap], out_map: TensorMap, *,
              reduction_letters: Sequence[str] = ()) -> CudaPlan:
    """The plan of ``nest`` for operands ``in_maps`` and output ``out_map``."""
    grid = tuple(_local_trip(l) for l in nest.levels)
    out_letters = {l for l in out_map.letters if l is not None}
    sem = tuple(
        "parallel" if (lvl.parallel and lvl.letter in out_letters) else "arbitrary"
        for lvl in nest.levels
    )
    return CudaPlan(
        nest=nest,
        grid=grid,
        dimension_semantics=sem,
        in_blocks=tuple(_block_shape(nest, tm) for tm in in_maps),
        out_block=_block_shape(nest, out_map),
        visit_order=_visit_order(nest, grid, out_map.letters),
        sharded_reduction_axes=tuple(
            l.mesh_axis for l in nest.mesh_levels if l.letter in reduction_letters),
    )
