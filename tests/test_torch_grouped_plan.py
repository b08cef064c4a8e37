"""K9's launch plan on the CPU (no GPU, no nvcc needed).

``block_spmm.grouped_plan`` names the variant ``grouped_matmul`` launches:
``wgmma`` (the GEMM mainloop of ``csrc/gemm_mainloop.cuh`` under K9's
Policy) for bf16 operands TMA reads in place, ``wmma`` for other bf16
operands, ``simt`` for fp32; for wgmma it gives the grid and the extents of
the tensor maps the kernel reads x and w through.  ``emulate_wgmma`` below
walks that grid and reads those maps box by box as the kernel's producer
does (zeros past every extent, the expert id clamped), summing 64-deep
steps in fp32; it is held against the reference's
``grouped_matmul_pallas`` in interpret mode and the port's plain
``grouped_matmul_ref`` at ``tests/test_kernels.py``'s tolerances: fp32
rtol 1e-4 / atol 1e-3, bf16 rtol 2e-2 / atol 2e-1.

K9's backward the same way: ``grouped_bwd_plan``'s variants, grids and
tensor-map extents, and ``emulate_dx`` / ``emulate_dw`` walking the wgmma
kernels' grids box by box (dX as its transpose w[g] dY^T: 256 rows of d
by 160 rows of a row tile a CTA, reading w's slab K-major through (f, d,
E) and dY through (f, rows, tiles); dW: the persistent
grid's CTAs walking their units as ``dw_units`` says, each unit
walking its expert's tiles in tile order as ``DwCoords`` does, 64 rows of
a tile a k-step) against ``grouped_matmul_dx_ref`` and
``grouped_matmul_dw_ref``: tiles of one expert apart, an expert without a
tile, rows 1, 8 and 100 a tile.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_spmm import grouped_matmul_pallas
from repro_torch.kernels import block_spmm as tspmm
from repro_torch.kernels import ref as tref

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-3), torch.bfloat16: dict(rtol=2e-2, atol=2e-1)}
BK = 64          # k elements a ring stage (csrc/gemm_mainloop.cuh gemm_ml::BK)
ROWS = 64        # rows of a row tile a CTA
SMS = 132        # an H100's streaming multiprocessors (dW's persistent grid)


def _box(m, r0, c0, nr, nc):
    """The (nr, nc) box of the 2-D ``m`` at (r0, c0), zeros past its extents."""
    out = torch.zeros(nr, nc)
    part = m[r0:r0 + nr, c0:c0 + nc]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def emulate_wgmma(x, group_id, w, plan):
    """The wgmma variant on the CPU: for each CTA (column tile n, 64-row
    chunk c, row tile t) of ``plan.grid``, k-step it reads A's box at (d
    it·64, row c·64, tile t) of x's map (d, rows, tiles) and B's at (f n·bn,
    d it·64, expert g) of w's map (f, d, E), g = group_id[t] clamped; the
    epilogue stores the rows below ``rows`` and the columns below f.  Every
    output element must be stored exactly once."""
    d, rows, tiles = plan.x_map
    f, _, e = plan.w_map
    bn = plan.tile[0]
    xm = x.float().reshape(tiles, rows, d)
    out = torch.full((tiles * rows, f), float("nan"))
    written = torch.zeros(tiles * rows, f, dtype=torch.int32)
    nx, ny, nz = plan.grid
    for n in range(nx):
        for c in range(ny):
            for t in range(nz):
                g = min(max(int(group_id[t]), 0), e - 1)
                acc = torch.zeros(ROWS, bn)
                for it in range(-(-d // BK)):
                    acc += _box(xm[t], c * ROWS, it * BK, ROWS, BK) @ \
                        _box(w[g].float(), it * BK, n * bn, BK, bn)
                r = min(ROWS, rows - c * ROWS)
                cols = min(bn, f - n * bn)
                at = slice(t * rows + c * ROWS, t * rows + c * ROWS + r)
                out[at, n * bn:n * bn + cols] = acc[:r, :cols]
                written[at, n * bn:n * bn + cols] += 1
    assert bool((written == 1).all()), "an output element stored other than once"
    return out


def _operands(rng, t, d, f, e, bm, dtype):
    x = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32)).to(dtype)
    gid = torch.from_numpy(np.sort(rng.integers(0, e, t // bm)).astype(np.int32))
    return x, w, gid


@pytest.mark.parametrize("dtype, d, f, aligned, variant", [
    (torch.bfloat16, 4096, 1536, True, "wgmma"),
    (torch.bfloat16, 64, 136, True, "wgmma"),
    (torch.bfloat16, 64, 100, True, "wmma"),       # f % 8 != 0: w's rows not 16-byte apart
    (torch.bfloat16, 100, 128, True, "wmma"),      # d % 8 != 0: x's rows not 16-byte apart
    (torch.bfloat16, 64, 128, False, "wmma"),      # a base off 16 bytes
    (torch.float32, 64, 128, True, "simt"),
    (torch.float32, 64, 100, False, "simt"),
])
def test_the_variant_follows_dtype_and_alignment(dtype, d, f, aligned, variant):
    plan = tspmm.grouped_plan(4, 64, d, f, 8, dtype, aligned)
    assert plan.variant == variant
    if variant == "wgmma":
        assert plan.tile == tspmm.GROUPED_TILE
    else:   # the previous kernels' grids: (column tiles, row tiles, 64-row chunks)
        assert plan.grid == (-(-f // (128 if variant == "wmma" else 64)), 4, 1)
        assert plan.tile == plan.x_map == plan.w_map == ()


@pytest.mark.parametrize("rows", [64, 100, 8])
def test_the_tensor_maps_extents(rows):
    tiles, d, f, e = 3, 72, 200, 5
    plan = tspmm.grouped_plan(tiles, rows, d, f, e, torch.bfloat16)
    bn = tspmm.GROUPED_TILE[0]
    assert plan.variant == "wgmma"
    # x by rows within a tile: a box past the tile's last row reads zeros,
    # never the next tile's rows
    assert plan.x_map == (d, rows, tiles)
    assert plan.w_map == (f, d, e)
    assert plan.grid == (-(-f // bn), -(-rows // ROWS), tiles)


def test_the_qwen3_moe_row_runs_on_wgmma():
    plan = tspmm.grouped_plan(64, 64, 4096, 1536, 128, torch.bfloat16)
    assert plan.variant == "wgmma"
    bn, stages = tspmm.GROUPED_TILE
    assert plan.grid == (1536 // bn, 1, 64) and bn % 64 == 0 and stages >= 2


def test_the_plan_tile_is_the_source_tile():
    """GROUPED_TILE mirrors the wgmma kernel's Config (checked again against
    the library on the card)."""
    src = (Path(tspmm.__file__).resolve().parent / "csrc" / "block_spmm.cu").read_text()
    tiles = re.findall(r"namespace grouped_wg \{\nusing Cfg = gemm_ml::Config<1, (\d+), (\d+),", src)
    assert [tuple(map(int, t)) for t in tiles] == [tspmm.GROUPED_TILE]


def test_every_variant_has_a_counter():
    assert set(tspmm.GROUPED_COUNTERS) == set(tspmm.GROUPED_VARIANTS) == {"wgmma", "wmma", "simt"}
    for counter in tspmm.GROUPED_COUNTERS.values():
        assert isinstance(getattr(tspmm, counter), int)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows, d, f", [(64, 128, 256), (100, 72, 136), (8, 64, 200)])
def test_the_wgmma_addressing_matches_pallas_and_the_plain_version(rows, d, f, dtype):
    rng = np.random.default_rng(rows + d)
    tiles, e = 3, 4
    x, w, gid = _operands(rng, tiles * rows, d, f, e, rows, dtype)
    plan = tspmm.grouped_plan(tiles, rows, d, f, e, torch.bfloat16)
    got = emulate_wgmma(x, gid, w, plan)
    plain = tref.grouped_matmul_ref(x, gid, w).float()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL[dtype])
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pallas = grouped_matmul_pallas(jnp.asarray(x.float().numpy(), jdt), jnp.asarray(gid.numpy()),
                                   jnp.asarray(w.float().numpy(), jdt), bf=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas, np.float32), **TOL[dtype])


def test_out_of_range_ids_are_clamped():
    rng = np.random.default_rng(3)
    tiles, rows, d, f, e = 4, 64, 64, 128, 4
    x, w, _ = _operands(rng, tiles * rows, d, f, e, rows, torch.float32)
    gid = torch.tensor([-3, 0, 4, 100], dtype=torch.int32)
    got = emulate_wgmma(x, gid, w, tspmm.grouped_plan(tiles, rows, d, f, e, torch.bfloat16))
    want = tref.grouped_matmul_ref(x, gid.clamp(0, e - 1), w)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL[torch.float32])


# ---------------------------------------------------------------------------
# K9's backward
# ---------------------------------------------------------------------------

def _clamp(g, e):
    return min(max(int(g), 0), e - 1)


def emulate_dx(dy, group_id, w, plan):
    """dX's wgmma variant on the CPU, the transpose dX_t^T = w[g] dY_t^T:
    for each CTA (tile m of bm rows of d, part p of bn rows of row tile t,
    row tile t) of ``plan.grid``, k-step it reads A's box at (f it·64, d
    m·bm, expert g) of w's map (f, d, E) and B's at (f it·64, row p·bn,
    tile t) of dY's map (f, rows, tiles), K-major both (zeros past every
    extent); the epilogue stores the transpose, rows of the tile below
    ``rows`` and columns below d, each element once."""
    f, d, e = plan.a_map
    _, rows, tiles = plan.b_map
    bm, bn, _ = plan.tile
    ym = dy.float().reshape(tiles, rows, f)
    out = torch.full((tiles * rows, d), float("nan"))
    written = torch.zeros(tiles * rows, d, dtype=torch.int32)
    nx, ny, nz = plan.grid
    for m in range(nx):
        for p in range(ny):
            for t in range(nz):
                g = _clamp(group_id[t], e)
                acc = torch.zeros(bm, bn)
                for it in range(-(-f // BK)):
                    acc += _box(w[g].float(), m * bm, it * BK, bm, BK) @ \
                        _box(ym[t], p * bn, it * BK, bn, BK).T
                r = min(bn, rows - p * bn)
                cols = min(bm, d - m * bm)
                at = slice(t * rows + p * bn, t * rows + p * bn + r)
                out[at, m * bm:m * bm + cols] = acc[:cols, :r].T
                written[at, m * bm:m * bm + cols] += 1
    assert bool((written == 1).all()), "an output element stored other than once"
    return out


def dw_walk(group_id, e, expert, kpt):
    """The (tile, 64-row step) of each k-step of expert ``expert``'s CTAs,
    as ``DwCoords`` walks them: the expert's tiles (ids clamped) in tile
    order, ``kpt`` steps a tile; the count of k-steps is
    ``owned_tiles · kpt``."""
    owned = sum(_clamp(g, e) == expert for g in group_id)
    tile, out = -1, []
    for it in range(owned * kpt):
        s = it % kpt
        if s == 0:
            tile += 1
            while _clamp(group_id[tile], e) != expert:
                tile += 1
        out.append((tile, s))
    return out


def dw_units(units, ctas, cta):
    """The (expert, tile of d, tile of f) units that CTA ``cta`` of dW's
    persistent grid of ``ctas`` walks, in its order, as
    ``grouped_matmul_dw_bf16_wgmma``'s loop and ``DwUnit`` do: units
    ``cta``, ``cta + ctas``, ... of ``units`` = (experts, tiles of d, tiles
    of f), numbered with f fastest and the expert slowest."""
    e, nd, nf = units
    return [(u // (nd * nf), u % (nd * nf) // nf, u % nf) for u in range(cta, e * nd * nf, ctas)]


def emulate_dw(x, group_id, dy, plan):
    """dW's wgmma variant on the CPU: each CTA of the persistent
    ``plan.grid`` walks its units (expert e, tile m of d, tile n of f) as
    ``dw_units`` says; for each, the k-steps of ``dw_walk``, each
    A's box at (d m·bm, row s·64, tile) of x's map (d, rows, tiles) and
    B's at (f n·bn, row s·64, tile) of dY's map (f, rows, tiles), MN-major
    both (zeros past a tile's rows), summed into one fp32 accumulator in
    that order; the unit's store drops what lies past d and f.  Every
    element of dW stored once."""
    d, rows, tiles = plan.a_map
    f = plan.b_map[0]
    bm, bn, _ = plan.tile
    ne = plan.units[0]
    xm = x.float().reshape(tiles, rows, d)
    ym = dy.float().reshape(tiles, rows, f)
    out = torch.full((ne, d, f), float("nan"))
    written = torch.zeros(ne, d, f, dtype=torch.int32)
    kpt = -(-rows // BK)
    (ctas,) = plan.grid
    for cta in range(ctas):
        for e, m, n in dw_units(plan.units, ctas, cta):
            acc = torch.zeros(bm, bn)
            for t, s in dw_walk(group_id, ne, e, kpt):
                acc += _box(xm[t], s * BK, m * bm, BK, bm).T @ \
                    _box(ym[t], s * BK, n * bn, BK, bn)
            r, cols = min(bm, d - m * bm), min(bn, f - n * bn)
            out[e, m * bm:m * bm + r, n * bn:n * bn + cols] = acc[:r, :cols]
            written[e, m * bm:m * bm + r, n * bn:n * bn + cols] += 1
    assert bool((written == 1).all()), "an output element stored other than once"
    return out


@pytest.mark.parametrize("kind", ["dx", "dw"])
@pytest.mark.parametrize("dtype, d, f, aligned, variant", [
    (torch.bfloat16, 4096, 1536, True, "wgmma"),
    (torch.bfloat16, 64, 136, True, "wgmma"),
    (torch.bfloat16, 64, 100, True, "wmma"),       # f % 8 != 0
    (torch.bfloat16, 100, 128, True, "wmma"),      # d % 8 != 0
    (torch.bfloat16, 64, 128, False, "wmma"),      # a base off 16 bytes
    (torch.float32, 64, 128, True, "simt"),
    (torch.float32, 64, 100, False, "simt"),
])
def test_the_backward_variant_follows_dtype_and_alignment(kind, dtype, d, f, aligned, variant):
    tiles, rows, e = 4, 100, 8
    plan = tspmm.grouped_bwd_plan(kind, tiles, rows, d, f, e, dtype, aligned, sms=SMS)
    assert (plan.kind, plan.variant) == (kind, variant)
    bn = 64 if variant == "simt" else 128
    if variant == "wgmma":
        assert plan.tile == (tspmm.GROUPED_DX_TILE if kind == "dx" else tspmm.GROUPED_DW_TILE)
    else:
        assert plan.tile == plan.a_map == plan.b_map == ()
        want = (-(-d // bn), tiles, 2) if kind == "dx" else (-(-f // bn), -(-d // 64), e)
        assert plan.grid == want


@pytest.mark.parametrize("rows", [1, 8, 100, 320])
def test_the_backward_tensor_maps_extents(rows):
    """dX (transposed) reads w (f, d, E) and dY (f, rows, tiles) K-major,
    the k-steps along f, a box of dY stopped at the tile's end; dW reads x
    (d, rows, tiles) and dY (f, rows, tiles) MN-major, the k-steps along a
    tile's rows, whose extent stops a box at the tile's end."""
    tiles, d, f, e = 3, 72, 200, 5
    dx = tspmm.grouped_bwd_plan("dx", tiles, rows, d, f, e, torch.bfloat16, sms=SMS)
    bm, bn, _ = tspmm.GROUPED_DX_TILE
    assert (dx.a_map, dx.b_map) == ((f, d, e), (f, rows, tiles))
    assert dx.grid == (-(-d // bm), -(-rows // bn), tiles)
    dw = tspmm.grouped_bwd_plan("dw", tiles, rows, d, f, e, torch.bfloat16, sms=SMS)
    bm, bn, _ = tspmm.GROUPED_DW_TILE
    assert (dw.a_map, dw.b_map) == ((d, rows, tiles), (f, rows, tiles))
    assert dw.units == (e, -(-d // bm), -(-f // bn))
    # a persistent grid: one CTA an SM, none without a unit
    assert dw.grid == (min(e * -(-d // bm) * -(-f // bn), SMS),)


def test_the_qwen3_moe_training_products_run_on_wgmma():
    """The training layer (128 tiles of cap 320): gate/up (d 4096 -> f 1536)
    and down (1536 -> 4096), dX and dW each on wgmma."""
    for d, f in ((4096, 1536), (1536, 4096)):
        for kind in ("dx", "dw"):
            plan = tspmm.grouped_bwd_plan(kind, 128, 320, d, f, 128, torch.bfloat16, sms=SMS)
            assert plan.variant == "wgmma"
    dx = tspmm.grouped_bwd_plan("dx", 128, 320, 4096, 1536, 128, torch.bfloat16, sms=SMS)
    bm, bn, _ = tspmm.GROUPED_DX_TILE
    # two CTAs over a 320-row tile, no row past its end
    assert dx.grid == (4096 // bm, 320 // bn, 128) == (16, 2, 128)
    dw = tspmm.grouped_bwd_plan("dw", 128, 320, 4096, 1536, 128, torch.bfloat16, sms=SMS)
    bm, bn, _ = tspmm.GROUPED_DW_TILE
    assert dw.units == (128, 4096 // bm, 1536 // bn) and dw.grid == (132,)
    assert tspmm.grouped_bwd_plan("dw", 128, 320, 4096, 1536, 128, torch.bfloat16,
                                  sms=114).grid == (114,)
    with pytest.raises(ValueError, match="kind"):
        tspmm.grouped_bwd_plan("dy", 1, 1, 8, 8, 1, torch.bfloat16, sms=SMS)
    with pytest.raises(TypeError, match="sms"):     # no card's SM count by default
        tspmm.grouped_bwd_plan("dw", 128, 320, 4096, 1536, 128, torch.bfloat16)


def test_the_backward_tiles_are_the_source_tiles():
    """GROUPED_DX_TILE and GROUPED_DW_TILE mirror grouped_bwd's configs (64
    rows a consumer warpgroup's m64 block, one block unless named),
    checked again against the library on the card; dX's 160 is one wgmma's
    n (m64n160k16), dW's 128 keeps m64n128k16, the instruction of a 128 x
    128 tile, and so its bits."""
    src = (Path(tspmm.__file__).resolve().parent / "csrc" / "block_spmm.cu").read_text()
    found = {}
    for name, a_mn, b_mn in (("Dx", "false", "false"), ("Dw", "true", "true")):
        m = re.findall(rf"using {name}Cfg = gemm_ml::Config<(\d+), (\d+), (\d+), {a_mn}, {b_mn}"
                       rf"(?:, (\d+))?>;", src)
        assert len(m) == 1, name
        wg, bn, stages, blocks = m[0]
        found[name] = (64 * int(wg) * int(blocks or 1), int(bn), int(stages))
    assert found == {"Dx": tspmm.GROUPED_DX_TILE, "Dw": tspmm.GROUPED_DW_TILE}


def test_every_backward_variant_has_a_counter():
    for kind in ("dx", "dw"):
        assert set(tspmm.GROUPED_BWD_COUNTERS[kind]) == set(tspmm.GROUPED_VARIANTS)
        for counter in tspmm.GROUPED_BWD_COUNTERS[kind].values():
            assert isinstance(getattr(tspmm, counter), int)
    assert isinstance(tspmm.GROUPED_BWD_LAUNCHES, int)


# group ids: one tile each; an expert's tiles apart (expert 2 at tiles 0
# and 2, expert 0 at 1 and 4); expert 0 and 2 without a tile; ids out of
# range (clamped into [0, E))
BWD_GROUPS = {"one-tile-each": [0, 1, 2, 3], "tiles-apart": [2, 0, 2, 1, 0],
              "experts-without-tile": [3, 3, 1], "clamped": [-2, 7, 1]}


@pytest.mark.parametrize("groups", list(BWD_GROUPS))
@pytest.mark.parametrize("rows, d, f", [(1, 64, 136), (8, 72, 128), (100, 136, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_backward_addressing_matches_the_plain_versions(groups, rows, d, f, dtype):
    rng = np.random.default_rng(rows + d + len(groups))
    e = 4
    gid = torch.tensor(BWD_GROUPS[groups], dtype=torch.int32)
    tiles = gid.shape[0]
    x = torch.from_numpy(rng.normal(size=(tiles * rows, d)).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rng.normal(size=(tiles * rows, f)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32)).to(dtype)
    clamped = gid.clamp(0, e - 1)
    plan = tspmm.grouped_bwd_plan("dx", tiles, rows, d, f, e, torch.bfloat16, sms=SMS)
    np.testing.assert_allclose(emulate_dx(dy, gid, w, plan).numpy(),
                               tref.grouped_matmul_dx_ref(dy, clamped, w).float().numpy(),
                               **TOL[dtype])
    plan = tspmm.grouped_bwd_plan("dw", tiles, rows, d, f, e, torch.bfloat16, sms=SMS)
    got = emulate_dw(x, gid, dy, plan)
    want = tref.grouped_matmul_dw_ref(x, clamped, dy, e)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL[dtype])
    for missing in set(range(e)) - set(clamped.tolist()):
        assert not got[missing].any() and not want[missing].any()


def test_the_dw_walk_sums_each_experts_tiles_in_tile_order():
    """``DwCoords``' walk: every tile of an expert, in ascending tile order,
    each tile's 64-row steps in order, none of another expert's; an expert
    without a tile takes no step.  So the fp32 sum over an expert's tiles
    has one order, whatever the grid's schedule."""
    gid = [2, 0, 2, -1, 9, 2]       # -1 → expert 0, 9 → expert 3
    assert dw_walk(gid, 4, 2, 2) == [(0, 0), (0, 1), (2, 0), (2, 1), (5, 0), (5, 1)]
    assert dw_walk(gid, 4, 0, 3) == [(1, 0), (1, 1), (1, 2), (3, 0), (3, 1), (3, 2)]
    assert dw_walk(gid, 4, 3, 1) == [(4, 0)]
    assert dw_walk(gid, 4, 1, 5) == []
    # the kernel's order, not another: the dW of expert 2 summed tile by tile
    rng = np.random.default_rng(1)
    rows, d, f = 100, 64, 128
    x = torch.from_numpy(rng.normal(size=(6 * rows, d)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(6 * rows, f)).astype(np.float32))
    plan = tspmm.grouped_bwd_plan("dw", 6, rows, d, f, 4, torch.bfloat16, sms=SMS)
    got = emulate_dw(x, gid, dy, plan)[2]
    bm, bn, _ = plan.tile
    acc = torch.zeros(bm, bn)
    for t in (0, 2, 5):
        for s in range(2):
            acc += _box(x[t * rows:(t + 1) * rows], s * BK, 0, BK, bm).T @ \
                _box(dy[t * rows:(t + 1) * rows], s * BK, 0, BK, bn)
    assert torch.equal(got, acc[:d, :f])


@pytest.mark.parametrize("ctas", [1, 3, 132])
def test_the_persistent_dw_visits_every_unit_once(ctas):
    """``dw_units``: the CTAs of dW's persistent grid together walk
    every (expert, tile of d, tile of f) exactly once, each CTA its units in
    ascending order, the expert slowest; no CTA more than one unit ahead of
    another."""
    bm, bn, _ = tspmm.GROUPED_DW_TILE
    plan = tspmm.grouped_bwd_plan("dw", 6, 64, 3 * bm, 4 * bn, 5, torch.bfloat16, sms=ctas)
    units = plan.units
    assert units == (5, 3, 4) and plan.grid == (min(ctas, 60),)
    walks = [dw_units(units, ctas, c) for c in range(ctas)]
    seen = [u for walk in walks for u in walk]
    every = [(e, m, n) for e in range(5) for m in range(3) for n in range(4)]
    assert sorted(seen) == every and len(seen) == len(every)
    for walk in walks:
        assert walk == sorted(walk)
    assert max(map(len, walks)) - min(map(len, walks)) <= 1


def test_the_persistent_dw_loop_is_dw_units():
    """``dw_units`` is what ``grouped_matmul_dw_bf16_wgmma`` runs: its
    producer and its consumers each stride units blockIdx.x, + gridDim.x,
    ... over E · nd · nf, and ``DwUnit`` splits unit u into (expert u /
    (nd·nf), tile of d r / nf, tile of f r % nf) of its remainder r."""
    src = (Path(tspmm.__file__).resolve().parent / "csrc" / "block_spmm.cu").read_text()
    kernel = src[src.index("grouped_matmul_dw_bf16_wgmma("):]
    kernel = kernel[:kernel.index("\n}\n")]
    assert re.search(r"nd = \(d \+ DwCfg::BM - 1\) / DwCfg::BM, "
                     r"nf = \(f \+ DwCfg::BN - 1\) / DwCfg::BN;", kernel)
    assert "const int units = E * nd * nf;" in kernel
    # the producer's loop and the consumers' loop
    loop = r"for \(int u = blockIdx\.x; u < units; u \+= gridDim\.x\) \{\s*const DwUnit at\(u, nd, nf\);"
    assert len(re.findall(loop, kernel)) == 2
    unit = src[src.index("struct DwUnit {"):]
    unit = unit[:unit.index("};")]
    for line in ("e = u / (nd * nf);", "const int r = u - e * nd * nf;",
                 "m0 = r / nf * DwCfg::BM;", "n0 = r % nf * DwCfg::BN;"):
        assert line in unit, line
    # the same split as dw_units' at every unit of a grid with several tiles each way
    nd, nf, ctas = 3, 4, 7
    for c in range(ctas):
        kernel_order = []
        for u in range(c, 5 * nd * nf, ctas):
            e = u // (nd * nf)
            r = u - e * nd * nf
            kernel_order.append((e, r // nf, r % nf))
        assert dw_units((5, nd, nf), ctas, c) == kernel_order


def test_each_persistent_unit_sums_in_tile_order():
    """Under the persistent walk (3 CTAs, more units than CTAs) each unit's
    sum is still ``DwCoords``' walk: the expert's tiles in tile order, each
    tile's 64-row steps in order, summed into one accumulator, so a unit's
    bits do not depend on which CTA takes it or what it took before; an
    expert without a tile is zeros."""
    gid = [2, 0, 2, -1, 9, 2]       # -1 → expert 0, 9 → expert 3; expert 1 owns none
    bm, bn, _ = tspmm.GROUPED_DW_TILE
    rows, d, f, e = 100, 2 * bm - 8, 3 * bn - 8, 4
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(6 * rows, d)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(6 * rows, f)).astype(np.float32))
    plan = tspmm.grouped_bwd_plan("dw", 6, rows, d, f, e, torch.bfloat16, sms=3)
    assert plan.grid == (3,) and plan.units == (4, 2, 3)
    got = emulate_dw(x, gid, dy, plan)
    for expert, tiles in ((2, (0, 2, 5)), (0, (1, 3)), (3, (4,))):
        for m in range(2):
            for n in range(3):
                acc = torch.zeros(bm, bn)
                for t in tiles:
                    for s in range(2):
                        acc += _box(x[t * rows:(t + 1) * rows], s * BK, m * bm, BK, bm).T @ \
                            _box(dy[t * rows:(t + 1) * rows], s * BK, n * bn, BK, bn)
                want = acc[:min(bm, d - m * bm), :min(bn, f - n * bn)]
                assert torch.equal(got[expert, m * bm:(m + 1) * bm, n * bn:(n + 1) * bn], want)
    assert not got[1].any()
