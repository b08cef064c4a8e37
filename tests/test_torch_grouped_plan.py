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
