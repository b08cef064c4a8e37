"""K2's launch plan and key-tile spec on the CPU (no GPU, no nvcc needed).

``flash_attention.forward_plan`` is what the wrapper hands the CUDA entry
point, which refuses a plan it does not build: bf16 runs the tensor-core
kernel (wgmma, a TMA-fed K/V ring), fp32 the SIMT kernel, and a bf16
operand the TMA copies cannot read raises.  ``key_tile_range`` is the spec
of the key tiles both kernels visit (``key_tiles`` in
``csrc/flash_attention.cu``); it is held here against brute-force masks
built by the plain version's own ``_masked_scores``.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as tref


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_bf16_plans_the_wgmma_kernel_within_shared_memory(d):
    b, h, sq = 2, 5, 300
    q = _bf16(b, sq, h, d).transpose(1, 2)
    k = _bf16(b, 77, 1, d).transpose(1, 2)
    plan = fa.forward_plan(q, k, k)
    wg, bn, stages = fa.WGMMA_TILES[d]
    assert plan.variant == "wgmma"
    assert (plan.rows, plan.bn, plan.stages) == (64 * wg, bn, stages)
    assert plan.rows in (64, 128) and plan.stages >= 2
    # whole k16 steps over a tile's keys, a TMA box of at most 256 rows
    assert bn in (64, 128) and bn % 16 == 0
    ring = plan.stages * 2 * bn * d * 2
    assert plan.smem_bytes == (1024 + plan.rows * d * 2 + ring + 8 * (plan.stages + 1)
                               + 4 * plan.stages)
    assert plan.smem_bytes <= fa.SMEM_LIMIT == 232448
    assert plan.grid == (-(-sq // plan.rows), h, b)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_fp32_plans_the_simt_kernel(d):
    q = torch.zeros(1, 3, 40, d)
    plan = fa.forward_plan(q, q, q)
    assert (plan.variant, plan.rows, plan.bn, plan.stages) == ("simt", 32, 32, 1)
    assert plan.smem_bytes == 4 * (32 * (d + 1) * 2 + 32 * d + 32 * 33) <= fa.SMEM_LIMIT
    assert plan.grid == (2, 3, 1)


def test_fp32_needs_no_alignment():
    q = torch.zeros(2 * 40 * 3 * 16 + 1)[1:].view(2, 40, 3, 16).transpose(1, 2)
    assert fa.forward_plan(q, q, q).variant == "simt"


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_misaligned_base_pointer_raises(which):
    good = _bf16(2, 64, 4, 64).transpose(1, 2)
    bad = _bf16(2 * 64 * 4 * 64 + 1)[1:].view(2, 64, 4, 64).transpose(1, 2)  # 2 bytes off
    ops = {"q": good, "k": good, "v": good, which: bad}
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fa.forward_plan(ops["q"], ops["k"], ops["v"])


@pytest.mark.parametrize("which", ["q", "k"])
def test_misaligned_stride_raises(which):
    good = _bf16(2, 64, 4, 16).transpose(1, 2)
    bad = _bf16(2, 64, 4, 20)[..., :16].transpose(1, 2)   # head stride 40 bytes
    assert bad.data_ptr() % 16 == 0
    ops = {"q": good, "k": good, which: bad}
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fa.forward_plan(ops["q"], ops["k"], ops["k"])


def test_a_dimension_of_length_one_is_not_held_to_the_rule():
    q = _bf16(1, 1, 64, 20)[..., :16]                 # batch and head strides unused
    assert q.stride()[:2] == (1280, 1280) and q.stride(2) * 2 % 16 == 8
    with pytest.raises(ValueError):
        fa.forward_plan(q, q, q)                      # the sequence stride is stepped
    q1 = _bf16(1, 1, 1, 20)[..., :16]
    assert fa.forward_plan(q1, q1, q1).variant == "wgmma"


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("end", [1, 37, 300, 512])
def test_path_layouts_pass(end, d):
    """The layouts the model's blocks give K2 (``models/blocks.py``): q, k
    and v as transposed views of (B, S, H, D) projections (prefill,
    training), and k and v as slices ``[:, :, :end]`` of the dense cache
    (a prompt after a cache position)."""
    b, h, hk, smax = 2, 8, 2, 528
    q = _bf16(b, end, h, d).transpose(1, 2)
    kp = _bf16(b, end, hk, d).transpose(1, 2)
    cache = _bf16(b, hk, smax, d)
    for k in (kp, cache[:, :, :end]):
        plan = fa.forward_plan(q, k, k)
        assert plan.variant == "wgmma" and plan.grid[0] == -(-end // plan.rows)


def _live(sq, skv, causal, window):
    """(Sq, Skv) keep mask as the plain version builds it."""
    q = torch.zeros(1, 1, sq, 16)
    k = torch.zeros(1, 1, skv, 16)
    _, mask = tref._masked_scores(q, k, causal=causal, window=window, scale=None)
    return mask.numpy()


SIZES = (1, 24, 40, 64, 70, 128, 129, 200, 300)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24), (True, 100),
                                           (False, None), (False, 24), (False, 100)])
def test_key_tile_range_matches_brute_force_masks(causal, window):
    """Every live (row, key) pair of a CTA's rows lies in a visited tile,
    every skipped tile is wholly masked, and the range is tight (each
    visited tile holds a live pair): Sq < Skv, Sq > Skv (rows with no key),
    and Sq, Skv ragged against the tiles, at both K2 kernels' tiles."""
    for sq, skv in itertools.product(SIZES, SIZES):
        live = _live(sq, skv, causal, window)
        for rows, bn in ((32, 32), (64, 64), (64, 128), (128, 128)):
            ntiles = -(-skv // bn)
            for q0 in range(0, sq, rows):
                got = fa.key_tile_range(q0, rows, sq, skv, causal, window, bn)
                block = live[q0:q0 + rows]
                tile_live = [bool(block[:, t * bn:(t + 1) * bn].any()) for t in range(ntiles)]
                want = [t for t, on in enumerate(tile_live) if on]
                assert list(got) == want, (sq, skv, rows, bn, q0, list(got), want)


def test_key_tile_range_rows_with_no_key():
    """Sq 70 > Skv 40 under a causal mask: rows 0..29 sit at negative key
    positions and see nothing; a tile of only such rows visits no tile."""
    assert list(fa.key_tile_range(0, 16, 70, 40, True, None, 128)) == []
    assert list(fa.key_tile_range(0, 64, 70, 40, True, None, 128)) == [0]
    assert list(fa.key_tile_range(64, 64, 70, 40, True, None, 128)) == [0]
    live = _live(70, 40, True, None)
    assert not live[:30].any() and live[30:].any(axis=1).all()


def test_key_tile_range_rows_past_sq_and_empty_keys():
    assert list(fa.key_tile_range(128, 128, 100, 100, False, None, 128)) == []
    assert list(fa.key_tile_range(0, 128, 100, 0, False, None, 128)) == []
    assert list(fa.key_tile_range(0, 128, 300, 300, True, None, 128)) == [0]
    assert list(fa.key_tile_range(256, 128, 300, 300, True, None, 128)) == [0, 1, 2]
    assert list(fa.key_tile_range(256, 128, 300, 300, True, 24, 128)) == [1, 2]


def test_plans_of_the_main_shapes():
    """The three rows K2's speed is measured at (chip_smoke.py phase 3)."""
    for (b, h, s, d), grid in (((4, 40, 512, 128), (8, 40, 4)), ((4, 36, 1024, 64), (8, 36, 4)),
                               ((16, 16, 512, 64), (4, 16, 16))):
        q = _bf16(b, s, h, d).transpose(1, 2)
        plan = fa.forward_plan(q, q, q)
        assert plan.variant == "wgmma" and plan.grid == grid
        assert plan.smem_bytes == {128: 82976, 64: 83000}[d]
        assert np.prod(plan.grid) * plan.rows >= b * h * s
