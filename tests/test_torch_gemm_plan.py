"""K1's and K11's launch plans on the Hopper GEMM mainloop, on the CPU.

``brgemm.gemm_variant`` and ``variant_of`` (which kernel a product runs on,
from the dtype, M and the operands' layout alone), ``decode_splits`` (the
split-K of the decode weight stream: from (K, N), never M, filling the
card's 132 SMs about twice), ``cta_tile`` and the order table over the new
tiles under the spec strings ``chip_smoke.py`` runs, and
``blocked_variant``.  The kernels themselves run only on the card
(``chip_smoke.py`` phase 3).
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import brgemm

BF16, F32 = torch.bfloat16, torch.float32
TRANSPOSITIONS = [(False, False), (True, False), (False, True), (True, True)]
# (K, N) of every projection of llama2-13b (d 5120, ff 13824, vocab 32000)
# and minicpm-2b (d 2304, ff 5760), decode and the tied logits
WIDTHS = [(5120, 5120), (5120, 13824), (13824, 5120), (5120, 32000),
          (2304, 2304), (2304, 5760), (5760, 2304), (2304, 122880)]


@pytest.mark.parametrize("ta,tb", TRANSPOSITIONS)
@pytest.mark.parametrize("m", [1, 3, 8, 15, 16, 17, 32, 2048])
def test_gemm_variant_by_dtype_rows_and_alignment(m, ta, tb):
    want = "wgmma_decode" if m <= 16 else "wgmma"
    assert brgemm.gemm_variant(m, 5120, 5120, BF16, ta, tb, True) == want
    assert brgemm.gemm_variant(m, 5120, 5120, BF16, ta, tb, False) == "wmma"
    assert brgemm.gemm_variant(m, 5120, 5120, F32, ta, tb, True) == "simt"
    assert brgemm.gemm_variant(m, 5120, 5120, F32, ta, tb, False) == "simt"


def _stored(rows, cols, dtype=BF16, *, ld=None, offset=0, transposed=False):
    """A (rows, cols) operand: row-major with row stride ``ld``, or (with
    ``transposed``) the transposed view of a stored (cols, rows) matrix;
    ``offset`` elements past an allocation's 16-byte aligned start."""
    srows, scols = (cols, rows) if transposed else (rows, cols)
    ld = ld or scols
    base = torch.zeros(offset + srows * ld, dtype=dtype)
    t = base[offset:].as_strided((srows, scols), (ld, 1))
    return t.T if transposed else t


@pytest.mark.parametrize("ta,tb", TRANSPOSITIONS)
@pytest.mark.parametrize("m", [4, 16, 17, 200])
def test_variant_of_reads_the_layout_in_place(m, ta, tb):
    k, n = 136, 520
    want = "wgmma_decode" if m <= 16 else "wgmma"
    inner = m if ta else k                     # A's stored row length
    ld = -(-inner // 8) * 8                    # rounded up to 16 bytes
    b = _stored(k, n, transposed=tb)
    a = _stored(m, k, ld=ld, transposed=ta)
    assert brgemm.variant_of(a, b) == want
    # a leading dimension 8 elements longer is still TMA-readable
    a = _stored(m, k, ld=ld + 8, transposed=ta)
    assert brgemm.variant_of(a, b) == want
    # an odd leading dimension, or a base 2 bytes off 16: wmma
    odd = _stored(m, k, ld=ld + 1, transposed=ta)
    assert brgemm.variant_of(odd, b) == "wmma"
    off = _stored(k, n, offset=1, transposed=tb)
    assert brgemm.variant_of(a, off) == "wmma"
    # a transposed A stored with M 4 or 17 as its row: 8 or 34 bytes a row
    if ta and inner % 8:
        assert brgemm.variant_of(_stored(m, k, transposed=True), b) == "wmma"
    assert brgemm.variant_of(a.float(), b.float()) == "simt"


def test_variant_of_ignores_the_stride_of_a_single_row():
    # one stored row: its row stride is never stepped
    a = _stored(1, 64, ld=77)
    assert brgemm.variant_of(a, _stored(64, 128)) == "wgmma_decode"
    assert brgemm.variant_of(_stored(48, 77), _stored(77, 64)) == "wmma"


@pytest.mark.parametrize("k,n", WIDTHS)
def test_decode_splits_fill_the_card_from_k_and_n_alone(k, n):
    splits, per = brgemm.decode_splits(k, n)
    steps = -(-k // 64)
    panels = -(-n // brgemm.DECODE_COLUMNS)
    # every split holds at least one step, and the parts cover K exactly
    assert 1 <= per and (splits - 1) * per < steps <= splits * per
    # the grid covers the 132 SMs, two CTAs each at most, unless the panels
    # alone fill it
    if panels < 132:
        assert 132 <= panels * splits <= 264
    else:
        assert splits == 1
    # rows M 1..16 decide nothing: the variant and its split are the same
    for m in range(1, 17):
        a, b = _stored(m, k), _stored(k, n)
        assert brgemm.variant_of(a, b) == "wgmma_decode"
        assert brgemm.decode_splits(k, n) == (splits, per)


def test_decode_splits_at_the_edges():
    assert brgemm.decode_splits(0, 5120) == (1, 1)
    assert brgemm.decode_splits(64, 128) == (1, 1)
    assert brgemm.decode_splits(100, 128) == (2, 1)      # two steps, one each
    assert brgemm.decode_splits(5120, 5120) == (6, 14)   # 40 panels, 240 CTAs


@pytest.mark.parametrize("variant,tile", [("wgmma", brgemm.WGMMA_TILE), ("wgmma_decode", (16, 128))])
def test_cta_tile_names_the_new_tiles(variant, tile):
    assert brgemm.cta_tile(2048 if variant == "wgmma" else 8, variant) == tile
    assert tile[1] % 64 == 0 and tile[0] in (16, 128)
    with pytest.raises(ValueError):
        brgemm.cta_tile(8, "tiles")


SPECS = [("bca", None), ("cba", None), ("BCa", None), ("bcba", {"b": (4,)}), ("bcaa", {"a": (4,)})]


@pytest.mark.parametrize("spec,steps", SPECS)
@pytest.mark.parametrize("m,k,n,tiles,variant", [
    (1024, 512, 1280, (128, 64, 128), "wgmma"),       # plan blocks = the CTA tiles
    (1024, 512, 1280, (64, 64, 64), "wgmma"),         # four plan blocks to a tile
    (1024, 512, 1280, (128, 64, 256), "wgmma"),       # a plan block of two tiles
    (2048, 512, 5120, (512, 64, 512), "wgmma"),       # pick_tiles' 512x512 blocks
    (16, 512, 512, (4, 64, 64), "wgmma_decode"),
    (8, 256, 640, (2, 64, 128), "wgmma_decode"),
])
def test_order_table_covers_every_new_tile_once(spec, steps, m, k, n, tiles, variant):
    plan = brgemm.schedule(m, k, n, BF16, spec, tiles, steps)
    cta = brgemm.cta_tile(m, variant)
    order = brgemm.cta_order(plan, m, n, cta).tolist()
    want = {(i, j) for i in range(0, m, cta[0]) for j in range(0, n, cta[1])}
    assert len(order) == len(want) and {tuple(o) for o in order} == want


def test_blocked_variant_takes_wgmma_blocks():
    for bm, bk, bn in ((64, 64, 64), (128, 64, 128), (64, 16, 16), (64, 128, 80)):
        assert brgemm.blocked_variant(BF16, bm, bk, bn) == "wgmma"
        assert brgemm.blocked_variant(BF16, bm, bk, bn, aligned=False) == "wmma"
    # 128x256 only on wgmma: too many fragments for WMMA, too many outputs for SIMT
    assert brgemm.blocked_variant(BF16, 128, 32, 256) == "wgmma"
    with pytest.raises(ValueError):
        brgemm.blocked_variant(BF16, 128, 32, 256, aligned=False)
    # other row counts, an N past 256, a K of 8: the WMMA and SIMT variants
    assert brgemm.blocked_variant(BF16, 32, 64, 64) == "wmma"
    assert brgemm.blocked_variant(BF16, 16, 16, 32) == "wmma"
    assert brgemm.blocked_variant(BF16, 192, 64, 64) == "wmma"
    assert brgemm.blocked_variant(BF16, 64, 8, 64) == "simt"
    assert brgemm.blocked_variant(BF16, 8, 16, 32) == "simt"
    assert brgemm.blocked_variant(F32, 64, 64, 64) == "simt"
    assert brgemm.blocked_variant(F32, 128, 64, 64) == "simt"
    with pytest.raises(ValueError):
        brgemm.blocked_variant(BF16, 64, 8, 272)


@pytest.mark.parametrize("spec,steps", SPECS)
def test_blocked_pairs_hold_every_block_once(spec, steps):
    """K11's wgmma CTAs take two blocks the order table lists one after the
    other in one block row: every block once, each pair in one row, the
    table's order kept."""
    plan = brgemm.blocked_schedule((8, 8, 64, 64), (6, 8, 64, 64), spec, 2, steps)
    visits = plan.visit_order.tolist()
    pairs = brgemm.blocked_pairs(visits).tolist()
    flat = []
    for n, m, n_hi in pairs:
        flat.append([n, m])
        if n_hi >= 0:
            flat.append([n_hi, m])
    assert flat == visits
    if spec == "bca":          # N innermost: every entry is a pair
        assert all(n_hi >= 0 for _, _, n_hi in pairs) and len(pairs) == len(visits) // 2
    if spec == "cba":          # M innermost: no two neighbours share a row
        assert all(n_hi == -1 for _, _, n_hi in pairs)


def test_matmul_refuses_a_variant_the_operands_do_not_allow():
    # the wrapper checks the device first: CPU tensors never reach a kernel
    with pytest.raises(ValueError, match="CUDA"):
        brgemm.matmul(_stored(4, 64), _stored(64, 64), variant="wgmma_decode")
    assert set(brgemm.VARIANTS) == {"wgmma", "wgmma_decode", "wmma", "simt"}
