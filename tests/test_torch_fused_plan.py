"""K5's and K10's launch plans on the Hopper GEMM mainloop, on the CPU (no
GPU, no nvcc needed).

K5 (``kernels/fused_gemm.py``): ``gemm_variant``, ``variant_of`` and
``gemm_plan`` name the variant a graph without a chained root runs from its
operands' dtypes, M and layout alone: ``wgmma`` (bf16, M > 16),
``wgmma_decode`` (bf16, M <= 16, K split from (K, N) and never from M),
``wgmma_split`` (fp32 lhs against bf16 rhs or the reverse), ``wmma`` (bf16
operands TMA cannot read) and ``simt`` (fp32).  ``cta_tile`` and
``order_table`` name the CTA tiles the C entry checks, and must cover every
tile once under any spec string.  ``split_bf16`` is the plain model of
wgmma_split's pre-pass: hi + lo times the exact bf16 operand, summed in
fp32, is held against an fp64 product at the fp32 tolerance (rtol 1e-4,
atol 1e-3), where hi alone misses it.  The ctypes ``_Args`` must list
``FusedArgs``'s fields in the header's order.

K10 (``kernels/block_spmm.py``): ``spmm_plan``'s variant and grid over
block rows, and ``paired_steps``' k16 steps (two 8-deep items, or one
16-deep item, a step; an odd last item against zeros; a block row without
items none) summed in fp32, held against the dense product of the work list
``densify_to_bcsr`` gives, itself the reference's work list: at the pruned
8x8 or 16x16 blocks, and at the 64-row blocks the wgmma variant takes (each
the union of 8 or 4 pruned block rows at one column).

The kernels themselves run only on the card (``chip_smoke.py`` phase 3).
"""
from __future__ import annotations

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import block_spmm as jspmm
from repro_torch import fusion as tf
from repro_torch.fusion import lowering as tlowering
from repro_torch.kernels import block_spmm as spmm
from repro_torch.kernels import brgemm, fused_gemm

BF16, F32 = torch.bfloat16, torch.float32
TRANSPOSITIONS = [(False, False), (True, False), (False, True), (True, True)]
CSRC = Path(fused_gemm.__file__).resolve().parent / "csrc"


def _graph(roots: int, lhs_trans=False, rhs_trans=False, panel=False):
    """``roots`` roots over one lhs, an add chain over them (or a row panel's
    rmsnorm of the first)."""
    Op, Root, Node = tf.OperandSpec, tf.ContractionRoot, tf.Node
    ops = [Op("x", "lhs", trans=lhs_trans)] + [Op(f"w{i}", "rhs", trans=rhs_trans)
                                               for i in range(roots)]
    rts = tuple(Root(f"r{i}", "x", f"w{i}") for i in range(roots))
    nodes, prev = (), "r0"
    for i in range(1, roots):
        nodes += (Node(f"n{i}", "add", (prev, f"r{i}")),)
        prev = f"n{i}"
    if panel:
        ops.append(Op("g", "rowvec"))
        nodes += (Node("norm", "rmsnorm", (prev, "g")),)
    return tf.simplify_graph(tf.TppGraph(f"g{roots}{int(panel)}", tuple(ops), roots=rts,
                                         nodes=nodes))


def _stored(rows, cols, dtype=BF16, *, ld=None, offset=0, transposed=False):
    """An operand read as (rows, cols): stored row-major with row stride
    ``ld``, or (``transposed``) as the stored (cols, rows) matrix; ``offset``
    elements past a 16-byte aligned allocation."""
    srows, scols = (cols, rows) if transposed else (rows, cols)
    ld = ld or scols
    base = torch.zeros(offset + srows * ld, dtype=dtype)
    return base[offset:].as_strided((srows, scols), (ld, 1))


def _operands(graph, m, k, n, dtype=BF16, rhs_dtype=None, **kw):
    ops = {}
    for spec in graph.operands:
        if spec.kind == "lhs":
            ops[spec.name] = _stored(m, k, dtype, transposed=spec.trans, **kw)
        elif spec.kind == "rhs":
            ops[spec.name] = _stored(k, n, rhs_dtype or dtype, transposed=spec.trans)
        elif spec.kind == "rowvec":
            ops[spec.name] = torch.zeros(n, dtype=F32)
    return ops


# ---------------------------------------------------------------------------
# K5: which variant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ta,tb", TRANSPOSITIONS)
@pytest.mark.parametrize("roots", [1, 2, 3])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 2048])
def test_variant_by_dtype_rows_and_layout(m, roots, ta, tb):
    g = _graph(roots, ta, tb)
    k, n = 256, 384
    want = "wgmma_decode" if m <= 16 else "wgmma"
    aligned = _operands(g, m, k, n)
    if ta and m % 8:
        # a transposed lhs stored with M as its row: 16-byte rows only at M % 8 == 0
        assert fused_gemm.variant_of(g, aligned) == "wmma"
    else:
        assert fused_gemm.variant_of(g, aligned) == want
    # an lhs 2 bytes off 16: TMA cannot read it where it lies
    assert fused_gemm.variant_of(g, _operands(g, m, k, n, offset=1)) == "wmma"
    # fp32 lhs against bf16 rhs, and the reverse where TMA reads the bf16
    # side: the split; all fp32: simt
    assert fused_gemm.variant_of(g, _operands(g, m, k, n, F32, BF16)) == "wgmma_split"
    lhs_readable = not (ta and m % 8)
    assert fused_gemm.variant_of(g, _operands(g, m, k, n, BF16, F32)) == \
        ("wgmma_split" if lhs_readable else "simt")
    assert fused_gemm.variant_of(g, _operands(g, m, k, n, F32)) == "simt"


def test_variant_rules_by_hand():
    v = fused_gemm.gemm_variant
    assert v(8, [BF16], [BF16, BF16]) == "wgmma_decode"
    assert v(8, [BF16], [BF16], panel=True) == "wgmma"       # a row panel has no decode tile
    assert v(4096, [BF16], [BF16], aligned=False) == "wmma"
    assert v(4096, [F32, F32], [BF16, BF16]) == "wgmma_split"
    assert v(4096, [BF16], [F32, BF16]) == "simt"           # a mixed side: no split
    assert v(4096, [F32], [BF16], aligned=False) == "simt"   # the bf16 side misaligned
    assert v(4096, [F32], [BF16], panel=True) == "simt"
    assert v(4096, [F32], [F32]) == "simt"


def test_a_copied_operand_is_judged_as_its_copy():
    """An operand whose rows are not unit-stride is copied contiguous by the
    wrapper: it is TMA-readable when its rows are 16-byte multiples."""
    g = _graph(1)
    ops = _operands(g, 64, 128, 256)
    ops["x"] = torch.zeros(128, 64, dtype=BF16).T            # (64, 128), column-major
    assert fused_gemm.variant_of(g, ops) == "wgmma"
    ops["x"] = torch.zeros(100, 64, dtype=BF16).T            # a copy with 200-byte rows
    assert fused_gemm.variant_of(g, ops) == "wmma"


def test_batch_strides_decide_readability_and_shared_axes_are_free():
    g = tf.simplify_graph(tf.fused_gated_mlp_graph("silu"))
    x = torch.zeros(3, 5, 96, 128, dtype=BF16)
    w = torch.zeros(128, 192, dtype=BF16)
    assert fused_gemm.variant_of(g, dict(x=x, wg=w, wu=w)) == "wgmma"
    # every problem shares a broadcast rhs (stride 0 on both batch axes)
    wb = w.expand(3, 5, 128, 192)
    assert fused_gemm.variant_of(g, dict(x=x, wg=wb, wu=wb)) == "wgmma"
    # a batch stride of 2 bytes past 16
    odd = torch.zeros(3 * 5 * 96 * 128 + 15, dtype=BF16)
    xo = odd[:3 * 5 * 96 * 128].as_strided((3, 5, 96, 128), (5 * 96 * 128 + 1, 96 * 128, 128, 1))
    assert fused_gemm.variant_of(g, dict(x=xo, wg=w, wu=w)) == "wmma"


@pytest.mark.parametrize("k,n", [(5120, 13824), (5120, 5120), (2304, 5760), (4096, 1024),
                                 (13824, 5120), (136, 520)])
def test_decode_split_never_depends_on_m(k, n):
    g = tf.simplify_graph(tf.fused_gated_mlp_graph("silu"))
    plans = {fused_gemm.gemm_plan(g, dict(x=_stored(m, k), wg=_stored(k, n), wu=_stored(k, n)))
             for m in range(1, 17)}
    assert len(plans) == 1
    plan = plans.pop()
    assert plan.variant == "wgmma_decode" and plan.tile == (16, 128)
    assert (plan.splits, plan.split_steps) == brgemm.decode_splits(k, n)
    assert plan.splits * plan.split_steps * 64 >= k > (plan.splits - 1) * plan.split_steps * 64


def test_plan_pieces_follow_the_fp32_side():
    g = tf.simplify_graph(tf.fused_gated_mlp_graph("silu"))
    x, w = _stored(4096, 2304), _stored(2304, 5760)
    assert fused_gemm.gemm_plan(g, dict(x=x.float(), wg=w, wu=w)).pieces == (2, 1)
    assert fused_gemm.gemm_plan(g, dict(x=x, wg=w.float(), wu=w.float())).pieces == (1, 2)
    assert fused_gemm.gemm_plan(g, dict(x=x, wg=w, wu=w)).pieces == (1, 1)


def test_the_training_backward_graphs_plan_the_split():
    """The gated MLP's derived dX and dW read fp32 dz against bf16 weights
    and activations: both on wgmma_split, the weight read transposed in
    place (dX) and x read transposed in place (dW)."""
    gb = tf.backward_graphs(tf.fused_gated_mlp_graph("silu"))
    t, d, ff = 512, 128, 320
    dz = torch.zeros(t, ff, dtype=F32)
    w, x = torch.zeros(d, ff, dtype=BF16), torch.zeros(t, d, dtype=BF16)
    dlhs = tf.simplify_graph(gb["fused_gated_mlp_silu@bwd_dlhs[x]"])
    drhs = tf.simplify_graph(gb["fused_gated_mlp_silu@bwd_drhs"])
    p = fused_gemm.gemm_plan(dlhs, dict(dz_g=dz, wg=w, dz_u=dz, wu=w))
    assert (p.variant, p.pieces, p.tile) == ("wgmma_split", (2, 1), (128, 64))
    p = fused_gemm.gemm_plan(drhs, dict(x=x, dz_g=dz, dz_u=dz))
    assert (p.variant, p.pieces, p.tile) == ("wgmma_split", (1, 2), (128, 64))


@pytest.mark.parametrize("roots,nlhs,pieces,panel",
                         [(r, nl, pc, p) for r in (1, 2, 3) for nl in range(1, r + 1)
                          for pc in ((1, 1), (2, 1), (1, 2)) for p in (False, True)
                          if not (p and pc != (1, 1))])
def test_wgmma_tiles_fit_the_sm(roots, nlhs, pieces, panel):
    bm, bn, stages, smem, ctas = fused_gemm.wgmma_tile(roots, nlhs, pieces, panel)
    assert bm == (64 if panel else 128) and bn == (128 if roots == 1 else 64)
    lhs = [F32 if pieces[0] == 2 else BF16] * nlhs
    rhs = [F32 if pieces[1] == 2 else BF16] * roots
    if smem > 232448:
        # the one tile that does not fit: three fp32 lhs split for three roots
        assert (roots, nlhs, pieces) == (3, 3, (2, 1))
        assert fused_gemm.gemm_variant(4096, lhs, rhs) == "simt"
        return
    assert fused_gemm.gemm_variant(4096, lhs, rhs, panel=panel) == \
        ("wgmma" if pieces == (1, 1) else "wgmma_split")
    assert 2 <= stages <= 4
    assert ctas == 1 or (2 * smem <= 227 * 1024 and roots * bn // 2 <= 64)
    # a thread's accumulators: at most 96 fp32 registers
    assert roots * bn // 2 <= 96


# ---------------------------------------------------------------------------
# K5: tiles and order tables
# ---------------------------------------------------------------------------

SPECS = [("bca", None), ("cba", None), ("BCa", None), ("bcba", {"b": (4,)}), ("bcca", {"c": (2,)})]


@pytest.mark.parametrize("spec,steps", SPECS)
@pytest.mark.parametrize("variant,roots,m", [("wgmma", 1, 1024), ("wgmma", 2, 1024),
                                             ("wgmma_split", 3, 1024), ("wgmma_decode", 2, 16),
                                             ("wmma", 2, 1024), ("simt", 1, 1024)])
def test_order_table_covers_every_cta_tile_once(spec, steps, variant, roots, m):
    g = _graph(roots)
    n = 1024
    gp = tlowering.plan_graph(g, m, 256, n, BF16, spec_string=spec, tiles=(4 if m == 16 else 16, 64, 64),
                              block_steps=steps)
    cta = fused_gemm.cta_tile(g, m, n, variant)
    order = fused_gemm.order_table(gp, m, n, cta).tolist()
    want = {(i, j) for i in range(0, m, cta[0]) for j in range(0, n, cta[1])}
    assert len(order) == len(want) and {tuple(o) for o in order} == want


def test_cta_tiles_by_variant():
    one, two, panel = _graph(1), _graph(2), _graph(1, panel=True)
    assert fused_gemm.cta_tile(one, 2048, 512, "wgmma") == (128, 128)
    assert fused_gemm.cta_tile(two, 2048, 512, "wgmma") == (128, 64)
    assert fused_gemm.cta_tile(two, 2048, 512, "wgmma_split") == (128, 64)
    assert fused_gemm.cta_tile(two, 4, 512, "wgmma_decode") == (16, 128)
    assert fused_gemm.cta_tile(two, 4, 512, "wmma") == (16, 64)
    assert fused_gemm.cta_tile(two, 2048, 512, "simt") == (128, 64)
    assert fused_gemm.cta_tile(panel, 2048, 512, "wgmma") == (64, 512)
    assert fused_gemm.cta_tile(panel, 2048, 512, "simt") == (128, 512)
    # a variant by name only
    for bad in (True, False, "tiles"):
        with pytest.raises(ValueError, match="unknown K5 variant"):
            fused_gemm.cta_tile(two, 2048, 512, bad)


# ---------------------------------------------------------------------------
# K5: the fp32 split
# ---------------------------------------------------------------------------


def _split_product(x, w, pieces):
    """wgmma_split's arithmetic: each bf16 piece of x times the exact bf16
    w, summed in fp32."""
    out = torch.zeros(x.shape[0], w.shape[1], dtype=F32)
    for p in fused_gemm.split_bf16(x, pieces):
        out = out + p.float() @ w.float()
    return out


@pytest.mark.parametrize("t,d,ff", [(256, 64, 160), (512, 96, 384), (128, 128, 1024)])
def test_hi_lo_split_keeps_the_fp32_tolerance(t, d, ff):
    """dX = dz @ w.T and dW = x.T @ dz at reduced widths of the gated MLP's
    backward, dz of unit scale as phase 3's: hi + lo within rtol 1e-4 /
    atol 1e-3 of the fp64 product, hi alone not; lo2 only closer.  (hi +
    lo leaves about 2^-17.5 |dz| |w| a term, so the absolute tolerance
    holds while sqrt(K) |dz| |w| stays well under 1e-3 / 4e-6.)"""
    scale = 1.0
    rng = np.random.default_rng(t + ff)
    dz = torch.from_numpy(rng.normal(size=(t, ff)).astype(np.float32) * scale)
    w = torch.from_numpy(rng.normal(size=(d, ff)).astype(np.float32) / np.sqrt(ff)).to(BF16)
    x = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32)).to(BF16)
    # dX = dz @ w.T, and dW.T = dz.T @ x (the split side is the fp32 one)
    for lhs, rhs in ((dz, w.T), (dz.T.contiguous(), x)):
        exact = (lhs.double() @ rhs.double()).float()
        one, two, three = (_split_product(lhs, rhs, p) for p in (1, 2, 3))
        torch.testing.assert_close(two, exact, rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(three, exact, rtol=1e-4, atol=1e-3)
        assert not torch.allclose(one, exact, rtol=1e-4, atol=1e-3)
        assert (three - exact).abs().max() <= (two - exact).abs().max()


def test_split_pieces_sum_to_the_operand():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 80)).astype(np.float32))
    hi, lo = fused_gemm.split_bf16(x)
    assert hi.dtype == lo.dtype == BF16
    err = (hi.float() + lo.float() - x).abs()
    assert bool((err <= x.abs() * 2.0 ** -16).all())
    assert torch.equal(hi, x.to(BF16))


# ---------------------------------------------------------------------------
# K5: the launch arguments
# ---------------------------------------------------------------------------


def test_ctypes_args_follow_the_header():
    text = (CSRC / "fused_gemm.cuh").read_text()
    body = text[text.index("struct FusedArgs {") + len("struct FusedArgs {"):]
    body = body[:body.index("};")]
    names = re.findall(r"(\w+)\s*(?:\[[^\]]*\])*\s*(?=[,;])", body)
    assert names == [f[0] for f in fused_gemm._Args._fields_]


def test_the_source_instantiates_one_entry_for_every_variant():
    src = fused_gemm.generate_source(tf.simplify_graph(tf.fused_gated_mlp_graph("silu")))
    assert '#include "fused_gemm.cuh"' in src and "fg::entry<Epi>" in src
    header = (CSRC / "fused_gemm.cuh").read_text()
    for kernel in ("fused_gemm_bf16_wgmma", "fused_gemm_bf16_wgmma_decode",
                   "fused_panel_bf16_wgmma", "fg_split_bf16", "fused_gemm_bf16_wmma",
                   "fused_gemm_f32_simt"):
        assert f"{kernel}(" in header
    assert set(fused_gemm.VARIANTS) == set(fused_gemm.VARIANT_COUNTERS)
    for counter in fused_gemm.VARIANT_COUNTERS.values():
        assert getattr(fused_gemm, counter) == 0


# ---------------------------------------------------------------------------
# K10: the plan and the paired work list
# ---------------------------------------------------------------------------


def _work_list(m, k, bs, sparsity, seed, empty_rows=(), pad=True):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, k)).astype(np.float32)
    a.reshape(m // bs, bs, k // bs, bs).transpose(0, 2, 1, 3)[rng.random((m // bs, k // bs)) < sparsity] = 0
    for r in empty_rows:
        a[r * bs:(r + 1) * bs] = 0
    a = torch.from_numpy(a).to(BF16).float().numpy()    # values exact in bf16
    return a, spmm.densify_to_bcsr(a, bs, bs, pad_empty_rows=pad, device="cpu")


def _row_ptr(row_id, nrows):
    return torch.searchsorted(row_id, torch.arange(nrows + 1, dtype=torch.int32), out_int32=True)


def _steps_product(blocks, col_id, row_ptr, b):
    """C from ``paired_steps``: each k16 step is one product of the step's
    (bm, 16) blocks against its 16 gathered rows of B, zeros where a slot is
    -1; summed in fp32 in step order."""
    bm, bk = blocks.shape[1:]
    nrows = row_ptr.shape[0] - 1
    c = torch.zeros(nrows * bm, b.shape[1], dtype=F32)
    for r, steps in enumerate(spmm.paired_steps(row_ptr, bk)):
        for pair in steps:
            a_step = torch.zeros(bm, 16)
            b_step = torch.zeros(16, b.shape[1])
            for h, t in enumerate(pair if bk == 8 else pair[:1]):
                if t < 0:
                    continue
                a_step[:, h * bk:(h + 1) * bk] = blocks[t].float()
                k0 = int(col_id[t]) * bk
                b_step[h * bk:(h + 1) * bk] = b[k0:k0 + bk].float()
            c[r * bm:(r + 1) * bm] += a_step @ b_step
    return c


@pytest.mark.parametrize("bs,m,k,n,sparsity,empty,pad", [
    (8, 64, 96, 40, 0.5, (), True), (8, 80, 64, 24, 0.3, (2, 5), False),
    (8, 48, 72, 16, 0.0, (), True), (16, 96, 64, 32, 0.5, (1,), True),
    (16, 64, 128, 48, 0.8, (0, 3), False), (16, 48, 48, 8, 0.0, (), True)])
def test_paired_steps_give_the_dense_product(bs, m, k, n, sparsity, empty, pad):
    a, (blocks, rid, cid) = _work_list(m, k, bs, sparsity, m + k + n, empty, pad)
    # the reference's work list, item for item
    jb, jr, jc = jspmm.densify_to_bcsr(a, bs, bs, pad_empty_rows=pad)
    np.testing.assert_array_equal(np.asarray(jb), blocks.numpy())
    np.testing.assert_array_equal(np.asarray(jr), rid.numpy())
    np.testing.assert_array_equal(np.asarray(jc), cid.numpy())
    ptr = _row_ptr(rid, m // bs)
    b = torch.from_numpy(np.random.default_rng(1).normal(size=(k, n)).astype(np.float32)).to(BF16)
    got = _steps_product(blocks, cid, ptr, b)
    torch.testing.assert_close(got, torch.from_numpy(a) @ b.float(), rtol=1e-5, atol=1e-5)
    steps = spmm.paired_steps(ptr, bs)
    for r in empty:
        assert pad or steps[r] == []
    per = 2 if bs == 8 else 1
    for (beg, end), row in zip(zip(ptr[:-1].tolist(), ptr[1:].tolist()), steps):
        assert len(row) == -(-(end - beg) // per)
        items = [t for pair in row for t in pair if t >= 0]
        assert items == list(range(beg, end))
        assert all(pair[1] == -1 for pair in row) if bs == 16 else \
            sum(pair[1] == -1 for pair in row) == (end - beg) % 2


@pytest.mark.parametrize("nrows,n", [(64, 4096), (16, 4096), (64, 1024), (1, 300), (1, 8),
                                     (512, 64)])
def test_spmm_plan_covers_every_tile_once(nrows, n):
    plan = spmm.spmm_plan(nrows, n, BF16)
    assert plan.variant == "wgmma"
    runs, cols = plan.grid
    assert cols == -(-n // 128)
    covered = [r for g in range(runs) for r in range(g * plan.rows_per_cta,
                                                    min(nrows, (g + 1) * plan.rows_per_cta))]
    assert covered == list(range(nrows))
    assert runs * cols <= max(spmm._TARGET_CTAS, cols) + cols
    assert (runs - 1) * plan.rows_per_cta < nrows


@pytest.mark.parametrize("bs,m,k,n,sparsity,empty,pad", [
    (8, 128, 96, 40, 0.5, (), True), (8, 192, 64, 24, 0.8, (2, 5, 9), False),
    (16, 128, 64, 32, 0.0, (), False), (16, 192, 128, 48, 0.7, (0, 3, 4, 5, 6, 7), True)])
def test_64_row_work_list_gives_the_dense_product(bs, m, k, n, sparsity, empty, pad):
    """The wgmma variant's work list, ``densify_to_bcsr`` at 64 rows of a
    matrix pruned in bs x bs blocks: each 64-row block row holds the union
    of its bs-row block rows' column ids (an all-empty one, only a padding
    block or nothing), its paired steps give the dense product, and the plan
    runs it on wgmma where the pruned blocks' own list runs on wmma."""
    a, (blocks, rid, cid) = _work_list(m, k, bs, sparsity, m + k + n, empty, pad)
    ub, urid, ucid = spmm.densify_to_bcsr(a, spmm.WGMMA_ROWS, bs, pad_empty_rows=pad, device="cpu")
    assert ub.shape[1:] == (64, bs) and bool((urid[1:] >= urid[:-1]).all())
    tiles, group = m // 64, 64 // bs
    ptr = _row_ptr(urid, tiles)
    b = torch.from_numpy(np.random.default_rng(2).normal(size=(k, n)).astype(np.float32)).to(BF16)
    got = _steps_product(ub, ucid, ptr, b)
    torch.testing.assert_close(got, torch.from_numpy(a) @ b.float(), rtol=1e-5, atol=1e-5)
    live = blocks.float().abs().sum((1, 2)) != 0         # not a padding block
    fine = [set(cid[(rid == r) & live].tolist()) for r in range(m // bs)]
    for g in range(tiles):
        cols = set(ucid[urid == g].tolist())
        union = set().union(*fine[g * group:(g + 1) * group])
        assert cols == union or (pad and not union and cols == {0})
    assert spmm.spmm_plan(tiles, n, BF16, nnzb=len(ub), bm=64).variant == "wgmma"
    assert spmm.spmm_plan(m // bs, n, BF16, nnzb=len(blocks), bm=bs).variant == "wmma"


def test_spmm_plan_variants():
    assert spmm.spmm_plan(64, 256, F32).variant == "simt"
    assert spmm.spmm_plan(64, 256, F32, bm=8).variant == "simt"
    assert spmm.spmm_plan(64, 256, BF16, aligned=False).variant == "wmma"
    assert spmm.spmm_plan(64, 256, BF16, nnzb=0).variant == "wmma"
    assert spmm.spmm_plan(64, 256, BF16, bm=8).variant == "wmma"
    assert spmm.spmm_plan(64, 256, BF16, bm=16).variant == "wmma"
    assert spmm.spmm_plan(64, 256, BF16).variant == "wgmma"
    assert set(spmm.SPMM_VARIANTS) == set(spmm.SPMM_COUNTERS)
    assert {bm for bm, _ in spmm.BLOCK_SHAPES} == {8, 16, spmm.WGMMA_ROWS}


def test_paired_steps_of_rows_by_hand():
    ptr = torch.tensor([0, 3, 3, 4, 8], dtype=torch.int32)
    assert spmm.paired_steps(ptr, 8) == [[(0, 1), (2, -1)], [], [(3, -1)], [(4, 5), (6, 7)]]
    assert spmm.paired_steps(ptr, 16) == [[(0, -1), (1, -1), (2, -1)], [], [(3, -1)],
                                          [(4, -1), (5, -1), (6, -1), (7, -1)]]


@pytest.mark.parametrize("m,roots", list(itertools.product((4, 100), (1, 3))))
def test_plans_are_functions_of_their_inputs_alone(m, roots):
    g = _graph(roots)
    ops = _operands(g, m, 128, 256)
    assert fused_gemm.gemm_plan(g, ops) == fused_gemm.gemm_plan(g, dict(ops))
    assert spmm.spmm_plan(m, 256, BF16) == spmm.spmm_plan(m, 256, BF16)
