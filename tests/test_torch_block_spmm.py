"""The port's Block-SpMM (K10's plain version, ``kernels.ops.block_spmm`` on
the CPU) and grouped product (K9's, ``kernels.ops.grouped_matmul``) against
the JAX reference: ``densify_to_bcsr`` array for array, the reference's
Pallas kernels in interpret mode over ``tests/test_kernels.py``'s densities,
block sizes and seeded random patterns, bf16 inputs, a transposed-view B,
an empty block row, the Fig. 10 call of ``benchmarks/bench_e2e.py`` at its
reduced widths, and ``mlp_ref``; K9's gradients (``ops.grouped_matmul``
under autograd: ``grouped_matmul_dx_ref`` and ``grouped_matmul_dw_ref`` on
the CPU) against ``jax.grad`` of the reference's per-tile product (rtol
1e-4 / atol 1e-5 in fp32); plus the wrappers' refusals.

Tolerances are ``tests/test_kernels.py``'s ``_tol``: fp32 rtol 1e-4 / atol
1e-3 (fp32 sums in another order), bf16 rtol 2e-2 / atol 2e-1 (the output's
one bf16 rounding at magnitudes up to about 30).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.kernels import ref as jref
from repro.kernels.block_spmm import block_spmm_pallas, grouped_matmul_pallas
from repro.kernels.block_spmm import densify_to_bcsr as jdensify
from repro_torch.kernels import block_spmm as tspmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

F32_TOL = dict(rtol=1e-4, atol=1e-3)
BF16_TOL = dict(rtol=2e-2, atol=2e-1)


def _pruned(rng, m, k, bm, bk, density):
    """A dense (m, k) fp32 matrix whose (bm, bk) blocks are zeroed with
    probability ``density`` (the reference test's pattern)."""
    dense = rng.normal(size=(m, k)).astype(np.float32)
    tiles = dense.reshape(m // bm, bm, k // bk, bk).transpose(0, 2, 1, 3).copy()
    tiles[rng.random((m // bm, k // bk)) >= density] = 0
    return tiles.transpose(0, 2, 1, 3).reshape(m, k)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("pad", [True, False])
def test_densify_matches_reference(pad):
    rng = np.random.default_rng(0)
    a = _pruned(rng, 48, 64, 8, 16, 0.4)
    a[16:24] = 0                                    # an empty block row
    want = jdensify(a, 8, 16, pad_empty_rows=pad)
    got = tspmm.densify_to_bcsr(a, 8, 16, pad_empty_rows=pad, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == (torch.float32 if g.dim() == 3 else torch.int32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dense = tref.bcsr_to_dense(*got, nrows_b=6, ncols_b=4)
    np.testing.assert_array_equal(dense.numpy(), a)
    np.testing.assert_array_equal(dense.numpy(), jref.bcsr_to_dense(*want, 6, 4))


def test_densify_keeps_a_tensor_dtype():
    a = torch.zeros(16, 16, dtype=torch.bfloat16)
    a[:8, 8:] = 1.5
    blocks, rid, cid = tspmm.densify_to_bcsr(a, 8, 8, device="cpu")
    assert blocks.dtype == torch.bfloat16
    assert rid.tolist() == [0, 1] and cid.tolist() == [1, 0]
    assert float(blocks[1].abs().sum()) == 0.0       # the padded empty row


@pytest.mark.parametrize("density", [0.0, 0.2, 0.7, 1.0])
@pytest.mark.parametrize("bm,bk", [(8, 8), (16, 16)])
def test_block_spmm_densities_match_pallas(density, bm, bk):
    rng = np.random.default_rng(int(density * 10) + bm)
    m, k, n = 64, 64, 64
    dense = _pruned(rng, m, k, bm, bk, density)
    b = rng.normal(size=(k, n)).astype(np.float32)
    jb = jdensify(dense, bm, bk)
    want = block_spmm_pallas(*jb, jnp.asarray(b), nrows_b=m // bm, bn=32, interpret=True)
    blocks, rid, cid = tspmm.densify_to_bcsr(dense, bm, bk, device="cpu")
    got = tops.block_spmm(blocks, rid, cid, _t(b), nrows_b=m // bm, bn=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), dense @ b, **F32_TOL)


@given(st.integers(0, 10_000))
@settings(max_examples=8, deadline=None)
def test_property_block_spmm_random_patterns(seed):
    rng = np.random.default_rng(seed)
    dense = _pruned(rng, 32, 32, 8, 8, rng.uniform(0, 1))
    b = rng.normal(size=(32, 16)).astype(np.float32)
    want = block_spmm_pallas(*jdensify(dense, 8, 8), jnp.asarray(b), nrows_b=4, bn=16,
                             interpret=True)
    got = tref.block_spmm_ref(*tspmm.densify_to_bcsr(dense, 8, 8, device="cpu"), _t(b),
                              nrows_b=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_block_spmm_bf16_matches_pallas():
    rng = np.random.default_rng(5)
    dense = _pruned(rng, 64, 64, 16, 16, 0.5)
    b = rng.normal(size=(64, 64)).astype(np.float32)
    jblocks, jr, jc = jdensify(dense, 16, 16)
    want = block_spmm_pallas(jblocks.astype(jnp.bfloat16), jr, jc,
                             jnp.asarray(b, jnp.bfloat16), nrows_b=4, bn=32, interpret=True)
    blocks, rid, cid = tspmm.densify_to_bcsr(_t(dense, torch.bfloat16), 16, 16, device="cpu")
    got = tops.block_spmm(blocks, rid, cid, _t(b, torch.bfloat16), nrows_b=4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **BF16_TOL)
    got32 = tops.block_spmm(blocks, rid, cid, _t(b, torch.bfloat16), nrows_b=4,
                            out_dtype=torch.float32)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), np.asarray(want, np.float32), **BF16_TOL)


def test_block_spmm_transposed_view_b():
    """B as the transposed view x.T, as the Fig. 10 call passes it."""
    rng = np.random.default_rng(6)
    dense = _pruned(rng, 32, 48, 8, 8, 0.5)
    x = rng.normal(size=(40, 48)).astype(np.float32)
    xt = _t(x).T
    assert xt.stride(0) == 1
    blocks, rid, cid = tspmm.densify_to_bcsr(dense, 8, 8, device="cpu")
    got = tops.block_spmm(blocks, rid, cid, xt, nrows_b=4)
    want = jref.block_spmm_ref(*jdensify(dense, 8, 8), jnp.asarray(x).T, nrows_b=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_block_spmm_empty_row_without_padding_is_zero():
    rng = np.random.default_rng(7)
    dense = _pruned(rng, 32, 32, 8, 8, 0.8)
    dense[8:16] = 0
    b = rng.normal(size=(32, 24)).astype(np.float32)
    blocks, rid, cid = tspmm.densify_to_bcsr(dense, 8, 8, pad_empty_rows=False, device="cpu")
    assert 1 not in rid.tolist()
    got = tops.block_spmm(blocks, rid, cid, _t(b), nrows_b=4)
    want = jref.block_spmm_ref(*jdensify(dense, 8, 8, pad_empty_rows=False), jnp.asarray(b),
                               nrows_b=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    assert float(got[8:16].abs().max()) == 0.0


def test_fig10_sparse_ffn_call_matches_reference():
    """``benchmarks/bench_e2e.py``'s sparse row at its reduced widths (d 256,
    ff 1024, 64 tokens, 80 % of 8x8 blocks zeroed):
    ``block_spmm(blocks, rid, cid, x.T, nrows_b=ff // 8).T``."""
    rng = np.random.default_rng(0)
    d, ff = 256, 1024
    x = rng.normal(size=(64, d)).astype(np.float32)
    w = rng.normal(size=(d, ff)).astype(np.float32)
    tiles = w.reshape(d // 8, 8, ff // 8, 8).transpose(0, 2, 1, 3).copy()
    tiles[rng.random((d // 8, ff // 8)) < 0.8] = 0
    w_sp = tiles.transpose(0, 2, 1, 3).reshape(d, ff)
    jb = jdensify(w_sp.T, 8, 8)
    want = jref.block_spmm_ref(*jb, jnp.asarray(x).T, nrows_b=ff // 8).T
    blocks, rid, cid = tspmm.densify_to_bcsr(w_sp.T, 8, 8, device="cpu")
    got = tops.block_spmm(blocks, rid, cid, _t(x).T, nrows_b=ff // 8).T
    assert got.shape == (64, ff)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), x @ w_sp, **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_matches_pallas(dtype):
    rng = np.random.default_rng(8)
    t, d, f, e, bm = 64, 32, 64, 4, 8
    x = rng.normal(size=(t, d)).astype(np.float32)
    gid = np.sort(rng.integers(0, e, t // bm)).astype(np.int32)
    w = rng.normal(size=(e, d, f)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = grouped_matmul_pallas(jnp.asarray(x, jdt), jnp.asarray(gid), jnp.asarray(w, jdt),
                                 bf=32, interpret=True)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    got_ref = tref.grouped_matmul_ref(_t(x, tdt), torch.from_numpy(gid), _t(w, tdt))
    got = tops.grouped_matmul(_t(x, tdt), torch.from_numpy(gid), _t(w, tdt), bf=32)
    for out in (got_ref, got):
        assert out.dtype == tdt
        np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_mlp_ref_matches_reference(activation):
    rng = np.random.default_rng(9)
    dims = (24, 48, 16)
    x = rng.normal(size=(10, dims[0])).astype(np.float32)
    ws = [rng.normal(size=(a, b)).astype(np.float32) / np.sqrt(a) for a, b in zip(dims, dims[1:])]
    bs = [rng.normal(size=(b,)).astype(np.float32) for b in dims[1:]]
    want = jref.mlp_ref(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                        [jnp.asarray(b) for b in bs], activation=activation)
    got = tref.mlp_ref(_t(x), [_t(w) for w in ws], [_t(b) for b in bs], activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_ops_raise_when_a_gradient_is_wanted():
    blocks, rid, cid = tspmm.densify_to_bcsr(np.ones((8, 8), np.float32), 8, 8, device="cpu")
    b = torch.randn(8, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        tops.block_spmm(blocks, rid, cid, b, nrows_b=1)
    with torch.no_grad():
        assert tops.block_spmm(blocks, rid, cid, b, nrows_b=1).shape == (8, 4)
    # K9 has a backward (``_GroupedMatmul``): its product is differentiable
    x, w = torch.randn(8, 4), torch.randn(2, 4, 6, requires_grad=True)
    out = tops.grouped_matmul(x, torch.zeros(1, dtype=torch.int32), w)
    assert out.requires_grad and type(out.grad_fn).__name__ == "_GroupedMatmulBackward"


def test_cuda_wrappers_refuse_cpu_tensors():
    blocks, rid, cid = tspmm.densify_to_bcsr(np.ones((8, 8), np.float32), 8, 8, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tspmm.block_spmm(blocks, rid, cid, torch.randn(8, 4), nrows_b=1)
    with pytest.raises(ValueError, match="CUDA"):
        tspmm.grouped_matmul(torch.randn(8, 4), torch.zeros(1, dtype=torch.int32),
                             torch.randn(2, 4, 6))
    with pytest.raises(ValueError, match="CUDA"):
        tspmm.grouped_matmul_dx(torch.randn(8, 6), torch.zeros(1, dtype=torch.int32),
                                torch.randn(2, 4, 6))
    with pytest.raises(ValueError, match="CUDA"):
        tspmm.grouped_matmul_dw(torch.randn(8, 4), torch.zeros(1, dtype=torch.int32),
                                torch.randn(8, 6), 2)
    with pytest.raises(ValueError, match="cpu or all on cuda"):
        tops.block_spmm(blocks, rid, cid, torch.randn(8, 4, device="meta"), nrows_b=1)


def _jax_grouped_grads(x, gid, w, r):
    """jax.grad of sum(r * out), out the reference's per-tile product
    (``repro/kernels/ref.py``'s grouped oracle written as an einsum over the
    gathered slabs, as the MoE layer's einsums compute it) → (dx, dw)."""
    import jax

    tiles = gid.shape[0]

    def loss(xx, ww):
        out = jnp.einsum("tcd,tdf->tcf", xx.reshape(tiles, -1, xx.shape[1]), ww[gid])
        return jnp.sum(out.reshape(r.shape) * r)

    dx, dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return np.asarray(dx), np.asarray(dw)


@pytest.mark.parametrize("gid", [[0, 1, 2, 3], [2, 0, 2, 1, 0], [3, 3, 1]],
                         ids=["one-tile-each", "tiles-apart", "expert-without-tile"])
@pytest.mark.parametrize("rows", [1, 8, 13])
def test_grouped_matmul_gradients_match_jax_grad(gid, rows):
    """``ops.grouped_matmul`` under autograd in fp32 (the Function's CPU
    dispatch: the plain dX and dW): an expert's tiles apart from each other
    (summed in tile order), an expert that owns no tile (a zero slab), the
    output in fp32 from fp32 operands, and dX alone when w wants none."""
    rng = np.random.default_rng(rows + len(gid))
    e, d, f = 4, 24, 40
    gid = np.asarray(gid, np.int32)
    x = rng.normal(size=(len(gid) * rows, d)).astype(np.float32)
    w = rng.normal(size=(e, d, f)).astype(np.float32)
    r = rng.normal(size=(len(gid) * rows, f)).astype(np.float32)
    jdx, jdw = _jax_grouped_grads(x, gid, w, r)
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    out = tops.grouped_matmul(tx, torch.from_numpy(gid), tw, out_dtype=torch.float32)
    dx, dw = torch.autograd.grad((out * _t(r)).sum(), (tx, tw))
    assert dw.dtype == torch.float32 and dx.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), jdx, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), jdw, rtol=1e-4, atol=1e-5)
    for missing in set(range(e)) - set(gid.tolist()):
        assert not dw[missing].any()
    out = tops.grouped_matmul(tx, torch.from_numpy(gid), _t(w))
    (only_dx,) = torch.autograd.grad((out * _t(r)).sum(), (tx,))
    np.testing.assert_allclose(only_dx.numpy(), jdx, rtol=1e-4, atol=1e-5)


def test_grouped_matmul_gradient_of_fp32_masters_in_bf16():
    """bf16 activations against fp32 master experts: the product casts w to
    bf16 inside, dX comes back in bf16 and dW in fp32, not rounded to bf16
    (the incoming gradient rounded to bf16 first, as ``ops.matmul`` rounds
    dZ); dW equals the fp32 product of the bf16 operands."""
    rng = np.random.default_rng(5)
    gid = torch.tensor([1, 0, 1], dtype=torch.int32)
    x = _t(rng.normal(size=(3 * 16, 32)), torch.bfloat16).requires_grad_()
    w = _t(rng.normal(size=(2, 32, 48)) / 6).requires_grad_()
    r = _t(rng.normal(size=(3 * 16, 48)))
    out = tops.grouped_matmul(x, gid, w, out_dtype=torch.float32)
    dx, dw = torch.autograd.grad((out * r).sum(), (x, w))
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    rb = r.to(torch.bfloat16).float()
    xs = x.detach().float().reshape(3, 16, 32)
    want = torch.zeros(2, 32, 48)
    for t, g in enumerate(gid.tolist()):
        want[g] += xs[t].T @ rb.reshape(3, 16, 48)[t]
    np.testing.assert_allclose(dw.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert not torch.equal(dw, dw.to(torch.bfloat16).float())
    wb = w.detach().to(torch.bfloat16).float()
    want_dx = torch.stack([rb.reshape(3, 16, 48)[t] @ wb[g].T for t, g in enumerate(gid.tolist())])
    np.testing.assert_allclose(dx.float().numpy(), want_dx.reshape(48, 32).numpy(), **BF16_TOL)
