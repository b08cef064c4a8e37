"""The port's kernel API on the CPU (the plain PyTorch versions of K1, K2, K3
and K4, and the backward of K1 and of K2 that K6 computes) against the JAX
reference (``backend="xla"``) and the JAX Pallas kernels in interpret mode,
on the same numpy-seeded inputs; gradients against ``jax.grad``.

Tolerances are those of ``tests/test_kernels.py``: fp32 GEMM rtol 1e-4 /
atol 1e-3 (K up to 64 fp32 products summed in another order), fp32 attention
1e-4 (softmax of O(1) scores, summed in another order), and bf16 rtol 2e-2 /
atol 2e-1 (one bf16 rounding of the output is 2^-8 relative, and the Pallas
kernels round p or intermediate tiles at other places).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fusion
from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_pallas, flash_decode_pallas
from repro_torch.kernels import brgemm
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GEMM_TOL = {"float32": dict(rtol=1e-4, atol=1e-3),
            "bfloat16": dict(rtol=2e-2, atol=2e-1)}
ATTN_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
            "bfloat16": dict(rtol=2e-2, atol=2e-1)}


def _pair(x: np.ndarray, dtype: str):
    """One numpy array as a (jax, torch) pair of the same dtype."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("activation", [None, "relu", "gelu", "silu", "sigmoid"])
def test_matmul_matches_reference_and_pallas(activation, with_bias, dtype):
    rng = np.random.default_rng(1)
    m, k, n = 32, 64, 48
    ja, ta = _pair(rng.normal(size=(m, k)).astype(np.float32), dtype)
    jb, tb = _pair((rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32), dtype)
    jbias, tbias = _pair(rng.normal(size=(n,)).astype(np.float32), dtype) \
        if with_bias else (None, None)
    got = tops.matmul(ta, tb, bias=tbias, activation=activation)
    assert got.dtype == ta.dtype and got.shape == (m, n)
    for backend in ("xla", "pallas_interpret"):
        want = jops.matmul(ja, jb, bias=jbias, activation=activation, backend=backend)
        np.testing.assert_allclose(_f32(got), _f32(want), **GEMM_TOL[dtype],
                                   err_msg=backend)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_ragged_m_matches_reference(dtype):
    """A ragged row count (37) and an fp32 output from bf16 inputs."""
    rng = np.random.default_rng(2)
    ja, ta = _pair(rng.normal(size=(37, 40)).astype(np.float32), dtype)
    jb, tb = _pair(rng.normal(size=(40, 24)).astype(np.float32), dtype)
    got = tops.matmul(ta, tb, activation="gelu", out_dtype=torch.float32)
    want = jops.matmul(ja, jb, activation="gelu", out_dtype=jnp.float32, backend="xla")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), **GEMM_TOL[dtype])


ATTN_CASES = {
    "causal": (64, dict(causal=True)),
    "window": (64, dict(causal=True, window=24)),
    "noncausal": (64, dict(causal=False)),
    "sq_lt_skv": (32, dict(causal=True)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_matches_reference_and_pallas(case, dtype):
    """GQA (H=4, Hk=2); Sq < Skv aligns the query rows to the end of the keys.
    No case masks a whole row (the reference gives NaN there, the kernel 0)."""
    sq, kw = ATTN_CASES[case]
    rng = np.random.default_rng(3)
    b, h, hk, skv, d = 2, 4, 2, 64, 16
    jq, tq = _pair(rng.normal(size=(b, h, sq, d)).astype(np.float32), dtype)
    jk, tk = _pair(rng.normal(size=(b, hk, skv, d)).astype(np.float32), dtype)
    jv, tv = _pair(rng.normal(size=(b, hk, skv, d)).astype(np.float32), dtype)
    got = tops.attention(tq, tk, tv, **kw)
    assert got.shape == (b, h, sq, d) and got.dtype == tq.dtype
    want_xla = jops.attention(jq, jk, jv, backend="xla", **kw)
    want_pallas = flash_attention_pallas(jq, jk, jv, interpret=True, **kw)
    for name, want in (("xla", want_xla), ("pallas_interpret", want_pallas)):
        np.testing.assert_allclose(_f32(got), _f32(want), **ATTN_TOL[dtype],
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 16])
def test_decode_attention_matches_reference_and_pallas(window, dtype):
    """Ragged per-row lengths, GQA (H=4, Hk=2), with and without a window."""
    rng = np.random.default_rng(4)
    b, h, hk, s, d = 3, 4, 2, 64, 16
    jq, tq = _pair(rng.normal(size=(b, h, d)).astype(np.float32), dtype)
    jk, tk = _pair(rng.normal(size=(b, hk, s, d)).astype(np.float32), dtype)
    jv, tv = _pair(rng.normal(size=(b, hk, s, d)).astype(np.float32), dtype)
    lens = np.asarray([20, 64, 37], np.int32)
    got = tops.decode_attention(tq, tk, tv, length=torch.from_numpy(lens), window=window)
    assert got.shape == (b, h, d) and got.dtype == tq.dtype
    jl = jnp.asarray(lens)
    want_xla = jops.decode_attention(jq, jk, jv, length=jl, window=window, backend="xla")
    want_pallas = flash_decode_pallas(jq, jk, jv, length=jl, window=window,
                                      block_kv=32, interpret=True)
    for name, want in (("xla", want_xla), ("pallas_interpret", want_pallas)):
        np.testing.assert_allclose(_f32(got), _f32(want), **ATTN_TOL[dtype],
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("hk", [2, 4])
def test_paged_decode_attention_matches_reference_and_pallas(hk, window, dtype):
    """Token-major pools read through a shuffled page table whose unused
    columns hold the trash page; ragged lengths (one ends mid-page, one
    fills every column); GQA (H=4, Hk=2) and MHA (Hk=4)."""
    rng = np.random.default_rng(7)
    b, h, d, ps, maxp = 3, 4, 16, 4, 8
    num_pages = 20
    lens = np.asarray([13, 32, 3], np.int32)
    table = np.full((b, maxp), num_pages, np.int32)        # trash sentinel
    pages = rng.permutation(num_pages)
    used = 0
    for i, n in enumerate(lens):
        k = -(-int(n) // ps)
        table[i, :k] = pages[used:used + k]
        used += k
    jq, tq = _pair(rng.normal(size=(b, h, d)).astype(np.float32), dtype)
    pool = (num_pages + 1, ps, hk, d)
    jk, tk = _pair(rng.normal(size=pool).astype(np.float32), dtype)
    jv, tv = _pair(rng.normal(size=pool).astype(np.float32), dtype)
    got = tops.paged_decode_attention(tq, tk, tv, torch.from_numpy(table), page_size=ps,
                                      length=torch.from_numpy(lens), window=window)
    assert got.shape == (b, h, d) and got.dtype == tq.dtype
    for backend in ("xla", "pallas_interpret"):
        want = jops.paged_decode_attention(jq, jk, jv, jnp.asarray(table), page_size=ps,
                                           length=jnp.asarray(lens), window=window,
                                           backend=backend, block_kv=16)
        np.testing.assert_allclose(_f32(got), _f32(want), **ATTN_TOL[dtype],
                                   err_msg=backend)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_attention_at_head_dim_256(dtype):
    """gpt-j-6b's head dim (256, H = Hk): K4's plain version against the
    reference and its Pallas kernel in interpret mode, ragged lengths and a
    window."""
    rng = np.random.default_rng(11)
    b, h, d, ps, maxp, num_pages = 2, 2, 256, 4, 8, 10
    lens = np.asarray([21, 6], np.int32)
    table = np.full((b, maxp), num_pages, np.int32)
    table[0, :6], table[1, :2] = rng.permutation(num_pages)[:6], rng.permutation(num_pages)[6:8]
    jq, tq = _pair(rng.normal(size=(b, h, d)).astype(np.float32), dtype)
    pool = (num_pages + 1, ps, h, d)
    jk, tk = _pair(rng.normal(size=pool).astype(np.float32), dtype)
    jv, tv = _pair(rng.normal(size=pool).astype(np.float32), dtype)
    assert d in tfa.PAGED_HEAD_DIMS
    for window in (None, 9):
        got = tops.paged_decode_attention(tq, tk, tv, torch.from_numpy(table), page_size=ps,
                                          length=torch.from_numpy(lens), window=window)
        assert got.shape == (b, h, d) and got.dtype == tq.dtype
        for backend in ("xla", "pallas_interpret"):
            want = jops.paged_decode_attention(jq, jk, jv, jnp.asarray(table), page_size=ps,
                                               length=jnp.asarray(lens), window=window,
                                               backend=backend, block_kv=16)
            np.testing.assert_allclose(_f32(got), _f32(want), **ATTN_TOL[dtype],
                                       err_msg=f"{backend} window {window}")


def test_dispatch_follows_the_device_with_no_fallback():
    """CPU tensors run the plain version and launch nothing; the CUDA
    wrappers refuse CPU tensors instead of computing on them; mixed or other
    devices raise."""
    a = torch.ones(4, 8)
    b = torch.ones(8, 4)
    before = brgemm.LAUNCHES
    torch.testing.assert_close(tops.matmul(a, b), torch.full((4, 4), 8.0))
    assert brgemm.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        brgemm.matmul(a, b)
    q = torch.ones(1, 2, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_decode(q[:, :, 0], q, q, length=torch.ones(1, dtype=torch.int32))
    pool = torch.ones(3, 4, 2, 16)
    table = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.paged_decode(q[:, :, 0], pool, pool, table, page_size=4,
                         length=torch.ones(1, dtype=torch.int32))
    before = tfa.PAGED_DECODE_LAUNCHES
    tops.paged_decode_attention(q[:, :, 0], pool, pool, table, page_size=4,
                                length=torch.ones(1, dtype=torch.int32))
    assert tfa.PAGED_DECODE_LAUNCHES == before
    with pytest.raises(ValueError, match="meta"):
        tops.matmul(a.to("meta"), b.to("meta"))


# ---------------------------------------------------------------------------
# Gradients: the ops' autograd Functions against jax.grad of the reference
# ---------------------------------------------------------------------------

GRAD_TOL = dict(rtol=1e-4, atol=1e-3)    # fp32 GEMM backward, K up to 48 summed


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("activation", [None, "relu", "gelu", "silu", "sigmoid"])
def test_matmul_grad_matches_jax_grad(activation, with_bias):
    """dA, dB and dbias of ``ops.matmul`` (fp32) against jax.grad of
    ``repro.kernels.ops.matmul(backend="xla")`` for one cotangent."""
    rng = np.random.default_rng(11)
    m, k, n = 24, 40, 48
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    bias = rng.normal(size=(n,)).astype(np.float32) if with_bias else None
    probe = rng.normal(size=(m, n)).astype(np.float32)

    def jloss(a_, b_, bias_):
        y = jops.matmul(a_, b_, bias=bias_, activation=activation, backend="xla")
        return jnp.sum(y * probe)

    argnums = (0, 1, 2) if with_bias else (0, 1)
    want = jax.grad(jloss, argnums=argnums)(jnp.asarray(a), jnp.asarray(b),
                                            None if bias is None else jnp.asarray(bias))
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    tbias = torch.from_numpy(bias).requires_grad_() if with_bias else None
    y = tops.matmul(ta, tb, bias=tbias, activation=activation)
    inputs = (ta, tb, tbias) if with_bias else (ta, tb)
    got = torch.autograd.grad((y * torch.from_numpy(probe)).sum(), inputs)
    for g, w, name in zip(got, want, ("a", "b", "bias")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("activation", [None, "relu", "gelu", "silu", "sigmoid"])
def test_matmul_bwd_ref_matches_jax_grad_and_the_function(activation, with_bias):
    """The plain backward ``ref.matmul_bwd_ref`` against jax.grad of
    ``repro.kernels.ops.matmul(backend="xla")`` and against the gradients
    of ``ops.matmul``'s Function, for one cotangent in fp32."""
    rng = np.random.default_rng(13)
    m, k, n = 20, 36, 44
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    bias = rng.normal(size=(n,)).astype(np.float32) if with_bias else None
    probe = rng.normal(size=(m, n)).astype(np.float32)

    def jloss(a_, b_, bias_):
        y = jops.matmul(a_, b_, bias=bias_, activation=activation, backend="xla")
        return jnp.sum(y * probe)

    argnums = (0, 1, 2) if with_bias else (0, 1)
    want = jax.grad(jloss, argnums=argnums)(jnp.asarray(a), jnp.asarray(b),
                                            None if bias is None else jnp.asarray(bias))
    tbias = torch.from_numpy(bias) if with_bias else None
    plain = tref.matmul_bwd_ref(torch.from_numpy(a), torch.from_numpy(b),
                                torch.from_numpy(probe), bias=tbias, activation=activation)
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    inputs = (ta, tb, tbias.requires_grad_()) if with_bias else (ta, tb)
    y = tops.matmul(ta, tb, bias=inputs[2] if with_bias else None, activation=activation)
    got = torch.autograd.grad((y * torch.from_numpy(probe)).sum(), inputs)
    for p, w, g, name in zip(plain, want, got, ("a", "b", "bias")):
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.numpy(), np.asarray(w), **GRAD_TOL, err_msg=name)
        np.testing.assert_allclose(g.numpy(), p.numpy(), **GRAD_TOL, err_msg=name)


def test_matmul_grad_of_fp32_master_read_transposed():
    """bf16 activations against an fp32 master weight held as a transposed
    view (the tied logits, ``embed.T``): the weight is cast at use, and its
    gradient comes back in fp32 and in the master's layout.  jax.grad of
    the reference's cast-then-matmul rounds dW to bf16 before the master
    sees it, so the tolerance is bf16's."""
    rng = np.random.default_rng(12)
    m, d, v = 16, 32, 56
    x = rng.normal(size=(m, d)).astype(np.float32)
    emb = (rng.normal(size=(v, d)) * 0.02).astype(np.float32)
    probe = rng.normal(size=(m, v)).astype(np.float32)

    def jloss(x_, e_):
        y = jops.matmul(x_.astype(jnp.bfloat16), e_.astype(jnp.bfloat16).T,
                        out_dtype=jnp.float32, backend="xla")
        return jnp.sum(y * probe)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(emb))
    tx = torch.from_numpy(x).requires_grad_()
    te = torch.from_numpy(emb).requires_grad_()
    y = tops.matmul(tx.to(torch.bfloat16), te.T, out_dtype=torch.float32)
    gx, ge = torch.autograd.grad((y * torch.from_numpy(probe)).sum(), (tx, te))
    assert ge.dtype == torch.float32 and ge.shape == (v, d)
    for g, w in ((gx, want[0]), (ge, want[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32), **GEMM_TOL["bfloat16"])


ATTN_GRAD_CASES = {  # (H, Hk, Sq, Skv, causal, window)
    "causal": (4, 4, 64, 64, True, None),
    "window": (4, 4, 64, 64, True, 24),
    "gqa": (4, 2, 64, 64, True, None),
    "sq_lt_skv": (4, 2, 32, 64, True, None),
}


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("case", sorted(ATTN_GRAD_CASES))
def test_attention_grad_matches_jax_grad(case, backend):
    """(dq, dk, dv) of ``ops.attention`` (fp32) against jax.grad of
    ``repro.fusion.fused_attention_apply``, whose backward is the six-graph
    ChainedBackwardPlan (K6's spec), in interpret mode and on XLA; the
    tolerance of ``tests/test_fusion_attention.py``."""
    h, hk, sq, skv, causal, window = ATTN_GRAD_CASES[case]
    rng = np.random.default_rng(13)
    b, d = 2, 16
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, hk, skv, d)).astype(np.float32)
    v = rng.normal(size=(b, hk, skv, d)).astype(np.float32)
    probe = rng.normal(size=(b, h, sq, d)).astype(np.float32)

    def jloss(q_, k_, v_):
        o = fusion.fused_attention_apply(q_, k_, v_, causal=causal, window=window,
                                         backend=backend)
        return jnp.sum(o.astype(jnp.float32) * probe)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = tops.attention(tq, tk, tv, causal=causal, window=window)
    got = torch.autograd.grad((o * torch.from_numpy(probe)).sum(), (tq, tk, tv))
    for g, w, name in zip(got, want, "qkv"):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_attention_fwd_lse_and_masked_rows():
    """The training forward's lse is each row's log-sum-exp of its scaled,
    masked scores; with Sq > Skv the first rows see no key: lse -inf there,
    and the backward gives those rows (and nothing else) zero gradients."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(14)
    q = torch.from_numpy(rng.normal(size=(1, 2, 10, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 2, 6, 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 2, 6, 8)).astype(np.float32))
    o, lse = ref.attention_fwd_ref(q, k, v, causal=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(8)
    rows = torch.arange(10)[:, None] - 4
    live = torch.arange(6)[None, :] <= rows
    want = torch.logsumexp(s.masked_fill(~live, float("-inf")), dim=-1)
    torch.testing.assert_close(lse[:, :, 4:], want[:, :, 4:])
    assert torch.isinf(lse[:, :, :4]).all()
    do = torch.from_numpy(rng.normal(size=o.shape).astype(np.float32))
    dq, dk, dv = ref.attention_bwd_ref(q, k, v, torch.nan_to_num(o), lse, do, causal=True)
    assert (dq[:, :, :4] == 0).all() and (dq[:, :, 4:] != 0).any()
    assert torch.isfinite(dk).all() and torch.isfinite(dv).all()
