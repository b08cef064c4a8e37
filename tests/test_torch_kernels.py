"""The port's kernel API on the CPU (the plain PyTorch versions of K1, K2, K3
and K4) against the JAX reference (``backend="xla"``) and the JAX Pallas kernels
in interpret mode, on the same numpy-seeded inputs.

Tolerances are those of ``tests/test_kernels.py``: fp32 GEMM rtol 1e-4 /
atol 1e-3 (K up to 64 fp32 products summed in another order), fp32 attention
1e-4 (softmax of O(1) scores, summed in another order), and bf16 rtol 2e-2 /
atol 2e-1 (one bf16 rounding of the output is 2^-8 relative, and the Pallas
kernels round p or intermediate tiles at other places).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_pallas, flash_decode_pallas
from repro_torch.kernels import brgemm
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops

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
