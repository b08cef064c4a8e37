"""The port's TPP collection (``repro_torch.core.tpp``) against the
reference's (``repro.core.tpp``), mirroring ``tests/test_tpp.py``: every
unary and binary TPP of the registries, the contractions, reductions,
layout and quantization TPPs on the same numpy inputs in fp32 and bf16, and
the precision-aware contract (bf16 in, fp32 inside, bf16 out).  ``dropout``
draws from a ``torch.Generator``, whose bits cannot equal
``jax.random.bernoulli``'s: its rate, scale and determinism are checked,
not its bits.

Tolerances: fp32 rtol 1e-5 / atol 1e-5 (the same fp32 arithmetic, a
transcendental's last bits apart), bf16 rtol 2e-2 / atol 2e-2 on values of
order 1 (one bf16 rounding of the output), and the reference test's own
bounds where it states them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core import tpp as jtpp
from repro_torch.core import tpp

DTYPES = ["float32", "bfloat16"]
RNG = np.random.default_rng(1)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _pair(a, dtype):
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a, np.float32)).to(td)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def test_registries_name_the_reference_tpps():
    assert sorted(tpp.UNARY_TPPS) == sorted(jtpp.UNARY_TPPS)
    assert sorted(tpp.BINARY_TPPS) == sorted(jtpp.BINARY_TPPS)
    assert set(jtpp.__all__) <= set(tpp.__all__)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(jtpp.UNARY_TPPS))
def test_unary_tpps(name, dtype):
    x = RNG.normal(size=(8, 16)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    want, got = jtpp.UNARY_TPPS[name](jx), tpp.UNARY_TPPS[name](tx)
    assert got.dtype == tx.dtype and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    if name == "relu":
        assert (_np(got) >= 0).all()
    if name == "softmax":
        np.testing.assert_allclose(_np(got).sum(-1), 1.0, atol=2e-2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(jtpp.BINARY_TPPS))
def test_binary_tpps(name, dtype):
    x, y = RNG.normal(size=(2, 8, 16)).astype(np.float32)
    (jx, tx), (jy, ty) = _pair(x, dtype), _pair(y, dtype)
    got = tpp.BINARY_TPPS[name](tx, ty)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(jtpp.BINARY_TPPS[name](jx, jy)), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_brgemm_matches_einsum_and_reference(dtype):
    a = RNG.normal(size=(3, 8, 16)).astype(np.float32)
    b = RNG.normal(size=(3, 16, 8)).astype(np.float32)
    c0 = RNG.normal(size=(8, 8)).astype(np.float32)
    (ja, ta), (jb, tb), (jc, tc) = _pair(a, dtype), _pair(b, dtype), _pair(c0, dtype)
    out = tpp.brgemm(ta, tb, tc, beta=1.0, out_dtype=torch.float32)
    want = np.einsum("ijk,ikl->jl", _np(ta), _np(tb)) + _np(tc)
    tol = 1e-4 if dtype == "float32" else 0.35
    np.testing.assert_allclose(out.numpy(), want, atol=tol)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jtpp.brgemm(ja, jb, jc, beta=1.0, out_dtype=jnp.float32)),
        rtol=1e-5, atol=1e-4)
    # batch-reduce count 1, beta 0 and the default output dtype
    g = tpp.gemm(ta[0], tb[0], tc, beta=0.0)
    assert g.dtype == tc.dtype
    np.testing.assert_allclose(_np(g), _np(jtpp.gemm(ja[0], jb[0], jc, beta=0.0)), **TOL[dtype])
    np.testing.assert_allclose(_np(tpp.brgemm(ta[1], tb[1])), _np(jtpp.brgemm(ja[1], jb[1])),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_reductions_scale_and_casts(dtype):
    x = RNG.normal(size=(4, 24)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    for axis in (-1, 0):
        for keep in (True, False):
            for name in ("reduce_sum", "reduce_max"):
                got = getattr(tpp, name)(tx, axis=axis, keepdims=keep)
                want = getattr(jtpp, name)(jx, axis=axis, keepdims=keep)
                assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tpp.softmax(tx, axis=0)), _np(jtpp.softmax(jx, axis=0)),
                               **TOL[dtype])
    np.testing.assert_allclose(_np(tpp.scale(tx, 0.37)), _np(jtpp.scale(jx, 0.37)), **TOL[dtype])
    assert tpp.scale(tx, 2.0).dtype == tx.dtype
    assert tpp.cast(tx, torch.float32).dtype == torch.float32
    assert tpp.identity(tx).dtype == tx.dtype
    assert tpp.identity(tx, torch.bfloat16).dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(tpp.identity(tx)), _np(jtpp.identity(jx)))
    z = tpp.zero((3, 5), torch.bfloat16)
    assert z.dtype == torch.bfloat16 and not z.any()
    assert tpp.zero((2,)).dtype == torch.float32


@pytest.mark.parametrize("dtype", DTYPES)
def test_residual_and_bias_add(dtype):
    x, r = RNG.normal(size=(2, 6, 10)).astype(np.float32)
    bias = RNG.normal(size=(10,)).astype(np.float32)
    (jx, tx), (jr, tr), (jb, tb) = _pair(x, dtype), _pair(r, dtype), _pair(bias, dtype)
    np.testing.assert_allclose(_np(tpp.residual_add(tx, tr)), _np(jtpp.residual_add(jx, jr)),
                               **TOL[dtype])
    np.testing.assert_allclose(_np(tpp.bias_add(tx, tb)), _np(jtpp.bias_add(jx, jb)), **TOL[dtype])


def test_layernorm_rmsnorm_stats():
    x = RNG.normal(size=(4, 64)).astype(np.float32) * 10 + 3
    tx = torch.from_numpy(x)
    g, b = torch.ones(64), torch.zeros(64)
    y = tpp.layernorm(tx, g, b).numpy()
    np.testing.assert_allclose(y.mean(-1), 0.0, atol=1e-4)
    np.testing.assert_allclose(y.std(-1), 1.0, atol=1e-2)
    np.testing.assert_allclose(y, np.asarray(jtpp.layernorm(jnp.asarray(x), jnp.ones(64),
                                                            jnp.zeros(64))), rtol=1e-5, atol=1e-5)
    yr = tpp.rmsnorm(tx, g).numpy()
    ms = (yr ** 2).mean(-1)
    np.testing.assert_allclose(ms, ms.mean(), rtol=0.2)
    np.testing.assert_allclose(yr, np.asarray(jtpp.rmsnorm(jnp.asarray(x), jnp.ones(64))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lanes", [2, 4])
def test_vnni_pack_roundtrip_and_layout(lanes):
    x = RNG.normal(size=(16, 8)).astype(np.float32)
    packed = tpp.vnni_pack(torch.from_numpy(x), lanes)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jtpp.vnni_pack(jnp.asarray(x), lanes)))
    np.testing.assert_array_equal(tpp.vnni_unpack(packed).numpy(), x)
    np.testing.assert_array_equal(tpp.transpose(torch.from_numpy(x)).numpy(), x.T)


def test_dropout_deterministic_and_scaling():
    x = torch.ones(64, 64)
    gen = torch.Generator().manual_seed(0)
    y = tpp.dropout(x, gen, 0.5)
    kept = y.numpy() != 0
    assert 0.3 < kept.mean() < 0.7
    np.testing.assert_allclose(y.numpy()[kept], 2.0)
    # the reference's draw keeps about as many; its bits differ
    jy = np.asarray(jtpp.dropout(jnp.ones((64, 64)), jax.random.PRNGKey(0), 0.5))
    assert abs((jy != 0).mean() - kept.mean()) < 0.1
    assert torch.equal(tpp.dropout(x, gen, 0.5, deterministic=True), x)
    assert torch.equal(tpp.dropout(x, gen, 0.0), x)
    # the same generator state gives the same mask
    a = tpp.dropout(x, torch.Generator().manual_seed(7), 0.3)
    b = tpp.dropout(x, torch.Generator().manual_seed(7), 0.3)
    assert torch.equal(a, b)
    yb = tpp.dropout(x.to(torch.bfloat16), torch.Generator().manual_seed(1), 0.25)
    assert yb.dtype == torch.bfloat16
    np.testing.assert_allclose(yb.float().numpy()[yb.float().numpy() != 0], 1 / 0.75, rtol=1e-2)


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=20, deadline=None)
def test_property_quantize_int8_bounded_error(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, 64)).astype(np.float32) * rng.uniform(0.01, 100)
    q, scale = tpp.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    deq = tpp.dequantize_int8(q, scale)
    err = np.abs(deq.numpy() - x)
    bound = np.broadcast_to(scale.numpy() * 0.51 + 1e-9, err.shape)
    np.testing.assert_array_less(err, bound)
    jq, jscale = jtpp.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


def test_quantize_int8_zero_slice_and_axis():
    x = np.zeros((3, 8), np.float32)
    x[1] = RNG.normal(size=8)
    for axis in (-1, 0):
        q, scale = tpp.quantize_int8(torch.from_numpy(x), axis=axis)
        jq, jscale = jtpp.quantize_int8(jnp.asarray(x), axis=axis)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert tpp.dequantize_int8(q, scale, torch.bfloat16).dtype == torch.bfloat16


def test_gelu_grad_matches_autodiff_and_reference():
    x = RNG.normal(size=(32,)).astype(np.float32)
    tx = torch.from_numpy(x).requires_grad_()
    tpp.gelu(tx).sum().backward()
    manual = tpp.gelu_grad(torch.ones(32), torch.from_numpy(x))
    np.testing.assert_allclose(tx.grad.numpy(), manual.numpy(), atol=1e-4)
    want = jtpp.gelu_grad(jnp.ones(32), jnp.asarray(x))
    np.testing.assert_allclose(manual.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_relu_grad_matches_reference(dtype):
    g, x = RNG.normal(size=(2, 5, 7)).astype(np.float32)
    (jg, tg), (jx, tx) = _pair(g, dtype), _pair(x, dtype)
    got = tpp.relu_grad(tg, tx)
    assert got.dtype == tg.dtype
    np.testing.assert_array_equal(_np(got), _np(jtpp.relu_grad(jg, jx)))
    np.testing.assert_allclose(_np(tpp.gelu_grad(tg, tx)), _np(jtpp.gelu_grad(jg, jx)), **TOL[dtype])
