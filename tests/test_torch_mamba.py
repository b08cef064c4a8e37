"""The port's selective scan (K8's plain version, ``kernels.ops.mamba_scan``
on the CPU) against the JAX reference: the Pallas kernel in interpret mode
at several chunk sizes, its state-continuation contract, the reference's
chunked XLA scan, and bf16 inputs; plus what the Mamba-1 slice needs around
it: fp32 mamba parameters after conversion, no gradient through the scan,
and the CUDA wrapper refusing CPU tensors.

Tolerances: fp32 atol 1e-4 over 64-128 steps (``tests/test_kernels.py``:
the same fp32 recurrence, products and exponentials rounded in another
order); bf16 inputs rtol 1e-2 / atol 1e-2 (both sides compute in fp32 from
the same bf16 inputs and differ by the output's one bf16 rounding, 2^-8
relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.mamba_scan import mamba_scan_pallas
from repro.models import lm as jlm
from repro_torch.configs.base import get_config as torch_config
from repro_torch.kernels import mamba_scan as tscan
from repro_torch.kernels import ops as tops
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_numpy

F32_ATOL = 1e-4
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def _inputs(seed, b, l, d, n):
    """x, dt (positive), a (negative), b_in, c_in, d_skip as fp32 numpy."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, l, d)).astype(np.float32),
            (0.1 + rng.random((b, l, d))).astype(np.float32),
            (-rng.random((d, n))).astype(np.float32),
            rng.normal(size=(b, l, n)).astype(np.float32),
            rng.normal(size=(b, l, n)).astype(np.float32),
            rng.normal(size=(d,)).astype(np.float32)]


def _torch(args, dtype=torch.float32):
    """x, dt, b_in, c_in in ``dtype``; a and d_skip fp32."""
    x, dt, a, bi, ci, d = (torch.from_numpy(v) for v in args)
    return x.to(dtype), dt.to(dtype), a, bi.to(dtype), ci.to(dtype), d


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_scan_matches_pallas_chunks(chunk):
    args = _inputs(0, 2, 64, 16, 8)
    y, h = tops.mamba_scan(*_torch(args))
    jy, jh = mamba_scan_pallas(*map(jnp.asarray, args), chunk=chunk, interpret=True)
    assert y.shape == (2, 64, 16) and h.shape == (2, 16, 8) and h.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=F32_ATOL)


def test_scan_state_continuation():
    """Two calls carrying the state equal one full pass (the decode
    contract), and equal the Pallas kernel's two calls."""
    args = _inputs(1, 1, 32, 8, 4)
    x, dt, a, bi, ci, d = _torch(args)
    y_full, h_full = tops.mamba_scan(x, dt, a, bi, ci, d)
    jx, jdt, ja, jbi, jci, jd = map(jnp.asarray, args)
    h = jh = None
    for sl in (slice(0, 16), slice(16, 32)):
        y, h = tops.mamba_scan(x[:, sl], dt[:, sl], a, bi[:, sl], ci[:, sl], d, h0=h)
        jy, jh = mamba_scan_pallas(jx[:, sl], jdt[:, sl], ja, jbi[:, sl], jci[:, sl], jd,
                                   h0=jh, chunk=8, interpret=True)
        np.testing.assert_allclose(y.numpy(), y_full[:, sl].numpy(), atol=F32_ATOL)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_ATOL)
    np.testing.assert_allclose(h.numpy(), h_full.numpy(), atol=F32_ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=F32_ATOL)


def test_scan_matches_chunked_xla_with_state():
    """L 128 takes the reference's chunked XLA path (``ops.mamba_scan``,
    L > 64); from a nonzero state, the state left unmodified."""
    args = _inputs(2, 2, 128, 24, 16)
    h0 = np.random.default_rng(3).normal(size=(2, 24, 16)).astype(np.float32)
    th0 = torch.from_numpy(h0)
    y, h = tops.mamba_scan(*_torch(args), h0=th0)
    jy, jh = jops.mamba_scan(*map(jnp.asarray, args), h0=jnp.asarray(h0), backend="xla")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=F32_ATOL)
    np.testing.assert_array_equal(th0.numpy(), h0)


def test_scan_writes_state_in_place():
    """``h_out=h0`` (a cache's state) leaves the reference's final state in
    that tensor and returns it."""
    args = _inputs(7, 2, 80, 24, 16)
    h0 = np.random.default_rng(8).normal(size=(2, 24, 16)).astype(np.float32)
    cache_h = torch.from_numpy(h0.copy())
    y, h = tops.mamba_scan(*_torch(args), h0=cache_h, h_out=cache_h)
    jy, jh = jops.mamba_scan(*map(jnp.asarray, args), h0=jnp.asarray(h0), backend="xla")
    assert h is cache_h
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_ATOL)
    np.testing.assert_allclose(cache_h.numpy(), np.asarray(jh), atol=F32_ATOL)


def test_scan_bf16_inputs_match_reference():
    """bf16 x, dt, B and C (the served path's dtypes): y in bf16, the state
    in fp32, against the reference's oracle on the same bf16 values."""
    args = _inputs(4, 2, 48, 32, 16)
    x, dt, a, bi, ci, d = _torch(args, torch.bfloat16)
    y, h = tops.mamba_scan(x, dt, a, bi, ci, d)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    jargs = [jnp.asarray(t.float().numpy(), jnp.bfloat16) if t.dtype == torch.bfloat16
             else jnp.asarray(t.numpy()) for t in (x, dt, a, bi, ci, d)]
    jy, jh = jref.mamba_scan_ref(*jargs)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32), **BF16_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **BF16_TOL)


def test_scan_raises_when_a_gradient_is_wanted():
    x, dt, a, bi, ci, d = _torch(_inputs(5, 1, 4, 8, 4))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.mamba_scan(x.requires_grad_(), dt, a, bi, ci, d)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.mamba_scan(x.detach(), dt, a.requires_grad_(), bi, ci, d)
    with torch.no_grad():
        tops.mamba_scan(x, dt, a, bi, ci, d)


def test_cuda_wrapper_refuses_cpu_tensors():
    before = tscan.SCAN_LAUNCHES
    args = _torch(_inputs(6, 1, 4, 8, 4))
    tops.mamba_scan(*args)
    assert tscan.SCAN_LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        tscan.mamba_scan(*args)


def test_conversion_keeps_mamba_parameters_fp32():
    """bf16 serving parameters keep ``dt_bias``, ``a_log`` and ``d_skip``
    (and the norms) in fp32, bit for bit; the projections and conv take
    bf16.  ``init_params`` stores the same dtypes and values."""
    jcfg = jax_config("falcon_mamba_7b").reduced()
    tcfg = torch_config("falcon_mamba_7b").reduced()
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu",
                                dtype=torch.bfloat16)
    ref_layer0 = jax.tree.map(lambda a: np.asarray(a[0]), jparams["groups"][0][0])
    drawn = tlm.init_params(tcfg, device="cpu", dtype=torch.bfloat16)
    for params in (tparams, drawn):
        layer = params["layers"][0]
        m = layer["mamba"]
        for key in ("dt_bias", "a_log", "d_skip"):
            assert m[key].dtype == torch.float32, key
        for key in ("w_in", "conv_w", "conv_b", "w_x", "w_dt", "w_out"):
            assert m[key].dtype == torch.bfloat16, key
        assert layer["norm1"]["scale"].dtype == torch.float32
    for key in ("dt_bias", "a_log", "d_skip"):
        np.testing.assert_array_equal(tparams["layers"][0]["mamba"][key].numpy(),
                                      ref_layer0["mamba"][key])
        # torch.log and jnp.log may round log(n) one ulp apart
        np.testing.assert_allclose(drawn["layers"][0]["mamba"][key].numpy(),
                                   ref_layer0["mamba"][key], rtol=1e-7, atol=0)
