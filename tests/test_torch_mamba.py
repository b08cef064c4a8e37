"""The port's selective scan (K8's plain version, ``kernels.ops.mamba_scan``
on the CPU) against the JAX reference: the Pallas kernel in interpret mode
at several chunk sizes, its state-continuation contract, the reference's
chunked XLA scan, and bf16 inputs; plus what the Mamba-1 slice needs around
it: the scan's seven gradients against ``jax.grad`` of the reference's
scans, ``h_out`` refusing a gradient, fp32 mamba parameters after
conversion, and the CUDA wrapper refusing CPU tensors.

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
from repro_torch.kernels import ref as tref
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


def _grad_inputs(seed, b, l, d, n, dtype, with_h0):
    """The scan's operands as numpy (x, dt, b_in, c_in rounded to
    ``dtype``), h0 or None, and cotangents for y (in ``dtype``) and h."""
    args = _inputs(seed, b, l, d, n)
    rng = np.random.default_rng(seed + 100)
    h0 = rng.normal(size=(b, d, n)).astype(np.float32) if with_h0 else None
    dy = rng.normal(size=(b, l, d)).astype(np.float32)
    dh = rng.normal(size=(b, d, n)).astype(np.float32)
    if dtype == "bfloat16":
        rnd = lambda v: np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
        args = [rnd(v) if i in (0, 1, 3, 4) else v for i, v in enumerate(args)]
        dy = rnd(dy)
    return args, h0, dy, dh


@pytest.mark.parametrize("cotangent", ["y", "y_and_h"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l, oracle", [(32, "ref"), (128, "chunked"), (96, "chunked")])
def test_scan_gradients_match_jax_grad(l, oracle, dtype, with_h0, cotangent):
    """All seven gradients of ``ops.mamba_scan`` (``_MambaScan`` on the CPU:
    ``mamba_scan_ref`` as one chunk at L 32, ``mamba_scan_chunked`` at L 128
    and 96, which the 64-step chunk does not divide, then
    ``mamba_scan_bwd_ref``) against ``jax.grad`` of the reference's
    ``mamba_scan_ref`` and ``mamba_scan_xla_chunked``: fp32 at (1e-4,
    1e-3), bf16 at (2e-2, 2e-1) (both sides compute in fp32 from the same
    bf16 values and round each gradient of a bf16 input once)."""
    tol = dict(rtol=1e-4, atol=1e-3) if dtype == "float32" else dict(rtol=2e-2, atol=2e-1)
    args, h0, dy, dh = _grad_inputs(20 + l, 2, l, 16, 8, dtype, with_h0)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jargs = [jnp.asarray(v, jdt if i in (0, 1, 3, 4) else jnp.float32)
             for i, v in enumerate(args)]
    fn = jref.mamba_scan_ref if oracle == "ref" else jref.mamba_scan_xla_chunked
    jh0 = jnp.zeros((2, 16, 8), jnp.float32) if h0 is None else jnp.asarray(h0)
    (jy, jh), vjp = jax.vjp(lambda *p: fn(*p[:6], h0=p[6]), *jargs, jh0)
    jdh = jnp.asarray(dh) if cotangent == "y_and_h" else jnp.zeros_like(jh)
    want = vjp((jnp.asarray(dy, jdt), jdh))

    targs = [torch.tensor(v, dtype=tdt if i in (0, 1, 3, 4) else torch.float32,
                          requires_grad=True) for i, v in enumerate(args)]
    th0 = None if h0 is None else torch.tensor(h0, requires_grad=True)
    y, h = tops.mamba_scan(*targs, h0=th0)
    np.testing.assert_allclose(y.detach().float().numpy(), np.asarray(jy, np.float32), **tol)
    outs, cots = [y], [torch.tensor(dy, dtype=tdt)]
    if cotangent == "y_and_h":
        outs, cots = [y, h], cots + [torch.tensor(dh)]
    leaves = targs + ([th0] if th0 is not None else [])
    grads = torch.autograd.grad(outs, leaves, cots)
    names = ["dx", "ddt", "da", "db", "dc", "dd", "dh0"]
    for name, g, t, w in zip(names, grads, leaves, want):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **tol,
                                   err_msg=name)


def test_chunked_plain_scan_differentiates_through_its_checkpoints():
    """``ref.mamba_scan_chunked`` under autograd (each chunk's body
    checkpointed, as the reference's ``jax.checkpoint``): its gradients
    equal ``jax.grad`` of ``mamba_scan_xla_chunked`` at L 96 from h0, and
    those of ``ops.mamba_scan``'s backward kernel spec."""
    args, h0, dy, dh = _grad_inputs(40, 2, 96, 16, 8, "float32", True)
    jargs = [jnp.asarray(v) for v in args] + [jnp.asarray(h0)]
    _, vjp = jax.vjp(lambda *p: jref.mamba_scan_xla_chunked(*p[:6], h0=p[6]), *jargs)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    leaves = [torch.tensor(v, requires_grad=True) for v in args + [h0]]
    y, h = tref.mamba_scan_chunked(*leaves[:6], h0=leaves[6])
    got = torch.autograd.grad([y, h], leaves, [torch.tensor(dy), torch.tensor(dh)])
    y2, h2 = tops.mamba_scan(*leaves[:6], h0=leaves[6])
    spec = torch.autograd.grad([y2, h2], leaves, [torch.tensor(dy), torch.tensor(dh)])
    for name, g, s, w in zip(["dx", "ddt", "da", "db", "dc", "dd", "dh0"], got, spec, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-3, err_msg=name)
        np.testing.assert_allclose(g.numpy(), s.numpy(), rtol=1e-4, atol=1e-3, err_msg=name)


def test_scan_with_h_out_refuses_a_gradient():
    """``h_out`` (a cache updated in place) is for serving: with a gradient
    wanted it raises; without one the call is unchanged."""
    x, dt, a, bi, ci, d = _torch(_inputs(5, 1, 4, 8, 4))
    h = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="serving"):
        tops.mamba_scan(x.clone().requires_grad_(), dt, a, bi, ci, d, h0=h, h_out=h)
    with torch.no_grad():
        y, hf = tops.mamba_scan(x.clone().requires_grad_(), dt, a, bi, ci, d, h0=h, h_out=h)
    assert hf is h and not y.requires_grad


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
