"""The port's Listing 6 layer (K7's plain version, ``kernels.fused_output``
on the CPU) against the JAX reference's Pallas kernel in interpret mode and
its oracle, for fp32 and bf16 inputs with and without dropout (the same
numpy-seeded keep mask on both sides), and against the port's own fused
TppGraph form (``fusion.library.fused_output_apply`` with a keep mask);
plus the wrapper's refusals.

Tolerances are ``tests/test_kernels.py``'s ``_tol``: fp32 rtol 1e-4 / atol
1e-3, bf16 rtol 2e-2 / atol 2e-1 (bf16 inputs, a bf16 output, layernormed
values of order 1 times gamma).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_output import fused_output_pallas
from repro.kernels.fused_output import fused_output_ref as jfused_output_ref
from repro_torch.fusion import library as flib
from repro_torch.kernels import fused_output as tfo

F32_TOL = dict(rtol=1e-4, atol=1e-3)
BF16_TOL = dict(rtol=2e-2, atol=2e-1)


def _inputs(seed, m=64, k=128, n=256, rate=0.0):
    rng = np.random.default_rng(seed)
    return dict(x=rng.normal(size=(m, k)).astype(np.float32),
                w=rng.normal(size=(k, n)).astype(np.float32),
                bias=rng.normal(size=(n,)).astype(np.float32),
                residual=rng.normal(size=(m, n)).astype(np.float32),
                gamma=rng.normal(size=(n,)).astype(np.float32),
                beta=rng.normal(size=(n,)).astype(np.float32),
                keep_mask=rng.random((m, n)) > rate)


def _jax(arrays, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    cast = ("x", "w", "residual")
    return {k: jnp.asarray(v, jdt) if k in cast else jnp.asarray(v) for k, v in arrays.items()}


def _torch(arrays, dtype):
    tdt = getattr(torch, dtype)
    cast = ("x", "w", "residual")
    return {k: torch.from_numpy(v).to(tdt) if k in cast else torch.from_numpy(v)
            for k, v in arrays.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_fused_output_matches_pallas(dtype, dropout):
    arrays = _inputs(int(dropout * 10) + len(dtype), rate=dropout)
    ja, ta = _jax(arrays, dtype), _torch(arrays, dtype)
    want = fused_output_pallas(**ja, dropout_rate=dropout, bm=16, bk=32, bn=64, interpret=True)
    oracle = jfused_output_ref(**ja, dropout_rate=dropout)
    got = tfo.fused_output(**ta, dropout_rate=dropout)
    plain = tfo.fused_output_ref(**ta, dropout_rate=dropout)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), plain.float().numpy())
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(oracle, np.float32), **tol)


def test_fused_output_fp32_out_from_bf16_inputs():
    arrays = _inputs(3, rate=0.1)
    ja, ta = _jax(arrays, "bfloat16"), _torch(arrays, "bfloat16")
    want = jfused_output_ref(**ja, dropout_rate=0.1, out_dtype=jnp.float32)
    got = tfo.fused_output(**ta, dropout_rate=0.1, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_fused_output_matches_the_fused_graph(dropout):
    """K7's plain version against the port's K5 form of the same layer,
    ``fused_output_apply`` with the same keep mask (its composed reference
    path on the CPU)."""
    ta = _torch(_inputs(4, m=48, k=64, n=96, rate=dropout), "float32")
    got = tfo.fused_output(**ta, dropout_rate=dropout)
    fused = flib.fused_output_apply(**ta, dropout_rate=dropout)
    np.testing.assert_allclose(got.numpy(), fused.detach().float().numpy(), **F32_TOL)


def test_fused_output_without_a_mask_does_not_drop():
    ta = _torch(_inputs(5, m=16, k=32, n=64), "float32")
    mask = ta.pop("keep_mask")
    no_mask = tfo.fused_output(**ta, dropout_rate=0.5)
    np.testing.assert_array_equal(no_mask.numpy(), tfo.fused_output(**ta).numpy())
    dropped = tfo.fused_output(**ta, keep_mask=mask, dropout_rate=0.5)
    assert not torch.equal(dropped, no_mask)


def test_fused_output_refuses_mixed_devices():
    ta = _torch(_inputs(6, m=16, k=32, n=64), "float32")
    ta["residual"] = ta["residual"].to("meta")
    with pytest.raises(ValueError, match="cpu or all on cuda"):
        tfo.fused_output(**ta)
