"""The attention backward of ``csrc/attention_bwd.cuh`` (K6 and K5's chained
backward) on the CPU: its plain version, ``kernels.ref.flash_bwd_ref`` on a
chained graph's own epilogue (``fusion.autodiff.chained_epilogue``), against
``jax.grad`` of ``repro``'s ``fused_attention_apply`` (its
``compile_with_vjp`` of ``fused_attention_graph``, six derived graphs) on
XLA and in interpret-mode Pallas; rows with every key masked; and the
backward source K5 generates per chained graph and head dim, without nvcc.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: fp32 rtol 1e-4 / atol 1e-3 (products summed in another order,
P rebuilt from the row log-sum-exp instead of the softmax panel), bf16 rtol
2e-2 / atol 2e-1 (bf16 inputs, fp32 accumulation, the reference's bf16
cotangents).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fusion as jf
from repro_torch import fusion as tf
from repro_torch.fusion import autodiff as tad
from repro_torch.fusion.graph import FusionLegalityError
from repro_torch.kernels import fused_gemm
from repro_torch.kernels import ref as tref

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=1e-4, atol=1e-3), "bfloat16": dict(rtol=2e-2, atol=2e-1)}
D = 16
# name: (causal, window, Sq, Skv, H, Hk)
CASES = {"causal": (True, 0, 32, 32, 2, 2), "window": (True, 8, 32, 32, 2, 2),
         "offset": (True, 0, 24, 40, 2, 2), "bidirectional": (False, 0, 32, 32, 2, 2),
         "gqa": (True, 0, 32, 32, 4, 2)}


def _inputs(case, dtype, seed=5):
    causal, window, sq, skv, h, hk = CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(1, hh, s, D)).astype(np.float32)
               for hh, s in ((h, sq), (hk, skv), (hk, skv)))
    dy = rng.normal(size=(1, h, sq, D)).astype(np.float32)
    tdt = DTYPES[dtype][1]
    return (q, k, v, dy), tuple(torch.from_numpy(x).to(tdt) for x in (q, k, v)), \
        torch.from_numpy(dy)


def _graph(f, case):
    causal, window, sq, skv, _, _ = CASES[case]
    return f.fused_attention_graph(causal=causal, window=window, scale=D ** -0.5, offset=skv - sq)


def _forward(plan, q, k, v):
    """The chained forward's output and row log-sum-exp, in fp32, from the
    plain versions (the composed reference and the graph's own ``pre``)."""
    pre, _ = tad.chained_epilogue(plan)
    g = q.shape[1] // k.shape[1]
    kq, vq = (t.repeat_interleave(g, dim=1).float() for t in (k, v))
    z = pre(torch.einsum("bhqd,bhkd->bhqk", q.float(), kq))
    live = z > -1e29
    lse = torch.where(live.any(-1), torch.logsumexp(torch.where(live, z, -torch.inf), -1),
                      -torch.inf)
    o = tf.compile_for_device(plan.forward, out_dtype=torch.float32)(q=q.float(), k=kq, v=vq)
    return o, lse


def _plain_grads(case, dtype):
    (qn, kn, vn, dyn), (q, k, v), dy = _inputs(case, dtype)
    plan = tad.derive_vjp(_graph(tf, case))
    o, lse = _forward(plan, q, k, v)
    pre, grad = tad.chained_epilogue(plan)
    return tref.flash_bwd_ref(q, k, v, o, lse, dy, pre=pre, grad=grad)


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_identity_matches_the_reference_gradient(case, dtype, backend):
    causal, window, *_ = CASES[case]
    (qn, kn, vn, dyn), _, _ = _inputs(case, dtype)
    jdt = DTYPES[dtype][0]

    def loss(q, k, v):
        o = jf.fused_attention_apply(q, k, v, causal=causal, window=window or None,
                                     scale=D ** -0.5, backend=backend)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(dyn))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x, jdt) for x in (qn, kn, vn)))
    got = _plain_grads(case, dtype)
    for g, w, nm in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32), err_msg=nm, **TOL[dtype])


def test_k6_plain_version_is_the_flash_identity_on_its_epilogue():
    """``attention_bwd_ref`` (K6's plain version) equals ``flash_bwd_ref``
    on the chained graph of the same masks and scale."""
    for case in sorted(CASES):
        causal, window, *_ = CASES[case]
        _, (q, k, v), dy = _inputs(case, "float32")
        plan = tad.derive_vjp(_graph(tf, case))
        o, lse = _forward(plan, q, k, v)
        got = tref.attention_bwd_ref(q, k, v, o, lse, dy, causal=causal, window=window or None,
                                     scale=D ** -0.5)
        for g, w in zip(got, _plain_grads(case, "float32")):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_chained_backward_plain_takes_the_graphs_operand_shapes():
    """``ChainedBackward.plain`` on 2-D and (B, H)-batched operands gives the
    same per-problem gradients."""
    _, (q, k, v), dy = _inputs("window", "float32")
    plan = tad.derive_vjp(_graph(tf, "window"))
    o, lse = _forward(plan, q, k, v)
    kernel = fused_gemm.ChainedBackward(plan)
    whole = kernel.plain(q, k, v, o, lse, dy)
    for hi in range(q.shape[1]):
        one = kernel.plain(q[0, hi], k[0, hi], v[0, hi], o[0, hi], lse[0, hi], dy[0, hi])
        for g, w in zip(one, whole):
            assert g.shape == w[0, hi].shape
            torch.testing.assert_close(g, w[0, hi], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["causal", "bidirectional"])
def test_flash_identity_equals_the_six_derived_graphs(case):
    """From an fp32 forward output, the flash identity (D = rowsum(dO * O))
    gives the six derived graphs' gradients (D = rowsum(P * dP) from their
    panels): the card's chained backward and the CPU path differ only by
    the output's rounding in D."""
    _, (q, k, v), dy = _inputs(case, "float32")
    plan = tad.derive_vjp(_graph(tf, case))
    o, lse = _forward(plan, q, k, v)
    got = fused_gemm.ChainedBackward(plan).plain(q, k, v, o, lse, dy)
    six = tad._run_backward_chained(plan, {"q": q, "k": k, "v": v}, dy)
    for g, nm in zip(got, "qkv"):
        torch.testing.assert_close(g, six[nm], rtol=1e-5, atol=1e-5)


def test_rows_with_no_key_get_zero_gradients():
    """Causal with Sq 12 > Skv 8 (offset -4): rows 0..3 see no key.  The
    backward follows K2 and K6 (lse = -inf, the kernel's output 0): those
    rows' dq is 0 and they add nothing to dk and dv.  The reference's
    composed path differentiates a uniform softmax over the masked keys
    there instead (ROADMAP.md Queue 3), so its dk and dv differ."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, s, D)).astype(np.float32))
               for s in (12, 8, 8))
    dy = torch.from_numpy(rng.normal(size=(1, 2, 12, D)).astype(np.float32))
    plan = tad.derive_vjp(tf.fused_attention_graph(causal=True, scale=0.25, offset=-4))
    o, lse = _forward(plan, q, k, v)
    assert torch.isinf(lse[..., :4]).all() and torch.isfinite(lse[..., 4:]).all()
    pre, grad = tad.chained_epilogue(plan)
    dq, dk, dv = tref.flash_bwd_ref(q, k, v, o, lse, dy, pre=pre, grad=grad)
    assert (dq[..., :4, :] == 0).all() and (dq[..., 4:, :] != 0).any()
    dy_live = dy.clone()
    dy_live[..., :4, :] = 0.0
    _, dk2, dv2 = tref.flash_bwd_ref(q, k, v, o, lse, dy_live, pre=pre, grad=grad)
    torch.testing.assert_close((dk, dv), (dk2, dv2), rtol=0, atol=0)
    # the six derived graphs (the CPU path of compile_with_vjp): a uniform row
    leaves = [t[0, 0].clone().requires_grad_(True) for t in (q, k, v)]
    out = tf.compile_with_vjp(plan.forward)(q=leaves[0], k=leaves[1], v=leaves[2])
    (out * dy[0, 0]).sum().backward()
    assert not torch.allclose(leaves[2].grad, dv[0, 0])


# --------------------------------------------------------------------------
# The generated backward source, without nvcc
# --------------------------------------------------------------------------

GENERATED = {
    "causal": (lambda: tf.fused_attention_graph(causal=True, scale=0.125),
               ["return n0 > m0 + bm - 1 + 0;", "fg_attn_keep(gm, gn, true, 0, 0) ? dz : 0.0f"]),
    "window": (lambda: tf.fused_attention_graph(causal=True, window=256, scale=0.125),
               ["return n0 > m0 + bm - 1 + 0 || n0 + bn - 1 <= m0 + 0 - 256;",
                "fg_attn_keep(gm, gn, true, 256, 0)"]),
    "bidirectional": (lambda: tf.fused_attention_graph(causal=False, scale=0.125),
                      ["return false;", "const float v_b1_scale = dz * 0x1.0000000000000p-3f;"]),
}


@pytest.mark.parametrize("case", sorted(GENERATED))
def test_generated_backward_source(case):
    make, markers = GENERATED[case]
    plan = tad.derive_vjp(make())
    src = fused_gemm.generate_backward_source(plan, 64)
    assert src == fused_gemm.generate_backward_source(plan, 64)
    assert '#include "attention_bwd.cuh"' in src and "attn_bwd::entry<Epi, 64>" in src
    assert 'extern "C" int attention_bwd(' in src and "softmax_grad" in src
    for marker in markers:
        assert marker in src, marker
    # the same structure under another name shares the source; another head
    # dim has its own
    renamed = tad.derive_vjp(dataclasses.replace(tf.simplify_graph(make()), name="other"))
    assert fused_gemm.generate_backward_source(renamed, 64) == src
    assert "attn_bwd::entry<Epi, 256>" in fused_gemm.generate_backward_source(plan, 256)
    kernel = fused_gemm.ChainedBackward(plan)
    assert kernel.name == plan.forward.name + "@bwd_flash"
    assert fused_gemm.backward_source_name(kernel.source(64)) == \
        fused_gemm.backward_source_name(src)


def test_generated_backward_refusals():
    plan = tad.derive_vjp(tf.fused_attention_graph(causal=True, scale=0.125))
    with pytest.raises(FusionLegalityError) as e:
        fused_gemm.generate_backward_source(plan, 48)
    assert e.value.code == "TPP228"
    g = tf.fused_attention_graph(causal=True, scale=0.125)
    ops = tuple(dataclasses.replace(o, trans=False) if o.name == "k" else o for o in g.operands)
    untransposed = tad.derive_vjp(dataclasses.replace(g, operands=ops))
    with pytest.raises(FusionLegalityError) as e:
        fused_gemm.ChainedBackward(untransposed)
    assert e.value.code == "TPP228"
