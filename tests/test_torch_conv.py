"""The port's Listing 1 (``ops.brgemm_blocked``, K11's plain version on the
CPU), its spec-scheduled K1 (``ops.matmul(spec_string=...)``) and its
convolutions (``kernels/conv.py``: ``block_conv_tensors``,
``conv2d_parlooper`` on the executor, ``conv2d_1x1`` (K12) and
``ops.conv2d``) against the JAX reference: the Pallas kernels in interpret
mode (``brgemm_blocked_pallas``, ``matmul_pallas``, ``ops.conv2d`` under
``use_backend("pallas_interpret")``) and the oracles, over spec strings and
``k_step``s; the same illegal schedules raise the same codes on the CPU as
the card would; the one deliberate difference (K11 rounds once, the
reference's kernel after every visit) is pinned.

Tolerances are ``tests/test_kernels.py``'s: fp32 rtol 1e-4 / atol 1e-3
(fp32 sums in another order), bf16 rtol 2e-2 / atol 2e-1 (one bf16
rounding of outputs up to about 10).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.loops import LegalityError as JLegalityError
from repro.kernels import conv as jconv
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.brgemm import brgemm_blocked_pallas, matmul_pallas
from repro_torch.core.legality import LegalityError
from repro_torch.kernels import brgemm, conv, ops, ref

F32_TOL = dict(rtol=1e-4, atol=1e-3)
BF16_TOL = dict(rtol=2e-2, atol=2e-1)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# Listing 1: brgemm_blocked
# ---------------------------------------------------------------------------

RNG = np.random.default_rng(18)
A = RNG.normal(size=(4, 6, 8, 16)).astype(np.float32)     # tests/test_kernels.py's shapes
B = RNG.normal(size=(3, 6, 16, 32)).astype(np.float32)

BLOCKED_CASES = [("bca", 1, None), ("bca", 2, None), ("cba", 3, None), ("BCa", 2, None),
                 ("bcba", 2, {"b": (2,)}), ("bcaa", 2, {"a": (6,)}), ("cBa", 6, None),
                 ("bBcCa", 1, {"b": (2,), "c": (3,)})]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spec,k_step,steps", BLOCKED_CASES)
def test_brgemm_blocked_matches_the_pallas_kernel(spec, k_step, steps, dtype):
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = brgemm_blocked_pallas(_j(A, jd), _j(B, jd), spec_string=spec, k_step=k_step,
                                 block_steps=steps, interpret=True)
    got = ops.brgemm_blocked(_t(A, td), _t(B, td), spec_string=spec, k_step=k_step,
                             block_steps=steps)
    assert got.dtype == td and got.shape == (3, 4, 8, 32)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(got), _np(jref.brgemm_blocked_ref(_j(A, jd), _j(B, jd))), **tol)


def test_brgemm_blocked_ref_and_out_dtype():
    got = ref.brgemm_blocked_ref(_t(A, torch.bfloat16), _t(B, torch.bfloat16), out_dtype=torch.float32)
    want = jref.brgemm_blocked_ref(_j(A, jnp.bfloat16), _j(B, jnp.bfloat16), out_dtype=jnp.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_brgemm_blocked_rounds_once_where_the_reference_rounds_per_visit():
    """K11 and its plain version follow the oracle, ``brgemm_blocked_ref``:
    one rounding of the fp32 sum.  The reference's Pallas kernel adds each
    visit's partial into its bf16 output block, rounding every time."""
    a = np.array([1 + 2 ** -7, 2 ** -8], np.float32).reshape(1, 2, 1, 1)
    b = np.array([1 + 2 ** -7, 1.0], np.float32).reshape(1, 2, 1, 1)
    per_visit = brgemm_blocked_pallas(_j(a, jnp.bfloat16), _j(b, jnp.bfloat16), interpret=True)
    once = ops.brgemm_blocked(_t(a, torch.bfloat16), _t(b, torch.bfloat16))
    assert _np(per_visit).item() == 1.015625 and once.float().item() == 1.0234375
    assert once.float().item() == _np(jref.brgemm_blocked_ref(_j(a, jnp.bfloat16),
                                                              _j(b, jnp.bfloat16))).item()
    # 64 visits: the per-visit sums drift past the bf16 tolerance
    a = np.array([1.0] + [2 ** -8] * 63, np.float32).reshape(1, 64, 1, 1)
    b = np.ones((1, 64, 1, 1), np.float32)
    per_visit = brgemm_blocked_pallas(_j(a, jnp.bfloat16), _j(b, jnp.bfloat16), interpret=True)
    once = ops.brgemm_blocked(_t(a, torch.bfloat16), _t(b, torch.bfloat16))
    assert _np(per_visit).item() == 1.0 and once.float().item() == 1.25


@pytest.mark.parametrize("spec,k_step,steps", [("abc", 1, None), ("Abc", 1, None),
                                               ("bcaa", 1, None), ("bca", 4, None),
                                               ("bcd", 1, None), ("bcba", 1, {"b": (3,)})])
def test_brgemm_blocked_illegal_schedules_raise_the_reference_codes(spec, k_step, steps):
    with pytest.raises(JLegalityError) as want:
        brgemm_blocked_pallas(_j(A), _j(B), spec_string=spec, k_step=k_step, block_steps=steps,
                              interpret=True)
    with pytest.raises(LegalityError) as got:
        ops.brgemm_blocked(_t(A), _t(B), spec_string=spec, k_step=k_step, block_steps=steps)
    assert got.value.code == want.value.code


def test_brgemm_blocked_variants_and_refusals():
    assert brgemm.blocked_variant(torch.bfloat16, 64, 64, 64) == "wmma"
    assert brgemm.blocked_variant(torch.bfloat16, 128, 64, 128) == "wmma"
    assert brgemm.blocked_variant(torch.bfloat16, 8, 16, 32) == "simt"
    assert brgemm.blocked_variant(torch.bfloat16, 16, 8, 16) == "simt"
    assert brgemm.blocked_variant(torch.float32, 64, 64, 64) == "simt"
    for dtype, bm, bn in ((torch.float32, 128, 128), (torch.bfloat16, 256, 256),
                          (torch.float32, 8192, 1)):
        with pytest.raises(ValueError):
            brgemm.blocked_variant(dtype, bm, 64, bn)
    with pytest.raises(ValueError, match="CUDA"):
        brgemm.brgemm_blocked(_t(A), _t(B))
    with pytest.raises(ValueError):
        ops.brgemm_blocked(_t(A), _t(B[:, :5]))
    with pytest.raises(NotImplementedError):
        ops.brgemm_blocked(_t(A).requires_grad_(), _t(B))
    assert brgemm.BLOCKED_LAUNCHES == 0


def test_blocked_schedule_plans_the_reference_grid():
    plan = brgemm.blocked_schedule(A.shape, B.shape, "bcba", 2, {"b": (2,)})
    assert plan.grid == (2, 3, 2, 3)
    assert plan.in_blocks == ((1, 2, 8, 16), (1, 2, 16, 32))
    assert plan.out_block == (1, 1, 8, 32)
    assert plan.visit_order.tolist()[:4] == [[0, 0], [0, 1], [1, 0], [1, 1]]


# ---------------------------------------------------------------------------
# K1 under a spec string
# ---------------------------------------------------------------------------

MM_A = RNG.normal(size=(64, 64)).astype(np.float32)
MM_B = RNG.normal(size=(64, 64)).astype(np.float32)


@pytest.mark.parametrize("spec,bs", [
    ("bca", {}), ("cba", {}), ("bcba", {"b": (2,)}), ("bcaa", {"a": (2,)}),
    ("BCa", {}), ("cbca", {"c": (2,)}),
])
def test_matmul_spec_strings_match_the_pallas_kernel(spec, bs):
    want = matmul_pallas(_j(MM_A), _j(MM_B), tiles=(16, 16, 16), spec_string=spec,
                         block_steps=bs, interpret=True)
    got = ops.matmul(_t(MM_A), _t(MM_B), tiles=(16, 16, 16), spec_string=spec, block_steps=bs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("activation", [None, "relu", "gelu"])
def test_matmul_spec_with_bias_activation_and_bf16(activation):
    bias = RNG.normal(size=(64,)).astype(np.float32)
    want = matmul_pallas(_j(MM_A, jnp.bfloat16), _j(MM_B, jnp.bfloat16), tiles=(16, 32, 16),
                         spec_string="cBa", bias=_j(bias, jnp.bfloat16), activation=activation,
                         interpret=True)
    got = ops.matmul(_t(MM_A, torch.bfloat16), _t(MM_B, torch.bfloat16), tiles=(16, 32, 16),
                     spec_string="cBa", bias=_t(bias, torch.bfloat16), activation=activation)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


@pytest.mark.parametrize("spec,tiles,bs", [("abc", (16, 16, 16), None), ("Abc", (16, 16, 16), None),
                                           ("bcaa", (16, 16, 16), None),
                                           ("bcba", (16, 16, 16), {"b": (3,)})])
def test_matmul_illegal_schedules_raise_on_the_cpu(spec, tiles, bs):
    with pytest.raises(JLegalityError) as want:
        matmul_pallas(_j(MM_A), _j(MM_B), tiles=tiles, spec_string=spec, block_steps=bs,
                      interpret=True)
    with pytest.raises(LegalityError) as got:
        ops.matmul(_t(MM_A), _t(MM_B), tiles=tiles, spec_string=spec, block_steps=bs)
    assert got.value.code == want.value.code


def test_matmul_spec_refusals():
    with pytest.raises(LegalityError) as e:     # the reference asserts here
        ops.matmul(_t(MM_A), _t(MM_B), tiles=(48, 16, 16), spec_string="bca")
    assert e.value.code == "TPP108"
    with pytest.raises(NotImplementedError):
        ops.matmul(_t(MM_A).requires_grad_(), _t(MM_B), spec_string="bca")
    # without a spec the autograd path is unchanged
    y = ops.matmul(_t(MM_A).requires_grad_(), _t(MM_B))
    y.sum().backward()


# ---------------------------------------------------------------------------
# Convolution (Listing 4, K12)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bc,bk", [(4, 8), (8, 16), (2, 4)])
def test_block_conv_tensors_bitwise(bc, bk):
    x = RNG.normal(size=(2, 5, 6, 8)).astype(np.float32)
    w = RNG.normal(size=(3, 2, 8, 16)).astype(np.float32)
    jx, jw = jconv.block_conv_tensors(_j(x), _j(w), bc, bk)
    tx, tw = conv.block_conv_tensors(_t(x), _t(w), bc, bk)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("rs,stride", [((1, 1), 1), ((3, 3), 1), ((3, 3), 2)])
def test_conv2d_matches_the_reference_pallas_path(rs, stride):
    r, s = rs
    x = RNG.normal(size=(2, 10, 10, 8)).astype(np.float32)
    w = RNG.normal(size=(r, s, 8, 16)).astype(np.float32)
    with jops.use_backend("pallas_interpret"):
        want = jops.conv2d(_j(x), _j(w), stride=stride)
    got = ops.conv2d(_t(x), _t(w), stride=stride)
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(ref.conv2d_ref(_t(x), _t(w), stride=stride).numpy(),
                               np.asarray(jref.conv2d_ref(_j(x), _j(w), stride=stride)), **F32_TOL)
    assert conv.LAUNCHES == 0


@pytest.mark.parametrize("shape", [(1, 9, 7, 64, 64, 3, 2, 1), (2, 6, 6, 96, 40, 2, 2, 2),
                                   (1, 8, 8, 16, 8, 1, 1, 3)])
def test_conv2d_ref_matches_reference(shape):
    n, h, w_, c, k, r, s, stride = shape
    x = RNG.normal(size=(n, h, w_, c)).astype(np.float32)
    w = RNG.normal(size=(r, s, c, k)).astype(np.float32)
    got = ref.conv2d_ref(_t(x, torch.bfloat16), _t(w, torch.bfloat16), stride=stride)
    want = jref.conv2d_ref(_j(x, jnp.bfloat16), _j(w, jnp.bfloat16), stride=stride)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


@pytest.mark.parametrize("spec,stride,w_step", [("abcdefg", 1, None), ("acdebfg", 1, 4),
                                                ("cadbefg", 2, None), ("AbCdefg", 1, 2),
                                                ("abcd|efg", 2, 2)])
def test_conv2d_parlooper_matches_reference(spec, stride, w_step):
    x = RNG.normal(size=(2, 9, 10, 8)).astype(np.float32)
    w = RNG.normal(size=(3, 3, 8, 16)).astype(np.float32)
    jx, jw = jconv.block_conv_tensors(_j(x), _j(w), 4, 8)
    tx, tw = conv.block_conv_tensors(_t(x), _t(w), 4, 8)
    q = (10 - 3) // stride + 1
    w_step = w_step if w_step and q % w_step == 0 else None
    want = jconv.conv2d_parlooper(jx, jw, spec_string=spec, stride=stride, w_step=w_step)
    got = conv.conv2d_parlooper(tx, tw, spec_string=spec, stride=stride, w_step=w_step)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_conv2d_parlooper_bf16_and_illegal_spec():
    x = RNG.normal(size=(1, 6, 6, 8)).astype(np.float32)
    w = RNG.normal(size=(3, 3, 8, 8)).astype(np.float32)
    jx, jw = jconv.block_conv_tensors(_j(x, jnp.bfloat16), _j(w, jnp.bfloat16), 8, 8)
    tx, tw = conv.block_conv_tensors(_t(x, torch.bfloat16), _t(w, torch.bfloat16), 8, 8)
    got = conv.conv2d_parlooper(tx, tw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(jconv.conv2d_parlooper(jx, jw)), **BF16_TOL)
    with pytest.raises(JLegalityError) as want:
        jconv.conv2d_parlooper(jx, jw, spec_string="ABCDEFG")
    with pytest.raises(LegalityError) as got_e:
        conv.conv2d_parlooper(tx, tw, spec_string="ABCDEFG")
    assert got_e.value.code == want.value.code


@pytest.mark.parametrize("stride,spec", [(1, "bca"), (2, "cba"), (3, "BCa")])
def test_conv2d_1x1_matches_the_reference_pallas_path(stride, spec):
    x = RNG.normal(size=(2, 7, 9, 32)).astype(np.float32)
    w = RNG.normal(size=(1, 1, 32, 64)).astype(np.float32)
    jx, jw = jconv.block_conv_tensors(_j(x), _j(w), 16, 32)
    tx, tw = conv.block_conv_tensors(_t(x), _t(w), 16, 32)
    want = jconv.conv2d_1x1_pallas(jx, jw, stride=stride, interpret=True, spec_string=spec)
    got = conv.conv2d_1x1(tx, tw, stride=stride, spec_string=spec)
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    with pytest.raises(LegalityError) as e:
        conv.conv2d_1x1(tx, tw, stride=stride, spec_string="abc")
    assert e.value.code == "TPP102"


def test_conv2d_refuses_a_gradient_and_mixed_devices():
    x = _t(RNG.normal(size=(1, 4, 4, 8))).requires_grad_()
    with pytest.raises(NotImplementedError):
        ops.conv2d(x, _t(RNG.normal(size=(1, 1, 8, 8))))
    with pytest.raises(ValueError):
        ops.conv2d(x.detach(), _t(RNG.normal(size=(1, 1, 8, 8))).to("meta"))
