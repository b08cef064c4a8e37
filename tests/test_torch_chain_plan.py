"""K5's chained forward on the CPU (no GPU, no nvcc needed): its launch plan,
its tile rules, the source it generates, and its plain version at head dim
256 against the reference.

``fused_gemm.chain_plan`` is what the wrapper hands the chained graph's C
entry point, which refuses a plan it does not build: bf16 operands laid
out as attention's (q (M, K), k stored (N, K), K = N2 a head dim of
``flash_attention.HEAD_DIMS``) run K2's forward mainloop
(``csrc/attention_fwd.cuh``, wgmma), every other graph the SIMT kernel; a
bf16 operand the TMA copies cannot read raises.  ``chain_key_range`` and
``chain_tile_mixed`` mirror the generated ``key_range`` and ``tile_mixed``
and are held here against brute-force masks from the plain version's own
``fusion/graph.py::_attn_keep``.  Chains up to 256 wide plan and run (the
fault that kept gpt-j-6b from training fused on the card); 257 raises
``TPP226``.

Inputs for the reference comparisons are made with numpy from a seed and
handed to both packages.  Tolerances: fp32 rtol 1e-4 / atol 1e-4 for the
output (the same fp32 arithmetic summed in another order) and rtol 1e-4 /
atol 1e-3 for the gradients (P rebuilt from the row log-sum-exp instead of
the softmax panel, as ``tests/test_torch_attention_bwd.py``); bf16 rtol
2e-2 / atol 2e-1 (bf16 inputs, fp32 accumulation, the reference's bf16
intermediates).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fusion as jf
from repro_torch import fusion as tf
from repro_torch.fusion import autodiff as tad
from repro_torch.fusion.graph import FusionLegalityError, _attn_keep
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_gemm
from repro_torch.kernels import ref as tref

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FWD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-1)}
GRAD_TOL = {"float32": dict(rtol=1e-4, atol=1e-3), "bfloat16": dict(rtol=2e-2, atol=2e-1)}


def _attention(causal=True, window=0, offset=0, scale=0.125):
    return tf.simplify_graph(tf.fused_attention_graph(causal=causal, window=window, scale=scale,
                                                      offset=offset))


def _ops(b, h, sq, skv, d, dtype=torch.bfloat16, dv=None):
    """q as the strided (B, H, S, D) view of a (B, S, H, D) projection, k
    and v contiguous: the model path's layout."""
    return dict(q=torch.zeros(b, sq, h, d, dtype=dtype).transpose(1, 2),
                k=torch.zeros(b, h, skv, d, dtype=dtype),
                v=torch.zeros(b, h, skv, dv or d, dtype=dtype))


def _graph_with(q_trans=False, k_trans=True):
    """fused_attention_graph's nodes over operands stored as given."""
    g = _attention()
    ops = (tf.OperandSpec("q", "lhs", trans=q_trans), tf.OperandSpec("k", "rhs", trans=k_trans),
           tf.OperandSpec("v", "crhs"))
    return tf.TppGraph(g.name, ops, roots=g.roots, nodes=g.nodes, outputs=g.outputs)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_bf16_attention_plans_the_wgmma_mainloop_within_shared_memory(d):
    b, h, sq = 2, 5, 300
    plan = fused_gemm.chain_plan(_attention(), _ops(b, h, sq, 77, d))
    wg, bn, stages = fa.WGMMA_TILES[d]
    assert plan.variant == "wgmma"
    assert (plan.rows, plan.bn, plan.stages) == (64 * wg, bn, stages)
    # K2's plan at the same shape: one mainloop, one set of tiles
    k2 = fa.forward_plan(*(_ops(b, h, sq, 77, d)[n] for n in "qkv"))
    assert (plan.rows, plan.bn, plan.stages, plan.smem_bytes) == \
        (k2.rows, k2.bn, k2.stages, k2.smem_bytes)
    assert plan.smem_bytes <= fa.SMEM_LIMIT
    assert plan.grid == (-(-sq // plan.rows), h, b)
    assert plan.ints() == (1, plan.rows, bn, stages, plan.smem_bytes)


def _simt_cases():
    bf, f32 = torch.bfloat16, torch.float32
    mixed = _ops(1, 2, 64, 64, 64)
    mixed["v"] = mixed["v"].float()
    trans_q = _ops(1, 2, 64, 64, 64)
    trans_q["q"] = trans_q["q"].transpose(-1, -2)         # stored (K, M)
    kn = _ops(1, 2, 64, 64, 64)
    kn["k"] = kn["k"].transpose(-1, -2)                   # stored (K, N)
    return {"fp32": (_attention(), _ops(1, 2, 64, 64, 64, f32)),
            "mixed dtypes": (_attention(), mixed),
            "D 80": (_attention(), _ops(1, 2, 64, 64, 80, bf)),
            "K != N2": (_attention(), _ops(1, 2, 64, 64, 64, bf, dv=32)),
            "transposed q": (_graph_with(q_trans=True), trans_q),
            "rhs stored (K, N)": (_graph_with(k_trans=False), kn)}


@pytest.mark.parametrize("case", sorted(_simt_cases()))
def test_every_other_graph_plans_the_simt_kernel(case):
    graph, ops = _simt_cases()[case]
    plan = fused_gemm.chain_plan(graph, ops)
    assert (plan.variant, plan.rows, plan.bn, plan.stages, plan.smem_bytes) == \
        ("simt", 64, 64, 1, 0)
    assert plan.grid == (1, 1, 2)


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_misaligned_bf16_base_pointer_raises(which):
    ops = _ops(2, 4, 64, 64, 64)
    bad = torch.zeros(2 * 64 * 4 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 4, 64, 64)
    ops[which] = bad                                       # 2 bytes off
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fused_gemm.chain_plan(_attention(), ops)


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_misaligned_bf16_stride_raises(which):
    ops = _ops(2, 4, 64, 64, 16)
    ops[which] = torch.zeros(2, 4, 64, 20, dtype=torch.bfloat16)[..., :16]   # rows 40 bytes apart
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fused_gemm.chain_plan(_attention(), ops)


def test_an_operand_every_problem_shares_plans_wgmma():
    """Batch stride 0 (an expanded or a 2-D k and v): the tensor map drops
    that axis instead of refusing it."""
    ops = _ops(2, 3, 64, 64, 64)
    ops["k"] = torch.zeros(2, 1, 64, 64, dtype=torch.bfloat16).expand(2, 3, 64, 64)
    ops["v"] = torch.zeros(64, 64, dtype=torch.bfloat16)
    assert ops["k"].stride(1) == 0
    assert fused_gemm.chain_plan(_attention(), ops).variant == "wgmma"
    # K2 refuses a stride of 0 on an axis longer than 1, and keeps doing so
    with pytest.raises(ValueError):
        fa.forward_plan(ops["q"], ops["k"], ops["k"])


def test_a_copied_operand_is_not_held_to_the_rule():
    """An operand whose rows are not unit-stride is copied (contiguous,
    aligned) by the wrapper before the launch, so its layout is not checked."""
    ops = _ops(1, 2, 64, 64, 64)
    ops["v"] = torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16)[..., ::2]
    assert fused_gemm.chain_plan(_attention(), ops).variant == "wgmma"


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_cta_tile_gives_the_mainloops_rows(d):
    g = _attention()
    wg = fa.WGMMA_TILES[d][0]
    assert fused_gemm.cta_tile(g, 1024, 1024, "wgmma", d) == (64 * wg, 1024)
    assert fused_gemm.cta_tile(g, 1024, 1024, "wgmma", d) == \
        (fused_gemm.chain_plan(g, _ops(1, 1, 1024, 1024, d)).rows, 1024)
    assert fused_gemm.cta_tile(g, 1024, 1024, "simt", d) == (64, 1024)
    assert fused_gemm.cta_tile(g, 1024, 1024, "wgmma", 80) == (64, 1024)
    assert fused_gemm.cta_tile(_graph_with(k_trans=False), 1024, 1024, "wgmma", d) == (64, 1024)
    assert {64 * fa.WGMMA_TILES[x][0] for x in (16, 32, 64)} == {128}
    assert {64 * fa.WGMMA_TILES[x][0] for x in (128, 256)} == {64}


def test_chains_up_to_256_plan_and_257_raises():
    g = _attention()
    assert fused_gemm.MAX_CHAIN == 256 == max(fa.HEAD_DIMS)
    assert fused_gemm.chain_plan(g, _ops(1, 2, 64, 64, 256)).variant == "wgmma"
    assert fused_gemm.chain_plan(g, _ops(1, 2, 64, 64, 256, torch.float32)).variant == "simt"
    assert fused_gemm.chain_plan(g, _ops(1, 2, 64, 64, 64, dv=256)).variant == "simt"
    with pytest.raises(FusionLegalityError) as e:
        fused_gemm.chain_plan(g, _ops(1, 2, 64, 64, 64, torch.float32, dv=257))
    assert e.value.code == "TPP226"


# ---------------------------------------------------------------------------
# The tile rules of the generated Epi, against brute-force masks
# ---------------------------------------------------------------------------

MASKS = [dict(causal=c, window=w, offset=o) for c, w, o in
         itertools.product((True, False), (0, 8, 256), (-1, 0, "end")) if c or w]
SHAPES = [(100, 100), (70, 200), (200, 70), (33, 300), (300, 300)]


def _keep(mask, sq, skv):
    off = skv - sq if mask["offset"] == "end" else mask["offset"]
    return _attn_keep((sq, skv), "cpu", causal=mask["causal"], window=mask["window"],
                      offset=off, offsets=(0, 0)), dict(mask, offset=off)


@pytest.mark.parametrize("mask", MASKS, ids=lambda m: f"c{int(m['causal'])}w{m['window']}o{m['offset']}")
@pytest.mark.parametrize("sq,skv", SHAPES)
def test_key_range_holds_every_live_pair_and_tile_mixed_every_cut(mask, sq, skv):
    keep, attrs = _keep(mask, sq, skv)
    for rows, bn in ((128, 128), (128, 64), (64, 64)):
        for q0 in range(0, sq, rows):
            block = keep[q0:q0 + rows]
            tiles = fused_gemm.chain_key_range(attrs, q0, rows, sq, skv, bn)
            live = {j // bn for j in torch.nonzero(block.any(0)).flatten().tolist()}
            # every live pair's tile is visited, and every visited tile lies
            # between the first and the last live one
            assert live <= set(tiles)
            if live:
                assert tiles.start == min(live) and tiles.stop == max(live) + 1
            else:
                assert len(tiles) == 0
            for n0 in range(0, skv, bn):
                tile = block[:, n0:n0 + bn]
                if not tile.any():
                    continue            # dead: outside key_range, never computed
                mixed = fused_gemm.chain_tile_mixed(attrs, q0, rows, n0, bn)
                if tile.shape == (rows, bn):
                    # a whole tile: mixed exactly where the mask cuts it
                    assert mixed == (not bool(tile.all()))
                elif not tile.all():
                    # a ragged one (the padding rows and keys count too)
                    assert mixed


def test_without_a_mask_every_tile_is_live_and_none_mixed():
    assert fused_gemm.chain_key_range(None, 0, 128, 300, 200, 64) == range(0, 4)
    assert fused_gemm.chain_key_range(None, 256, 128, 300, 200, 64) == range(0, 4)
    assert fused_gemm.chain_key_range(None, 384, 128, 300, 200, 64) == range(0)   # past Sq
    assert not fused_gemm.chain_tile_mixed(None, 0, 128, 0, 64)


def test_generated_source_carries_the_tile_rules_it_mirrors():
    g = _attention(causal=True, window=8, offset=0)
    src = fused_gemm.generate_source(g)
    for marker in ('#include "fused_chain.cuh"', "fg::chain_entry<Epi>", "tile_dead",
                   "fg_attn_keep(gm, gn, true, 8, 0)", "key_range", "tile_mixed",
                   "template <bool MIXED = true>", "(!MIXED || fg_attn_keep(gm, gn, true, 8, 0))",
                   "min(p.Skv, last + 0 + 1)", "max(0, q0 + 0 - 8 + 1)",
                   "n0 + bn - 1 > m0 + 0 || n0 <= m0 + bm - 1 + 0 - 8",
                   "static constexpr bool CAUSAL = true;"):
        assert marker in src, marker
    free = fused_gemm.generate_source(_attention(causal=False))
    assert "const int end = p.Skv, begin = 0;" in free
    assert "static constexpr bool CAUSAL = false;" in free and "MIXED ||" not in free
    # one text serves both variants; the backward keeps its unguarded pre
    assert "launch_chain_wgmma" not in src
    plan = tad.derive_vjp(g)
    bwd = fused_gemm.generate_backward_source(plan, 256)
    assert "fg_attn_keep(gm, gn, true, 8, 0) ? " in bwd and "MIXED" not in bwd


def test_a_chained_graph_with_an_epilogue_operand_is_refused():
    g = _attention()
    ops = g.operands + (tf.OperandSpec("bias", "rowvec"),)
    nodes = g.nodes[:1] + (tf.Node("n_bias", "bias_add", (g.nodes[0].name, "bias")),) + tuple(
        tf.Node(nd.name, nd.op, tuple("n_bias" if i == g.nodes[0].name else i for i in nd.inputs),
                nd.attrs) for nd in g.nodes[1:])
    bad = tf.TppGraph("chain_bias", ops, roots=g.roots, nodes=nodes, outputs=g.outputs)
    with pytest.raises(FusionLegalityError) as e:
        fused_gemm.generate_source(bad)
    assert e.value.code == "TPP226"


# ---------------------------------------------------------------------------
# The plain chained forward and its gradient at D 256, against the reference
# ---------------------------------------------------------------------------

B, H, S, D = 1, 2, 64, 256


def _inputs(dtype, seed=7):
    rng = np.random.default_rng(seed)
    q, k, v, dy = (rng.normal(size=(B, H, S, D)).astype(np.float32) for _ in range(4))
    return (q, k, v, dy), tuple(torch.from_numpy(x).to(DTYPES[dtype][1]) for x in (q, k, v)), \
        torch.from_numpy(dy)


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chained_forward_at_head_dim_256_matches_the_reference(dtype, backend):
    (qn, kn, vn, _), (q, k, v), _ = _inputs(dtype)
    jdt = DTYPES[dtype][0]
    want = jf.fused_attention_apply(*(jnp.asarray(x, jdt) for x in (qn, kn, vn)), causal=True,
                                    backend=backend)
    got = tf.fused_attention_apply(q, k, v, causal=True)
    assert got.shape == (B, H, S, D) and got.dtype == q.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **FWD_TOL[dtype])


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chained_backward_plain_at_head_dim_256_matches_jax_grad(dtype, backend):
    (qn, kn, vn, dyn), (q, k, v), dy = _inputs(dtype)
    jdt = DTYPES[dtype][0]

    def loss(q, k, v):
        o = jf.fused_attention_apply(q, k, v, causal=True, backend=backend)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(dyn))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x, jdt) for x in (qn, kn, vn)))
    plan = tad.derive_vjp(tf.fused_attention_graph(causal=True, scale=D ** -0.5))
    pre, grad = tad.chained_epilogue(plan)
    z = pre(torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()))
    lse = torch.logsumexp(torch.where(z > -1e29, z, -torch.inf), -1)
    o = tf.compile_for_device(plan.forward, out_dtype=torch.float32)(q=q.float(), k=k.float(),
                                                                      v=v.float())
    got = fused_gemm.ChainedBackward(plan).plain(q, k, v, o, lse, dy)
    same = tref.flash_bwd_ref(q, k, v, o, lse, dy, pre=pre, grad=grad)
    for g, s_, w, nm in zip(got, same, want, "qkv"):
        torch.testing.assert_close(g, s_)
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32), err_msg=nm,
                                   **GRAD_TOL[dtype])
