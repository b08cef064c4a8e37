"""The port's fusion autodiff (``repro_torch.fusion.autodiff``) against the
JAX package's, on the CPU: the derived backward graphs are the reference's
graphs; gradients through ``compile_with_vjp`` (the composed reference path
for every derived graph) equal ``jax.grad`` through the reference's
``compile_with_vjp`` (its XLA backend, and interpret-mode Pallas for a few
graphs); the dz graph regenerates the forward's dropout bits exactly;
``fused_attention_apply`` forward and gradients; fused training
(``use_fusion=True``) of reduced minicpm-2b (dropout 0 and 0.15), gpt-j-6b
and bert-large (bidirectional) against ``repro``'s fused train step; and K5's generated sources
for the graphs this path adds, without nvcc.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: gradients fp32 rtol 1e-4 / atol 1e-3 (products summed in
another order), bf16 rtol 2e-2 / atol 2e-1 (bf16 inputs, fp32
accumulation, one rounding of each bf16 cotangent); training losses and
parameters rtol 1e-4 / atol 1e-3 over 3 steps in fp32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fusion as jf
from repro.configs.base import get_config as jax_config
from repro.fusion import autodiff as jad
from repro.fusion import rng as jrng
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import steps as jsteps
from repro_torch import fusion as tf
from repro_torch.configs.base import get_config as torch_config
from repro_torch.data import DataConfig, SyntheticCorpus, to_device
from repro_torch.fusion import autodiff as tad
from repro_torch.fusion import rng as trng
from repro_torch.kernels import fused_gemm
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import init_state
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import TrainConfig, make_train_step

M, K, N = 32, 64, 48
PKGS = {"jax": jf, "torch": tf}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(rtol=1e-4, atol=1e-3) if dtype == "float32" else dict(rtol=2e-2, atol=2e-1)


def _library(f):
    """The reference's ``LIBRARY_GRAPHS`` of tests/test_fusion_autodiff.py,
    and the chained attention graphs."""
    return {
        "fused_output_r0": f.fused_output_graph(0.0),
        "fused_output_r05": f.fused_output_graph(0.5),
        "fused_output_r05_mask": f.fused_output_graph(0.5, rng_dropout=False),
        "fused_attn_out_do_res": f.fused_attn_out_graph(True, dropout_rate=0.3),
        "fused_mlp_gelu": f.fused_mlp_graph("gelu"),
        "fused_mlp_relu": f.fused_mlp_graph("relu"),
        "fused_gated_mlp_silu": f.fused_gated_mlp_graph("silu"),
        "fused_qkv": f.fused_qkv_graph(),
        "fused_attn_out": f.fused_attn_out_graph(),
        "fused_attn_out_res_ln": f.fused_attn_out_graph(True, "layernorm"),
        "fused_attn_out_res_rms": f.fused_attn_out_graph(True, "rmsnorm"),
        "attention_causal": f.fused_attention_graph(causal=True, scale=0.25, offset=0),
        "attention_window": f.fused_attention_graph(causal=True, window=8, scale=0.25),
    }


def _operands(graph, dtype, seed, m=M, k=K, n=N):
    """numpy operands for ``graph`` → (jax dict, torch dict); rowvecs fp32."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    jops, tops = {}, {}
    for spec in graph.operands:
        shape = {"lhs": (k, m) if spec.trans else (m, k),
                 "rhs": (n, k) if spec.trans else (k, n), "crhs": (n, k),
                 "tile": (m, n), "mask": (m, n), "rowvec": (n,)}.get(spec.kind, ())
        if spec.kind == "mask":
            v = rng.random(shape) > 0.4
            jops[spec.name], tops[spec.name] = jnp.asarray(v), torch.from_numpy(v)
        elif spec.kind == "scalar":
            v = int(rng.integers(0, 2**31))
            jops[spec.name], tops[spec.name] = jnp.asarray(v, jnp.uint32), v
        else:
            v = rng.normal(size=shape).astype(np.float32)
            if spec.kind == "rowvec":
                jops[spec.name], tops[spec.name] = jnp.asarray(v), torch.from_numpy(v)
            else:
                jops[spec.name] = jnp.asarray(v, jdt)
                tops[spec.name] = torch.from_numpy(v).to(tdt)
    return jops, tops


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _nodes(nodes):
    return tuple((nd.name, nd.op, nd.inputs, nd.attrs) for nd in nodes)


def _structure(g):
    return (g.name, tuple((o.name, o.kind, o.trans) for o in g.operands),
            tuple((r.name, r.lhs, r.rhs, r.chained) for r in g.roots), _nodes(g.nodes), g.outputs)


# --------------------------------------------------------------------------
# Derived structure
# --------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["recompute", "saved"])
@pytest.mark.parametrize("name", sorted(_library(jf)))
def test_derived_graphs_are_the_reference_graphs(name, policy):
    jp = jad.derive_vjp(_library(jf)[name], policy=policy)
    tp = tad.derive_vjp(_library(tf)[name], policy=policy)
    assert type(tp).__name__ == type(jp).__name__ and tp.policy == jp.policy
    jg, tg = jp.fused_graphs(), tp.fused_graphs()
    assert sorted(tg) == sorted(jg)
    for nm in jg:
        assert _structure(tg[nm]) == _structure(jg[nm]), nm
        assert tp.graph_role(nm) == jp.graph_role(nm)
        assert tp.problem_shape(nm, 3, 5, 7) == jp.problem_shape(nm, 3, 5, 7)
    if isinstance(jp, jad.ChainedBackwardPlan):
        assert tp.names == jp.names and tp.rhs_trans == jp.rhs_trans
        return
    assert tp.dy_names == jp.dy_names and tp.dacc == jp.dacc
    assert tp.cotangents == jp.cotangents and tp.value_loc == jp.value_loc
    assert [(_nodes(g.nodes), g.outputs, g.graph is None) for g in tp.stage1] == \
        [(_nodes(g.nodes), g.outputs, g.graph is None) for g in jp.stage1]
    assert (tp.aug_forward is None) == (jp.aug_forward is None)
    if jp.aug_forward is not None:
        assert _structure(tp.aug_forward) == _structure(jp.aug_forward)
    assert tp.aug_index == jp.aug_index


# --------------------------------------------------------------------------
# Gradient parity
# --------------------------------------------------------------------------

def _grads(graph_j, graph_t, dtype, seed, *, backend="xla", policy="recompute", **kw):
    """Cotangents of sum(out * probe) for every float operand: (reference's
    compile_with_vjp under jax.grad, the port's under autograd)."""
    jops, tops = _operands(graph_j, dtype, seed)
    out = jf.compile(graph_j, path="xla")(**jops)
    probe = np.random.default_rng(seed + 1).normal(size=out.shape).astype(np.float32)
    keys = [k for k, v in tops.items() if isinstance(v, torch.Tensor) and v.is_floating_point()]
    jfn = jad.compile_with_vjp(graph_j, backend, residuals=policy, **kw)

    def loss(fl):
        return jnp.sum(jfn(**dict(jops, **fl)).astype(jnp.float32) * jnp.asarray(probe))

    want = jax.grad(loss)({k: jops[k] for k in keys})
    leaves = {k: tops[k].clone().requires_grad_(True) for k in keys}
    got_out = tad.compile_with_vjp(graph_t, residuals=policy)(**dict(tops, **leaves))
    (got_out.float() * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(_np(got_out), _np(out), **_tol(dtype))
    return {k: (_np(want[k]), _np(leaves[k].grad)) for k in keys}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(_library(jf)))
def test_library_grad_parity(name, dtype):
    for k, (want, got) in _grads(_library(jf)[name], _library(tf)[name], dtype,
                                 seed=len(name)).items():
        np.testing.assert_allclose(got, want, err_msg=k, **_tol(dtype))


@pytest.mark.parametrize("name", ["fused_output_r05", "fused_gated_mlp_silu", "attention_causal"])
def test_library_grad_parity_against_interpret_mode_pallas(name):
    kw = dict(tiles=(16, 32, 16))
    for k, (want, got) in _grads(_library(jf)[name], _library(tf)[name], "float32", seed=3,
                                 backend="pallas_interpret", **kw).items():
        np.testing.assert_allclose(got, want, err_msg=k, **_tol("float32"))


@pytest.mark.parametrize("name", ["fused_gated_mlp_silu", "fused_qkv", "fused_mlp_gelu"])
def test_saved_policy_grad_parity(name):
    for k, (want, got) in _grads(_library(jf)[name], _library(tf)[name], "float32", seed=5,
                                 policy="saved").items():
        np.testing.assert_allclose(got, want, err_msg=k, **_tol("float32"))


def _single_op_graph(f, op_name):
    """``tests/test_fusion_autodiff.py::_single_op_graph`` in ``f``."""
    op = f.EPILOGUE_OPS[op_name]
    operands = [("x", "lhs"), ("w", "rhs")]
    extra = []
    for i, kind in enumerate(op.operand_kinds):
        operands.append((f"p{i}", kind))
        extra.append(f"p{i}")
    attrs = ({"rate": 0.3} if op_name == "dropout" else
             {"rate": 0.3, "salt": 11} if op_name == "dropout_rng"
             else {"s": 0.5} if op_name == "scale" else {})
    values = ["acc"]
    for i in range(op.value_arity - 1):
        operands.append((f"y{i}", "tile"))
        values.append(f"y{i}")
    return f.TppGraph(
        name=f"ad_{op_name}", operands=tuple(f.OperandSpec(n_, k_) for n_, k_ in operands),
        nodes=(f.Node(f"n_{op_name}", op_name, (*values, *extra),
                      tuple(sorted(attrs.items()))),))


DIFFERENTIABLE_OPS = sorted(nm for nm, op in jf.EPILOGUE_OPS.items() if op.grad is not None)


@pytest.mark.parametrize("op_name", DIFFERENTIABLE_OPS)
def test_per_op_grad_parity(op_name):
    assert (tf.EPILOGUE_OPS[op_name].grad is None) is False
    for k, (want, got) in _grads(_single_op_graph(jf, op_name), _single_op_graph(tf, op_name),
                                 "float32", seed=7).items():
        np.testing.assert_allclose(got, want, err_msg=k, **_tol("float32"))


# --------------------------------------------------------------------------
# The dz graph regenerates the forward draw, bit for bit
# --------------------------------------------------------------------------

def _bits_graph(f, rate=0.4, salt=21):
    return f.TppGraph.chain(
        "ad_bits", [("bias_add", ("bias",), {}), ("gelu", (), {}),
                    ("dropout_rng", ("seed",), {"rate": rate, "salt": salt})],
        [("x", "lhs"), ("w", "rhs"), ("bias", "rowvec"), ("seed", "scalar")])


def test_bwd_dz_regenerates_forward_draw():
    jops, tops = _operands(_bits_graph(jf), "float32", seed=9)
    plan = tad.derive_vjp(_bits_graph(tf))
    (grp,) = plan.stage1
    assert grp.graph is not None, "dz stage should be a fused graph"
    feed = {nm: tops[nm] for nm in grp.operand_names}
    feed.update({d: torch.ones(M, N) for d in grp.dy_names})
    dz = tf.compile_for_device(grp.graph, out_dtype=torch.float32)(**feed).numpy()
    keep = trng.keep_mask(tops["seed"], 21, (M, N), rate=0.4).numpy()
    assert np.array_equal(keep, np.asarray(jrng.keep_mask(jops["seed"], 21, (M, N), rate=0.4)))
    assert 0.3 < keep.mean() < 0.9 and (dz[~keep] == 0.0).all()
    # the forward drops the same elements
    y = tf.compile(_bits_graph(tf), path="reference")(**tops).numpy()
    assert (y[~keep] == 0.0).all() and (y[keep] != 0.0).mean() > 0.5
    # and the reference's dz graph gives the same values
    jplan = jad.derive_vjp(_bits_graph(jf))
    jfeed = {nm: jops[nm] for nm in grp.operand_names}
    jfeed.update({d: jnp.ones((M, N)) for d in grp.dy_names})
    want = jf.compile(jplan.stage1[0].graph, path="xla", out_dtype=jnp.float32)(**jfeed)
    np.testing.assert_allclose(dz, np.asarray(want), **_tol("float32"))


# --------------------------------------------------------------------------
# fused_attention_apply
# --------------------------------------------------------------------------

ATTN = {"causal": (True, None, 2), "window": (True, 16, 2), "gqa": (True, None, 1)}


@pytest.mark.parametrize("case", sorted(ATTN))
def test_fused_attention_matches_the_reference(case):
    causal, window, hk = ATTN[case]
    rng = np.random.default_rng(13)
    b, h, s, d = 2, 2, 48, 16
    qn, kn, vn = (rng.normal(size=(b, hh, s, d)).astype(np.float32) for hh in (h, hk, hk))
    probe = rng.normal(size=(b, h, s, d)).astype(np.float32)

    def jloss(q, k, v):
        o = jf.fused_attention_apply(q, k, v, causal=causal, window=window)
        return jnp.sum(o * probe), o

    (_, want), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in (qn, kn, vn))
    # the port's entry point takes the strided view a block hands it
    qv = q.transpose(1, 2).contiguous().transpose(1, 2)
    got = tf.fused_attention_apply(qv, k, v, causal=causal, window=window)
    (got * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    for t, w, nm in zip((q, k, v), jg, "qkv"):
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), rtol=1e-4, atol=1e-4, err_msg=nm)


def test_fused_attention_batched_equals_per_head():
    """A batched call is the reference's vmap: each (batch, head) problem
    alone gives the same output, its dropout and mask keyed on its own
    coordinates."""
    rng = np.random.default_rng(17)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 3, 24, 8)).astype(np.float32))
               for _ in range(3))
    g = tf.fused_attention_graph(causal=True, window=5, scale=0.3)
    whole = tf.compile_for_device(g)(q=q, k=k, v=v)
    for bi in range(2):
        for hi in range(3):
            one = tf.compile_for_device(g)(q=q[bi, hi], k=k[bi, hi], v=v[bi, hi])
            torch.testing.assert_close(whole[bi, hi], one, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# Fused training against repro's fused train step
# --------------------------------------------------------------------------

TRAIN = {"minicpm_2b": 0.0, "minicpm_2b-dropout": 0.15, "gptj_6b": 0.0, "bert_large": 0.0}


@pytest.mark.parametrize("case", sorted(TRAIN))
def test_fused_train_step_matches_the_reference(case):
    arch, rate = case.split("-")[0], TRAIN[case]
    cfg_j = dataclasses.replace(jax_config(arch).reduced(), use_fusion=True, dropout_rate=rate)
    cfg = dataclasses.replace(torch_config(arch).reduced(), use_fusion=True, dropout_rate=rate)
    tkw = dict(peak_lr=3e-3, warmup_steps=2, total_steps=40, loss_chunk=16, dropout_seed=5)
    jp = jlm.init_params(cfg_j, jax.random.PRNGKey(0))
    jstep = jax.jit(jsteps.make_train_step(cfg_j, jsteps.TrainConfig(**tkw)))
    jopt = jadamw.init_state(jp)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu",
                               dtype=torch.float32)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    opt = init_state(params)
    step_fn = make_train_step(cfg, TrainConfig(**tkw))
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
                                        seed=3))
    for step in range(3):
        b = corpus.batch_at(step)
        jp, jopt, jm = jstep(jp, jopt, {k_: jnp.asarray(v) for k_, v in b.items()},
                             jnp.int32(step))
        params, opt, m = step_fn(params, opt, to_device(b, "cpu"), step)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-3)
    want = tree_leaves(params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu",
                                         dtype=torch.float32))
    for g, w in zip(tree_leaves(params), want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-3)


# --------------------------------------------------------------------------
# K5's generated sources for this path, without nvcc
# --------------------------------------------------------------------------

def _plan_graph(f, name, role):
    return {tad.derive_vjp(_library(f)[name]).graph_role(nm): g
            for nm, g in tad.derive_vjp(_library(f)[name]).fused_graphs().items()}[role]


SOURCES = {
    "chained": (lambda: _library(tf)["attention_window"], "fused_chain.cuh",
                ["fg::chain_entry<Epi>", "tile_dead", "fg_attn_keep(gm, gn, true, 8, 0)"]),
    "softmax panel": (lambda: _plan_graph(tf, "attention_causal", "p"), "fused_gemm.cuh",
                      ["fg::RED_SOFTMAX;", "PANEL = true"]),
    "softmax_grad panel": (lambda: _plan_graph(tf, "attention_causal", "dz"), "fused_gemm.cuh",
                           ["fg::RED_SOFTMAX_GRAD;", "(fg_attn_keep(gm, gn, true, 0, 0) ? y : 0.0f)"]),
    "layernorm panel": (lambda: tf.fused_output_graph(0.1), "fused_gemm.cuh",
                        ["fg::RED_LAYERNORM;", "(keep >> 0) & 1u ?"]),
    "trans": (lambda: _plan_graph(tf, "fused_gated_mlp_silu", "dlhs"), "fused_gemm.cuh",
              ["trans_rhs(int r) { return r == 0 ? true : true; }"]),
    "dropout_rng": (lambda: _library(tf)["fused_attn_out_do_res"], "fused_gemm.cuh",
                    [f"salt = {tf.library.ATTN_OUT_DROPOUT_SALT}u;",
                     f"thresh = {trng.keep_threshold(0.3)}u;"]),
}


@pytest.mark.parametrize("case", sorted(SOURCES))
def test_generated_source_for_the_training_path(case):
    make, template, markers = SOURCES[case]
    g = tf.simplify_graph(make())
    src = fused_gemm.generate_source(g)
    assert f'#include "{template}"' in src and src == fused_gemm.generate_source(g)
    for marker in markers:
        assert marker in src, marker
    # the same structure under another name shares the source
    renamed = dataclasses.replace(g, name=g.name + "_other")
    assert fused_gemm.source_name(renamed, fused_gemm.generate_source(renamed)) == \
        fused_gemm.source_name(g, src)
