"""The port's fusion compiler (``repro_torch.fusion``) against the JAX
package's, on the CPU: the epilogue registry, graph validation and
simplification, the composed reference path (K5's plain version) on the
library's graphs against ``repro.fusion.compile(path="xla")`` and the
interpret-mode Pallas kernel, the fused blocks, fused training, and K5's
CUDA code generator without nvcc (its sources, the graphs it takes and its
refusals).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: fp32 rtol 1e-4 / atol 1e-3 (the fp32 GEMM tolerance of
``tests/test_kernels.py``: products summed in another order); bf16 rtol
2e-2 / atol 2e-1 (bf16 inputs, fp32 accumulation, one rounding of the
output); the counter-PRNG dropout keeps or drops the same elements.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fusion as jf
from repro.configs.base import get_config as jax_config
from repro.fusion.graph import EPILOGUE_OPS as J_OPS
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro_torch import fusion as tf
from repro_torch.configs.base import get_config as torch_config
from repro_torch.fusion.graph import EPILOGUE_OPS as T_OPS
from repro_torch.kernels import _build, fused_gemm
from repro_torch.models import blocks as tblocks
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs import metrics as tmetrics

M, K, N = 32, 64, 128
TILES = (16, 32, 64)
PKGS = {"jax": jf, "torch": tf}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(rtol=1e-4, atol=1e-3) if dtype == "float32" else dict(rtol=2e-2, atol=2e-1)


def _operands(graph, dtype, seed, m=M, k=K, n=N, widths=None):
    """numpy operands for every operand of ``graph`` → (jax dict, torch
    dict); rowvecs stay fp32 like the models' norm parameters."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    widths = widths or {}
    jops, tops = {}, {}
    for spec in graph.operands:
        if spec.kind == "lhs":
            shape = (k, m) if spec.trans else (m, k)
        elif spec.kind == "rhs":
            w = widths.get(spec.name, n)
            shape = (w, k) if spec.trans else (k, w)
        elif spec.kind == "crhs":
            shape = (n, k)
        elif spec.kind in ("tile", "mask"):
            shape = (m, n)
        elif spec.kind == "rowvec":
            shape = (n,)
        else:
            shape = ()
        if spec.kind == "mask":
            v = rng.random(shape) > 0.4
            jops[spec.name], tops[spec.name] = jnp.asarray(v), torch.from_numpy(v)
        elif spec.kind == "scalar":
            v = int(rng.integers(0, 2**31))
            jops[spec.name], tops[spec.name] = jnp.asarray(v, jnp.uint32), v
        else:
            v = rng.normal(size=shape).astype(np.float32)
            if spec.kind in ("rhs", "crhs"):
                v /= np.sqrt(k)
            if spec.kind == "rowvec":
                jops[spec.name], tops[spec.name] = jnp.asarray(v), torch.from_numpy(v)
            else:
                jops[spec.name] = jnp.asarray(v, jdt)
                tops[spec.name] = torch.from_numpy(v).to(tdt)
    return jops, tops


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _single_op_graph(pkg, op_name):
    """matmul → <op> with whatever operands the op needs (the graph of
    ``tests/test_fusion.py::_single_op_graph``), built in ``pkg``."""
    f = PKGS[pkg]
    op = f.EPILOGUE_OPS[op_name]
    operands = [("x", "lhs"), ("w", "rhs")]
    extra = []
    for i, kind in enumerate(op.operand_kinds):
        operands.append((f"p{i}", kind))
        extra.append(f"p{i}")
    attrs = ({"rate": 0.3} if op_name in ("dropout", "dropout_grad") else
             {"rate": 0.3, "salt": 11} if op_name in ("dropout_rng", "dropout_rng_grad")
             else {"s": 0.5} if op_name == "scale"
             else {"causal": True, "window": 9, "offset": 3} if op_name.startswith("attn_mask")
             else {})
    values = ["acc"]
    for i in range(op.value_arity - 1):
        operands.append((f"y{i}", "tile"))
        values.append(f"y{i}")
    return f.TppGraph(
        name=f"g_{op_name}",
        operands=tuple(f.OperandSpec(n, k) for n, k in operands),
        nodes=(f.Node(f"n_{op_name}", op_name, (*values, *extra),
                      tuple(sorted(attrs.items()))),))


# --------------------------------------------------------------------------
# The registry and every op's semantics
# --------------------------------------------------------------------------

def test_registry_is_a_copy_of_the_reference():
    assert sorted(T_OPS) == sorted(J_OPS)
    for name, j in J_OPS.items():
        t = T_OPS[name]
        for field in ("value_arity", "operand_kinds", "reduces", "flops_per_elem",
                      "stats_input", "wants_offsets"):
            assert getattr(t, field) == getattr(j, field), (name, field)
        assert (t.grad if isinstance(t.grad, str) or t.grad is None else t.grad.__name__) == \
            (j.grad if isinstance(j.grad, str) or j.grad is None else j.grad.__name__), name
    assert tf.ONLINE_REDUCERS == jf.graph.ONLINE_REDUCERS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op_name", sorted(J_OPS))
def test_epilogue_op_parity(op_name, dtype):
    """GEMM → op through the port's composed path against the reference's
    XLA path, fp32 output."""
    jg, tg = _single_op_graph("jax", op_name), _single_op_graph("torch", op_name)
    jops, tops = _operands(jg, dtype, seed=sorted(J_OPS).index(op_name))
    want = jf.compile(jg, path="xla", out_dtype=jnp.float32)(**jops)
    got = tf.compile(tg, path="reference", out_dtype=torch.float32)(**tops)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_register_epilogue_checks_like_the_reference():
    for f in PKGS.values():
        with pytest.raises(f.FusionLegalityError):
            f.register_epilogue(f.EPILOGUE_OPS["relu"])          # already registered
        bad = f.EpilogueOp("my_fwd_x", 1, ("rowvec",), lambda v, b: v, grad="relu_grad")
        with pytest.raises(f.FusionLegalityError) as e:
            f.register_epilogue(bad)
        assert e.value.code == "TPP204"
        assert "my_fwd_x" not in f.EPILOGUE_OPS


# --------------------------------------------------------------------------
# Validation: the same illegal graphs raise the same codes
# --------------------------------------------------------------------------

def _illegal(f):
    """name → thunk building one illegal graph with package ``f``."""
    O, R, Nd, G = f.OperandSpec, f.ContractionRoot, f.Node, f.TppGraph
    x, w, wq, wk, r = O("x", "lhs"), O("w", "rhs"), O("wq", "rhs"), O("wk", "rhs"), O("r", "tile")
    two = (R("q", "x", "wq"), R("k", "x", "wk"))
    return {
        "bad_kind": lambda: O("z", "nope"),
        "trans_tile": lambda: O("z", "tile", trans=True),
        "no_roots_two_rhs": lambda: G("g", (x, wq, wk)),
        "two_reducers": lambda: G("g", (x, w), nodes=(Nd("n0", "softmax", ("acc",)),
                                                      Nd("n1", "softmax", ("n0",)))),
        "post_reduce_reads_unstaged": lambda: G(
            "g", (x, w), nodes=(Nd("n0", "relu", ("acc",)), Nd("n1", "softmax", ("acc",)),
                                Nd("n2", "mul", ("n1", "n0")))),
        "rowvec_op_on_tile": lambda: G("g", (x, w, r), nodes=(Nd("n0", "bias_add", ("acc", "r")),)),
        "unknown_op": lambda: G("g", (x, w), nodes=(Nd("n0", "frobnicate", ("acc",)),)),
        "arity": lambda: G("g", (x, w), nodes=(Nd("n0", "add", ("acc",)),)),
        "unknown_value": lambda: G("g", (x, w), nodes=(Nd("n0", "relu", ("zz",)),)),
        "shadowing_node": lambda: G("g", (x, w), nodes=(Nd("x", "relu", ("acc",)),)),
        "dup_operands": lambda: G("g", (x, w, O("x", "tile"))),
        "dup_roots": lambda: G("g", (x, wq, wk), roots=(R("q", "x", "wq"), R("q", "x", "wk"))),
        "acc_alias_multi_root": lambda: G("g", (x, wq, wk), roots=two,
                                          nodes=(Nd("n0", "relu", ("acc",)),)),
        "reducing_multi_output": lambda: G("g", (x, wq, wk), roots=two,
                                           nodes=(Nd("n0", "softmax", ("q",)),),
                                           outputs=("n0", "k")),
        "root_wrong_kind": lambda: G("g", (x, wq, wk), roots=(R("q", "wq", "x"),)),
        "orphan_rhs": lambda: G("g", (x, wq, wk), roots=(R("q", "x", "wq"),)),
        "unknown_output": lambda: G("g", (x, wq), roots=(R("q", "x", "wq"),), outputs=("nope",)),
        "operand_output": lambda: G("g", (x, w, r), nodes=(Nd("n0", "residual_add", ("acc", "r")),),
                                    outputs=("n0", "r")),
        "dup_outputs": lambda: G("g", (x, w), nodes=(Nd("n0", "relu", ("acc",)),),
                                 outputs=("n0", "n0")),
        "two_chained": lambda: G(
            "g", (x, w, O("v", "crhs"), O("v2", "crhs")),
            roots=(R("s", "x", "w"), R("o", "n0", "v", chained=True),
                   R("o2", "n0", "v2", chained=True)),
            nodes=(Nd("n0", "softmax_online", ("s",)),), outputs=("o",)),
        "chain_on_plain_softmax": lambda: G(
            "g", (x, w, O("v", "crhs")), roots=(R("s", "x", "w"), R("o", "n0", "v", chained=True)),
            nodes=(Nd("n0", "softmax", ("s",)),), outputs=("o",)),
        "crhs_as_value": lambda: G(
            "g", (x, w, O("v", "crhs")), roots=(R("s", "x", "w"), R("o", "n0", "v", chained=True)),
            nodes=(Nd("n0", "softmax_online", ("s",)), Nd("n1", "add", ("n0", "v"))),
            outputs=("o",)),
        "crhs_unused": lambda: G("g", (x, w, O("v", "crhs"))),
    }


@pytest.mark.parametrize("case", sorted(_illegal(jf)))
def test_illegal_graphs_raise_the_same_codes(case):
    codes = {}
    for pkg, f in PKGS.items():
        with pytest.raises(f.FusionLegalityError) as e:
            _illegal(f)[case]()
        codes[pkg] = e.value.code
    assert codes["torch"] == codes["jax"] and codes["torch"].startswith("TPP")
    assert issubclass(tf.FusionLegalityError, ValueError)


def test_salt_collisions_raise_tpp203_in_both():
    for f in PKGS.values():
        g = f.TppGraph.chain("salty", [("dropout_rng", ("s1",), {"rate": 0.1, "salt": 5}),
                                       ("dropout_rng", ("s1",), {"rate": 0.1, "salt": 5})],
                             [("x", "lhs"), ("w", "rhs"), ("s1", "scalar")])
        assert len(f.rng.salt_collisions(g)) == 1
        with pytest.raises(f.FusionLegalityError) as e:
            f.compile(g, path="xla" if f is jf else "reference")
        assert e.value.code == "TPP203"


# --------------------------------------------------------------------------
# Simplification and library graphs: the same graphs
# --------------------------------------------------------------------------

def _library(f):
    return {
        "fused_output": f.fused_output_graph(0.3), "fused_output_r0": f.fused_output_graph(0.0),
        "fused_output_mask": f.fused_output_graph(0.3, rng_dropout=False),
        "fused_mlp_gelu": f.fused_mlp_graph("gelu"), "fused_mlp_relu": f.fused_mlp_graph("relu"),
        "gated_silu": f.fused_gated_mlp_graph("silu"), "gated_gelu": f.fused_gated_mlp_graph("gelu"),
        "qkv": f.fused_qkv_graph(),
        "attn_out": f.fused_attn_out_graph(), "attn_out_res": f.fused_attn_out_graph(True),
        "attn_out_rms": f.fused_attn_out_graph(True, "rmsnorm", 1e-6),
        "attn_out_ln": f.fused_attn_out_graph(False, "layernorm"),
        "attn_out_do": f.fused_attn_out_graph(True, dropout_rate=0.2),
        "attention": f.fused_attention_graph(causal=True, scale=0.125, offset=4),
        "attention_window": f.fused_attention_graph(causal=True, window=8),
        "attention_plain": f.fused_attention_graph(causal=False),
    }


@pytest.mark.parametrize("name", sorted(_library(jf)))
def test_library_graphs_and_their_simplification_are_the_reference_graphs(name):
    jg, tg = _library(jf)[name], _library(tf)[name]
    assert tg.describe() == jg.describe()
    assert tg.operand_names == jg.operand_names and tg.outputs == jg.outputs
    js, ts = jf.simplify_graph(jg), tf.simplify_graph(tg)
    assert ts.describe() == js.describe() and ts.operand_names == js.operand_names
    assert (ts is tg) == (js is jg)


def test_simplify_drops_identity_rate0_dropout_and_dead_operands():
    for f in PKGS.values():
        g = f.TppGraph.chain(
            "simp", [("identity", (), {}), ("dropout", ("keep_mask",), {"rate": 0.0}),
                     ("bias_add", ("bias",), {})],
            [("x", "lhs"), ("w", "rhs"), ("keep_mask", "mask"), ("bias", "rowvec")])
        s = f.simplify_graph(g)
        assert [nd.op for nd in s.nodes] == ["bias_add"] and s.nodes[0].inputs[0] == "acc"
        assert "keep_mask" not in s.operand_names
        # a no-op that is an output stays
        x, w, r = f.OperandSpec("x", "lhs"), f.OperandSpec("w", "rhs"), f.OperandSpec("r", "tile")
        g2 = f.TppGraph("id_out", (x, w, r), nodes=(f.Node("n0", "identity", ("r",)),
                                                   f.Node("n1", "add", ("acc", "n0"))),
                        outputs=("n1", "n0"))
        assert "n0" in [nd.name for nd in f.simplify_graph(g2).nodes]


# --------------------------------------------------------------------------
# The composed reference path against repro's xla and interpret-mode Pallas
# --------------------------------------------------------------------------

LIB_CASES = [  # library name, dtype, per-rhs widths
    ("fused_mlp_gelu", "float32", None), ("fused_mlp_relu", "bfloat16", None),
    ("gated_silu", "float32", None), ("gated_silu", "bfloat16", None),
    ("gated_gelu", "float32", None),
    ("qkv", "float32", {"wk": 32, "wv": 32}), ("qkv", "bfloat16", {"wk": 64, "wv": 64}),
    ("attn_out", "float32", None), ("attn_out_res", "float32", None),
    ("attn_out_res", "bfloat16", None), ("attn_out_rms", "float32", None),
    ("attn_out_ln", "float32", None),
    ("fused_output", "float32", None), ("fused_output_r0", "bfloat16", None),
    ("fused_output_mask", "float32", None), ("attention", "float32", None),
    ("attention_window", "float32", None),
]


@pytest.mark.parametrize("name,dtype,widths", LIB_CASES,
                         ids=[f"{n}-{d}" for n, d, _ in LIB_CASES])
def test_library_graph_reference_path_matches_xla_and_pallas(name, dtype, widths):
    jg, tg = _library(jf)[name], _library(tf)[name]
    jops, tops = _operands(jg, dtype, seed=len(name), widths=widths)
    got = tf.compile(tg, path="reference")(**tops)
    want = jf.compile(jg, path="xla")(**jops)
    kw = dict(tiles=(16, 32, 16) if widths else TILES, interpret=True)
    pallas = jf.compile(jg, path="pallas", **kw)(**jops)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(dtype))


def test_dropout_rng_draws_the_reference_bits():
    """fused_output at rate 0.5: the same elements are dropped (zero) in
    both packages, and the rest agree."""
    jg, tg = jf.fused_output_graph(0.5), tf.fused_output_graph(0.5)
    jops, tops = _operands(jg, "float32", seed=3)
    want = np.asarray(jf.compile(jg, path="xla")(**jops))
    got = tf.compile(tg, path="reference")(**tops).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    jd = jf.compile(jf.fused_attn_out_graph(dropout_rate=0.5), path="xla")
    td = tf.compile(tf.fused_attn_out_graph(dropout_rate=0.5), path="reference")
    o, wo = np.random.default_rng(4).normal(size=(2, M, M)).astype(np.float32)
    a = np.asarray(jd(o=jnp.asarray(o), wo=jnp.asarray(wo), seed=jnp.uint32(77)))
    b = td(o=torch.from_numpy(o), wo=torch.from_numpy(wo), seed=77).numpy()
    np.testing.assert_array_equal(a == 0, b == 0)
    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-3)


def test_simplified_operands_are_accepted_and_ignored():
    g = tf.fused_output_graph(0.0)
    _, tops = _operands(g, "float32", seed=8)
    out = tf.compile(g, path="reference")(**tops)
    raw = tf.compile(g, path="reference", simplify=False)(**tops)
    torch.testing.assert_close(out, raw, rtol=0, atol=0)
    no_seed = {k: v for k, v in tops.items() if k != "seed"}
    torch.testing.assert_close(tf.compile(g, path="reference")(**no_seed), out, rtol=0, atol=0)
    with pytest.raises(TypeError, match="missing operand"):
        tf.compile(g, path="reference")(x=tops["x"])
    with pytest.raises(TypeError, match="unexpected"):
        tf.compile(g, path="reference")(**tops, junk=tops["x"])
    with pytest.raises(ValueError, match="lowering path"):
        tf.compile(g, path="pallas")


# --------------------------------------------------------------------------
# The helpers
# --------------------------------------------------------------------------

def _helper_operands(seed, dtype="float32", m=24, k=48, n=40):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((m, k), (k, n), (k, n), (n,), (m, n))]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays], [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_helpers_match_the_reference_helpers(dtype):
    (jx, jw, jw2, jb, jr), (tx, tw, tw2, tb, tr) = _helper_operands(1, dtype)
    pairs = [
        (jf.fused_mlp_apply(jx, jw, jb, activation="gelu"),
         tf.fused_mlp_apply(tx, tw, tb, activation="gelu")),
        (jf.fused_gated_mlp_apply(jx, jw, jw2, activation="silu"),
         tf.fused_gated_mlp_apply(tx, tw, tw2, activation="silu")),
        (jf.fused_attn_out_apply(jx, jw, residual=jr), tf.fused_attn_out_apply(tx, tw, residual=tr)),
        (jf.fused_attn_out_apply(jx, jw, residual=jr, gamma=jb, norm="rmsnorm"),
         tf.fused_attn_out_apply(tx, tw, residual=tr, gamma=tb, norm="rmsnorm")),
    ]
    for want, got in pairs:
        assert got.dtype == DTYPES[dtype][1]
        np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    jq = jf.fused_qkv_apply(jx, jw, jw2[:, :20], jw2[:, 20:])
    tq = tf.fused_qkv_apply(tx, tw, tw2[:, :20], tw2[:, 20:])
    for want, got in zip(jq, tq):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def test_helper_checks_match_the_reference():
    for f, (x, w, w2, b, r) in zip(PKGS.values(), _helper_operands(2)):
        with pytest.raises(f.FusionLegalityError) as e:
            f.fused_qkv_apply(x, w, w2[:, :15], w2[:, 15:])       # k, v widths differ
        assert e.value.code == "TPP214"
        with pytest.raises(f.FusionLegalityError) as e:
            f.fused_qkv_apply(x, w, w2[:, :16], w2[:, 24:])       # 40 % 16 != 0
        assert e.value.code == "TPP214"
        with pytest.raises(ValueError, match="norm='rmsnorm'"):
            f.fused_attn_out_apply(x, w, norm="rmsnorm")
        with pytest.raises(ValueError, match="unused"):
            f.fused_attn_out_apply(x, w, gamma=b)
        with pytest.raises(ValueError, match="dropout_seed"):
            f.fused_attn_out_apply(x, w, dropout_rate=0.1)


def test_a_gradient_through_a_fused_helper_matches_the_reference():
    """The helpers' gradients run the derived backward graphs, as the
    reference's ``_dispatch`` through ``compile_with_vjp`` does."""
    (jx, jw, jw2, jb, jr), (x, w, w2, b, r) = _helper_operands(3)
    probe = np.random.default_rng(4).normal(size=(24, 40)).astype(np.float32)
    cases = [("fused_gated_mlp_apply", (jx, jw, jw2), (x, w, w2), {}),
             ("fused_attn_out_apply", (jx, jw), (x, w), {"residual": (jr, r)}),
             ("fused_mlp_apply", (jx, jw, jb), (x, w, b), {})]
    for fn, jargs, targs, extra in cases:
        def jloss(*a):
            kw = {k: v[0] for k, v in extra.items()}
            return jnp.sum(getattr(jf, fn)(*a, **kw) * probe)

        want = jax.grad(jloss, argnums=tuple(range(len(jargs))))(*jargs)
        leaves = [t.clone().requires_grad_(True) for t in targs]
        out = getattr(tf, fn)(*leaves, **{k: v[1] for k, v in extra.items()})
        (out * torch.from_numpy(probe)).sum().backward()
        for t, g in zip(leaves, want):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-3,
                                       err_msg=fn)


def test_compile_for_device_memoizes_and_counts():
    reg = tmetrics.Registry()
    prev = tmetrics.set_default_registry(reg)
    try:
        g = tf.fused_gated_mlp_graph("relu")
        f1 = tf.compile_for_device(g)
        f2 = tf.compile_for_device(g)
        assert f1 is f2 and tf.compile_for_device(tf.fused_gated_mlp_graph("gelu")) is not f1
        assert reg.counter("fusion.compile_cache.hits").value == 1
        assert reg.counter("fusion.compile_cache.misses").value == 2
    finally:
        tmetrics.set_default_registry(prev)


# --------------------------------------------------------------------------
# K5's CUDA code generator, without nvcc
# --------------------------------------------------------------------------

PATH_GRAPHS = ["gated_silu", "attn_out_res", "fused_mlp_gelu", "qkv"]


@pytest.mark.parametrize("name", PATH_GRAPHS)
def test_generated_source_is_deterministic(name):
    g = tf.simplify_graph(_library(tf)[name])
    src = fused_gemm.generate_source(g)
    assert src == fused_gemm.generate_source(tf.simplify_graph(_library(tf)[name]))
    assert fused_gemm.source_name(g, src) == fused_gemm.source_name(g, src)
    assert f"static constexpr int R = {len(g.base_roots)};" in src
    assert f"static constexpr int NOUT = {len(g.outputs)};" in src
    assert "repro/fusion/lowering.py:330" in src and '#include "fused_gemm.cuh"' in src
    assert 'extern "C" int fused_gemm(' in src
    for nd in g.nodes:
        assert f"// {nd.name} = {nd.op}(" in src
    # the library is named by the source, the template and the flags
    t = _build._generated_target(fused_gemm.source_name(g, src), src)
    assert t == _build._generated_target(fused_gemm.source_name(g, src), src)
    assert t.parent == _build.BUILD_DIR and t.suffix == ".so"


def _trans_graph(f):
    return f.TppGraph("tr", (f.OperandSpec("x", "lhs"), f.OperandSpec("w", "rhs", trans=True)),
                      nodes=(f.Node("n0", "relu", ("acc",)),))


UNSUPPORTED = {
    "TPP207": lambda f: f.TppGraph("cv", (f.OperandSpec("x", "lhs"), f.OperandSpec("w", "rhs")),
                                   nodes=(f.Node("n0", "add", ("acc", "x")),)),
    "TPP224": lambda f: f.TppGraph(
        "four", tuple(f.OperandSpec(n, "lhs" if n == "x" else "rhs") for n in "xabcd"),
        roots=tuple(f.ContractionRoot(f"r{n}", "x", n) for n in "abcd"),
        outputs=("ra", "rb", "rc", "rd")),
}


@pytest.mark.parametrize("code", sorted(UNSUPPORTED))
def test_generator_refuses_with_a_stable_code(code):
    g = UNSUPPORTED[code](tf)
    with pytest.raises(tf.FusionLegalityError) as e:
        fused_gemm.generate_source(tf.simplify_graph(g))
    assert e.value.code == code
    with pytest.raises(tf.FusionLegalityError) as e:
        tf.compile(g, path="cuda")
    assert e.value.code == code
    # the composed reference path takes it
    tf.compile(g, path="reference")


def _bwd(f, g, role):
    plan = f.derive_vjp(g)
    return next(gr for nm, gr in plan.fused_graphs().items() if plan.graph_role(nm) == role)


# The graphs the generator once refused (chained root, row panel, transposed
# operands, coordinate-keyed ops) and now takes, with what their source says.
ACCEPTED = {
    "chained causal": (lambda f: f.fused_attention_graph(causal=True), ["chain_entry"]),
    "chained window offset": (lambda f: f.fused_attention_graph(causal=True, window=8, offset=3),
                              ["fg_attn_keep(gm, gn, true, 8, 3)", "n0 + bn - 1 <= m0 + 3 - 8"]),
    "panel softmax": (lambda f: _bwd(f, f.fused_attention_graph(causal=True), "p"),
                      ["fg::RED_SOFTMAX;"]),
    "panel softmax_grad": (lambda f: _bwd(f, f.fused_attention_graph(causal=True), "dz"),
                           ["fg::RED_SOFTMAX_GRAD;"]),
    "panel rmsnorm": (lambda f: f.fused_attn_out_graph(True, "rmsnorm"), ["fg::RED_RMSNORM;"]),
    "panel layernorm_grad": (lambda f: _bwd(f, f.fused_output_graph(0.1), "dz"),
                             ["fg::RED_LN_GRAD;", "fg_dropout_rng("]),
    "trans": (_trans_graph, ["trans_rhs(int r) { return true; }"]),
    "dropout_rng": (lambda f: f.fused_attn_out_graph(True, dropout_rate=0.1),
                    ["NDRAW = 1;", "(keep >> 0) & 1u ?"]),
}


@pytest.mark.parametrize("case", sorted(ACCEPTED))
def test_generator_takes_the_training_slice_graphs(case):
    make, markers = ACCEPTED[case]
    g = tf.simplify_graph(make(tf))
    src = fused_gemm.generate_source(g)
    for marker in markers:
        assert marker in src, marker
    assert callable(tf.compile(g, path="cuda"))   # compiling builds nothing yet
    tf.compile(g, path="reference")


def test_generator_refuses_an_op_without_an_expression():
    from repro_torch.fusion.graph import EpilogueOp
    tf.register_epilogue(EpilogueOp("my_square", 1, (), lambda v: v * v))
    try:
        g = tf.TppGraph.chain("sq", ["my_square"], [("x", "lhs"), ("w", "rhs")])
        with pytest.raises(tf.FusionLegalityError) as e:
            fused_gemm.generate_source(g)
        assert e.value.code == "TPP225"
    finally:
        del T_OPS["my_square"]


def test_every_pointwise_op_has_an_expression():
    for name, op in T_OPS.items():
        if op.reduces is None and not op.wants_offsets:
            g = _single_op_graph("torch", name)
            assert f"= {name}(" in fused_gemm.generate_source(tf.simplify_graph(g)) \
                or name == "identity"


def test_the_kernel_raises_on_cpu_tensors():
    g = tf.fused_gated_mlp_graph("silu")
    _, tops = _operands(g, "float32", seed=0)
    fn = tf.compile(g, path="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(**tops)
    # a narrow root that feeds the epilogue is refused as the reference does
    tops["wu"] = tops["wu"][:, :64]
    with pytest.raises(tf.FusionLegalityError, match="per-root N widths"):
        fn(**tops)


# --------------------------------------------------------------------------
# The fused blocks against repro's, on one set of weights
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama2_13b", "gptj_6b"])
def test_fused_blocks_match_the_reference(arch):
    jcfg = dataclasses.replace(jax_config(arch).reduced(), use_fusion=True)
    tcfg = dataclasses.replace(torch_config(arch).reduced(), use_fusion=True)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    jlayer = jax.tree.map(lambda a: a[0], jparams["groups"][0][0])
    tlayer = tparams["layers"][0]
    rng = np.random.default_rng(7)
    b, s, d = 2, 8, jcfg.d_model
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    res = rng.normal(size=(b, s, d)).astype(np.float32)

    want = jblocks.mlp_apply(jcfg, jlayer["mlp"], jnp.asarray(x.reshape(b * s, d)))
    got = tblocks.mlp_apply(tcfg, tlayer["mlp"], torch.from_numpy(x.reshape(b * s, d)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)

    # attention with the residual folded in: prefill into a dense cache
    jcache = {"k": jnp.zeros((b, jcfg.num_kv_heads, s, jcfg.head_dim)),
              "v": jnp.zeros((b, jcfg.num_kv_heads, s, jcfg.head_dim))}
    tcache = {"k": torch.zeros(b, tcfg.num_kv_heads, s, tcfg.head_dim),
              "v": torch.zeros(b, tcfg.num_kv_heads, s, tcfg.head_dim)}
    want, _ = jblocks.attention_apply(jcfg, jlayer["attn"], jnp.asarray(x), cache=jcache,
                                      cache_pos=0, residual=jnp.asarray(res))
    got, _ = tblocks.attention_apply(tcfg, tlayer["attn"], torch.from_numpy(x), cache=tcache,
                                     cache_pos=0, residual=torch.from_numpy(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)
    # and without a cache (the reference's chained-root attention)
    want, _ = jblocks.attention_apply(jcfg, jlayer["attn"], jnp.asarray(x), residual=jnp.asarray(res))
    got, _ = tblocks.attention_apply(tcfg, tlayer["attn"], torch.from_numpy(x),
                                     residual=torch.from_numpy(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-3)


def test_fused_training_takes_steps():
    """``use_fusion=True`` trains: forward_hidden and lm_loss take gradients
    through the fused layers, and make_train_step lowers the loss (the
    trajectory against repro's is tests/test_torch_fusion_autodiff.py)."""
    from repro_torch.data import DataConfig, SyntheticCorpus, to_device
    from repro_torch.models import lm as tlm
    from repro_torch.train import TrainConfig, init_train_state, make_train_step
    cfg = dataclasses.replace(torch_config("minicpm_2b").reduced(), use_fusion=True,
                              dropout_rate=0.1)
    tcfg = TrainConfig(peak_lr=1e-2, warmup_steps=0, total_steps=100, loss_chunk=8)
    params, opt = init_train_state(cfg, tcfg, 0, device="cpu")
    batch = to_device(SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                                 global_batch=2, seed=1)).batch_at(0), "cpu")
    h, _, _ = tlm.forward_hidden(cfg, params, batch, dropout_seed=3)
    assert h.requires_grad and torch.isfinite(h).all()
    step = make_train_step(cfg, tcfg)
    losses = []
    for i in range(4):
        params, opt, m = step(params, opt, batch, i)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
