"""K5: the fused-TppGraph kernel, a CUDA C++ code generator and its wrapper.

Replaces ``repro/fusion/lowering.py:330 _compile_pallas`` (→
``core/pallas_lowering.py make_pallas_fn``).  For each distinct simplified
graph, ``generate_source`` emits one CUDA source: a header naming what it
replaces, a struct ``Epi`` holding the graph's root count, its lhs map, its
operands' stored layouts and its epilogue DAG as straight-line fp32 C++
(one expression per pointwise node, in topological order), and the C entry
point, around one of two fixed templates, whose headers say what bounds the
kernel on an H100 and what the design does about it:

  * ``csrc/fused_gemm.cuh``: base roots (up to three sharing one (M, K, N)
    problem) with a pointwise epilogue, or with a reducing node run as a
    row panel (``softmax``, ``softmax_grad``, ``layernorm``, ``rmsnorm`` and
    their gradients: ``Epi`` then splits into the pre-reduce nodes, which
    stage the reducer's inputs, the reducer's close and the post-reduce
    nodes);
  * ``csrc/fused_chain.cuh``: a chained root, ``softmax_online(...) @ v``
    streamed over the base root's N tiles (flash attention as IR).

And for a chained graph's gradient, ``generate_backward_source`` emits one
source per graph and head dim around ``csrc/attention_bwd.cuh`` (the
backward mainloop K6 also runs): its ``Epi`` is the graph's pre-reduce
nodes (``pre``, what the forward's ``chain_pre`` computes), the derivative
nodes its derived dz graph holds after ``softmax_grad`` (``grad``, with
``softmax_grad`` replaced by the flash identity P ∘ (dP - D), P rebuilt from
the forward's row log-sum-exp) and the forward's dead-tile rule
(``tile_dead``); ``ChainedBackward`` launches it in place of the six
derived graphs of ``fusion.autodiff.ChainedBackwardPlan``.

Both take operands stored transposed (``trans=True``, read in place), lhs
and rhs of either dtype (all-bf16 runs the tensor cores; any fp32 operand
an fp32 SIMT mainloop, the reference's promotion to fp32), leading batch
axes (one problem per ``grid.z`` index) and the coordinate-keyed ops
``dropout_rng``/``dropout_rng_grad`` (threefry2x32-20 at the element's
coordinates in its 2-D problem, the bits of ``fusion/rng.py tile_bits``)
and ``attn_mask``/``attn_mask_grad``.  The source is built by ``nvcc`` for
``sm_90a`` at first use into ``build/kernels/`` (``_build.load_generated``)
and launched through one fixed C signature; graphs of the same structure
(the same roots, operands and nodes under another graph name) share it.

A schedule reaches a launch as data, never as source: given a plan
(``fusion.lowering.plan_graph``), the wrapper passes ``order_table``'s
CTA tiles in the plan's visit order (row blocks for a row panel or a
chained root) and runs a 1-D grid over them, and under ``hw_prng`` sets the
``hw`` flag and the plan's PRNG tile, so the generated ``dropout_rng``
expression draws K13's Philox4x32-10 bits (``csrc/philox.cuh``) instead of
threefry.  Without a plan the fixed 2-D grid runs, as before schedules
existed.

What the generator does not take raises ``FusionLegalityError`` with a
stable code; the composed reference path (``fusion.lowering``) takes all of
these:

  ========  ==========================================================
  TPP207    a contraction operand read as an epilogue value (the
            reference's code)
  TPP224    more than 3 roots or 8 epilogue operands
  TPP225    an op without a CUDA expression or close (registered after
            this generator was written)
  TPP226    a chained graph with more than one base root; or, at call
            time, a chain wider than 128
  TPP228    a chained backward whose k is not stored (N, K), whose dz
            graph holds no single softmax_grad of dP, or whose head dim
            the backward mainloop does not build
  ========  ==========================================================
"""
from __future__ import annotations

import ctypes
import hashlib
import struct

import torch

from repro_torch.fusion import rng
from repro_torch.fusion.graph import EPILOGUE_OPS, FusionLegalityError, TppGraph
from repro_torch.fusion.lowering import HW_PRNG_OPS, contraction_operand_values
from repro_torch.kernels import _build
from repro_torch.kernels.brgemm import _device_table, tile_order

__all__ = ["FusedKernel", "ChainedBackward", "generate_source", "generate_backward_source",
           "source_name", "check_supported", "cta_tile", "order_table", "LAUNCHES",
           "GRAPH_LAUNCHES", "HW_PRNG_LAUNCHES", "MAX_ROOTS", "MAX_EPILOGUE_OPERANDS",
           "MAX_CHAIN", "BACKWARD_SUFFIX"]

# Launches of a generated kernel since import (or since a caller reset them),
# in all and by graph name (a chained backward under its forward graph's
# name + BACKWARD_SUFFIX); and those that drew K13's bits (hw_prng=True on a
# graph with a dropout_rng node).
LAUNCHES = 0
GRAPH_LAUNCHES: dict[str, int] = {}
HW_PRNG_LAUNCHES = 0

MAX_ROOTS = 3
MAX_EPILOGUE_OPERANDS = 8
MAX_CHAIN = 128
BACKWARD_SUFFIX = "@bwd_flash"
_DTYPES = (torch.float32, torch.bfloat16)
_EP_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.bool: 2}
_SCALAR = 3


def _f32_literal(x: float) -> str:
    """``x`` rounded to fp32, as an exact C++ hex float literal."""
    v = struct.unpack("f", struct.pack("f", float(x)))[0]
    return f"{v.hex()}f"


def _dropout_expr(v, mask, attrs):
    rate = float(attrs.get("rate", 0.0))
    if rate <= 0.0:
        return v
    return f"({mask} ? {v} * {_f32_literal(1.0 / (1.0 - rate))} : 0.0f)"


def _dropout_rng_expr(v, seed, attrs):
    rate = float(attrs.get("rate", 0.0))
    if rate <= 0.0:
        return v
    salt = int(attrs.get("salt", 0)) & 0xFFFFFFFF
    # under hw, K13's tile: (a.prng_tm, prng_tn), prng_tn declared by the
    # body (_Emitter.nodes)
    return (f"fg_dropout_rng({v}, {seed}, {salt}u, {rng.keep_threshold(rate)}u, "
            f"{_f32_literal(1.0 / (1.0 - rate))}, gm, gn, a.hw, a.prng_tm, prng_tn)")


def _keep(at) -> str:
    return (f"fg_attn_keep(gm, gn, {'true' if at.get('causal', True) else 'false'}, "
            f"{int(at.get('window', 0))}, {int(at.get('offset', 0))})")


# One C++ expression per pointwise op: value inputs first, then the
# operands, as strings; the node's attrs last.  ``gm`` and ``gn`` (the
# element's row and column in its 2-D problem) are in scope.
_EXPR = {
    "identity": lambda v, at: v[0],
    "relu": lambda v, at: f"fmaxf({v[0]}, 0.0f)",
    "gelu": lambda v, at: f"fg_gelu({v[0]})",
    "silu": lambda v, at: f"fg_silu({v[0]})",
    "sigmoid": lambda v, at: f"fg_sigmoid({v[0]})",
    "scale": lambda v, at: f"{v[0]} * {_f32_literal(at['s'])}",
    "add": lambda v, at: f"{v[0]} + {v[1]}",
    "sub": lambda v, at: f"{v[0]} - {v[1]}",
    "mul": lambda v, at: f"{v[0]} * {v[1]}",
    "residual_add": lambda v, at: f"{v[0]} + {v[1]}",
    "bias_add": lambda v, at: f"{v[0]} + {v[1]}",
    "scale_rowvec": lambda v, at: f"{v[0]} * {v[1]}",
    "dropout": lambda v, at: _dropout_expr(v[0], v[1], at),
    "dropout_grad": lambda v, at: _dropout_expr(v[0], v[1], at),
    "dropout_rng": lambda v, at: _dropout_rng_expr(v[0], v[1], at),
    "dropout_rng_grad": lambda v, at: _dropout_rng_expr(v[0], v[1], at),
    "attn_mask": lambda v, at: f"({_keep(at)} ? {v[0]} : FG_NEG_INF)",
    "attn_mask_grad": lambda v, at: f"({_keep(at)} ? {v[0]} : 0.0f)",
    "relu_grad": lambda v, at: f"({v[1]} > 0.0f ? {v[0]} : {v[0]} * 0.0f)",
    "gelu_grad": lambda v, at: f"fg_gelu_grad({v[0]}, {v[1]})",
    "silu_grad": lambda v, at: f"fg_silu_grad({v[0]}, {v[1]})",
    "sigmoid_grad": lambda v, at: f"fg_sigmoid_grad({v[0]}, {v[1]})",
}

# The row-panel close of each reducing op (csrc/fused_gemm.cuh, enum Red)
# and its default eps (the ops' ``apply`` defaults).
_RED = {
    "softmax": ("RED_SOFTMAX", 1e-5), "softmax_online": ("RED_SOFTMAX", 1e-5),
    "softmax_grad": ("RED_SOFTMAX_GRAD", 1e-5),
    "layernorm": ("RED_LAYERNORM", 1e-5), "rmsnorm": ("RED_RMSNORM", 1e-6),
    "layernorm_grad": ("RED_LN_GRAD", 1e-5), "layernorm_gamma_grad": ("RED_LN_GAMMA_GRAD", 1e-5),
    "rmsnorm_grad": ("RED_RMS_GRAD", 1e-6), "rmsnorm_gamma_grad": ("RED_RMS_GAMMA_GRAD", 1e-6),
}


def check_supported(graph: TppGraph) -> None:
    """Raise ``FusionLegalityError`` (codes in the module docstring) for a
    graph the generator does not take."""
    bad = sorted(contraction_operand_values(graph))
    if bad:
        raise FusionLegalityError(
            f"graph {graph.name!r}: contraction operand(s) {bad} are referenced "
            "as epilogue values — the fused kernel only sees their K-indexed "
            "tiles; use the reference path for this graph", code="TPP207")
    if graph.chained_root() is not None and len(graph.base_roots) != 1:
        raise FusionLegalityError(
            f"graph {graph.name!r}: a chained root over {len(graph.base_roots)} base "
            "roots; the chained kernel streams one", code="TPP226")
    for nd in graph.nodes:
        if nd.op not in _EXPR and nd.op not in _RED:
            raise FusionLegalityError(
                f"graph {graph.name!r}: node {nd.name!r} uses op {nd.op!r}, which "
                "has no CUDA expression in kernels/fused_gemm.py", code="TPP225")
    if len(graph.base_roots) > MAX_ROOTS or len(graph.epilogue_operands) > MAX_EPILOGUE_OPERANDS:
        raise FusionLegalityError(
            f"graph {graph.name!r}: {len(graph.base_roots)} roots and "
            f"{len(graph.epilogue_operands)} epilogue operands; the kernel takes at "
            f"most {MAX_ROOTS} and {MAX_EPILOGUE_OPERANDS}", code="TPP224")


def _lhs_names(graph: TppGraph) -> tuple[str, ...]:
    return tuple(dict.fromkeys(r.lhs for r in graph.base_roots))


def _ident(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


def _select(values, default, var="i") -> str:
    """A C conditional on ``var`` over a list of expressions."""
    if not values:
        return default
    out = values[-1]
    for i in range(len(values) - 2, -1, -1):
        out = f"{var} == {i} ? {values[i]} : {out}"
    return out


def _bool(x) -> str:
    return "true" if x else "false"


class _Emitter:
    """Straight-line fp32 C++ for a list of nodes: one ``const float`` a
    value, operands read where a node takes them."""

    def __init__(self, graph: TppGraph, full_row: bool = False):
        self.graph = graph
        self.full_row = full_row
        self.ep_index = {o.name: i for i, o in enumerate(graph.epilogue_operands)}
        self.env: dict[str, str] = {}
        self.lines: list[str] = []

    def operand(self, ref: str) -> str:
        spec = self.graph.operand(ref)
        i = self.ep_index[ref]
        if spec.kind == "rowvec":
            return f"fg_load(a.ep[{i}], a.ep_dtype[{i}], gn)"
        if spec.kind == "scalar":
            return f"a.ep_u32[{i}]"
        at = f"c.off(a.s_ep[{i}]) + (long long)gm * a.ld_ep[{i}] + gn"
        if spec.kind == "mask":
            return f"fg_mask(a.ep[{i}], {at})"
        return f"fg_load(a.ep[{i}], a.ep_dtype[{i}], {at})"

    def value(self, ref: str) -> str:
        return self.env[ref] if ref in self.env else self.operand(ref)

    def roots(self, exprs):
        roots = self.graph.base_roots
        for r, e in zip(roots, exprs):
            self.env[r.name] = f"r_{_ident(r.name)}"
            self.lines.append(f"    const float {self.env[r.name]} = {e};  // root {r.name} = "
                              f"{r.lhs} @ {r.rhs}")
        if len(self.graph.roots) == 1:
            self.env["acc"] = self.env[roots[0].name]

    def nodes(self, nodes):
        if any(nd.op in HW_PRNG_OPS for nd in nodes):
            # the width of K13's tile: the plan's, or full rows after the
            # reducing node
            self.lines.append(f"    const int prng_tn = {'a.N' if self.full_row else 'a.prng_tn'};")
        for nd in nodes:
            args = [self.value(r) for r in nd.inputs]
            var = f"v_{_ident(nd.name)}"
            attrs = ", ".join(f"{a}={v}" for a, v in nd.attrs)
            self.lines.append(
                f"    const float {var} = {_EXPR[nd.op](args, nd.attr_dict())};"
                f"  // {nd.name} = {nd.op}({', '.join(nd.inputs)}" + (f"; {attrs}" if attrs else "") + ")")
            self.env[nd.name] = var

    def outputs(self):
        for q, o in enumerate(self.graph.outputs):
            self.lines.append(f"    out[{q}] = {self.env[o]};")


_ARGS = "int gm, int gn, const FusedArgs& a, const FgCtx& c"


def _scratch(j: int) -> str:
    return f"a.scratch[c.off(a.s_scratch) + ((long long){j} * a.M + gm) * a.N + gn]"


def _plain_body(graph: TppGraph) -> list[str]:
    em = _Emitter(graph)
    em.roots([f"acc[{i}]" for i in range(len(graph.base_roots))])
    em.nodes(graph.nodes)
    em.outputs()
    return [f"  __device__ __forceinline__ static void apply(const float* acc, {_ARGS}, float* out) {{",
            *em.lines, "  }"]


def _panel_body(graph: TppGraph) -> list[str]:
    red = graph.reducing_node()
    idx = graph.nodes.index(red)
    op = EPILOGUE_OPS[red.op]
    staged = graph.staged_values()
    kind, eps = _RED[red.op]
    eps = float(red.attr_dict().get("eps", eps))
    pre = _Emitter(graph)
    pre.roots([f"acc[{i}]" for i in range(len(graph.base_roots))])
    pre.nodes(graph.nodes[:idx])
    stage = [f"    {_scratch(j)} = {pre.env[nm]};  // staged {nm}" for j, nm in enumerate(staged)]
    near = _Emitter(graph)
    near.env.update({nm: _scratch(j) for j, nm in enumerate(staged)})
    vals = [near.value(r) for r in red.inputs[:op.value_arity]]
    params = [near.value(r) for r in red.inputs[op.value_arity:]]
    post = _Emitter(graph, full_row=True)
    post.env.update(near.env)
    post.env[red.name] = "y"
    post.nodes(graph.post_reduce_nodes())
    post.outputs()
    attrs = ", ".join(f"{a}={v}" for a, v in red.attrs)
    return [
        f"  // the reducing node: {red.name} = {red.op}({', '.join(red.inputs)}"
        + (f"; {attrs}" if attrs else "") + ")",
        f"  static constexpr int RED = fg::{kind};",
        f"  static constexpr float EPS = {_f32_literal(eps)};",
        f"  static constexpr int NSTAGED = {len(staged)};",
        "  // pre-reduce nodes, per N tile: stage the reducer's computed inputs",
        f"  __device__ __forceinline__ static void pre(const float* acc, {_ARGS}) {{",
        *pre.lines, *stage, "  }",
        "  // the reducer's value inputs at (gm, gn), from the staged panel or an operand",
        f"  __device__ __forceinline__ static float red_in(int i, {_ARGS}) {{",
        f"    return {_select(vals, '0.0f')};", "  }",
        "  // the reducer's row-vector parameters at column gn",
        "  __device__ __forceinline__ static float red_param(int i, int gn, const FusedArgs& a) {",
        f"    return {_select(params, '0.0f')};", "  }",
        "  // post-reduce nodes on the closed row, and the outputs",
        f"  __device__ __forceinline__ static void post(float y, {_ARGS}, float* out) {{",
        *post.lines, "  }",
    ]


def _chain_pre(graph: TppGraph):
    """(C++ lines of the pre-reduce nodes on a score ``s``, the softmax
    input's variable, the dead-tile condition): a chained graph's
    ``chain_pre`` and ``tile_dead``."""
    red = graph.reducing_node()
    idx = graph.nodes.index(red)
    em = _Emitter(graph)
    em.roots(["s"])
    em.nodes(graph.nodes[:idx])
    z = red.inputs[EPILOGUE_OPS[red.op].stats_input or 0]
    dead = "false"
    by_name = {nd.name: nd for nd in graph.nodes}
    if z in by_name and by_name[z].op == "attn_mask":
        # the reducer reads the mask's fills directly: a tile every score
        # of which is masked adds nothing, and is skipped
        at = by_name[z].attr_dict()
        off, win = int(at.get("offset", 0)), int(at.get("window", 0))
        parts = []
        if at.get("causal", True):
            parts.append(f"n0 > m0 + bm - 1 + {off}")
        if win > 0:
            parts.append(f"n0 + bn - 1 <= m0 + {off} - {win}")
        dead = " || ".join(parts) or "false"
    return em.lines, em.env[z], dead


def _chain_body(graph: TppGraph) -> list[str]:
    lines, z, dead = _chain_pre(graph)
    return [
        "  // the pre-reduce nodes on a score s at (gm, gn): the softmax_online input",
        f"  __device__ __forceinline__ static float chain_pre(float s, {_ARGS}) {{",
        *lines, f"    return {z};", "  }",
        "  // a score tile (rows m0.., columns n0..) whose every score is masked",
        "  __host__ __device__ static constexpr bool tile_dead(int m0, int bm, int n0, int bn) {",
        f"    return {dead};", "  }",
    ]


def generate_source(graph: TppGraph) -> str:
    """The CUDA source of K5 for ``graph`` (already simplified): the same
    text for the same graph, every run.  The text names no graph, so graphs
    of one structure share it (and its library)."""
    check_supported(graph)
    roots = graph.base_roots
    lhs = _lhs_names(graph)
    lhs_of = [lhs.index(r.lhs) for r in roots]
    lhs_expr = _select([str(x) for x in lhs_of], "0", "r")
    trans_l = _select([_bool(graph.operand(nm).trans) for nm in lhs], "false")
    trans_r = _select([_bool(graph.operand(r.rhs).trans) for r in roots], "false", "r")
    chain = graph.chained_root() is not None
    panel = graph.reducing_node() is not None and not chain
    described = "\n".join(f"//   {line}" for line in graph.describe().splitlines()[1:])
    kind = ("a chained root (csrc/fused_chain.cuh)" if chain else
            "a row panel (csrc/fused_gemm.cuh)" if panel else "a pointwise epilogue (csrc/fused_gemm.cuh)")
    body = _chain_body(graph) if chain else _panel_body(graph) if panel else _plain_body(graph)
    return "\n".join([
        "// K5, generated by repro_torch/kernels/fused_gemm.py for the TppGraph",
        described,
        f"// as {kind}.",
        "//",
        "// Replaces the TPU kernel repro/fusion/lowering.py:330 `_compile_pallas` for this",
        "// graph.  What bounds it on an H100 and what the design does about it is in the",
        "// template's header.",
        f'#include "{"fused_chain.cuh" if chain else "fused_gemm.cuh"}"',
        "",
        "struct Epi {",
        f"  static constexpr int R = {len(roots)};",
        f"  static constexpr int NLHS = {len(lhs)};",
        f"  static constexpr int NOUT = {len(graph.outputs)};",
        f"  static constexpr bool PANEL = {_bool(panel)};",
        "  // which distinct lhs operand (" + ", ".join(lhs) + ") each root reads",
        f"  __host__ __device__ static constexpr int lhs_of(int r) {{ return {lhs_expr}; }}",
        "  // stored transposed: the distinct lhs operands, each root's rhs",
        f"  __host__ __device__ static constexpr bool trans_lhs(int i) {{ return {trans_l}; }}",
        f"  __host__ __device__ static constexpr bool trans_rhs(int r) {{ return {trans_r}; }}",
        *body,
        "};",
        "",
        'extern "C" int fused_gemm(const FusedArgs* args, void* stream) {',
        f"  return fg::{'chain_entry' if chain else 'entry'}<Epi>(args, stream);",
        "}",
        "",
    ])


def generate_backward_source(plan, head_dim: int) -> str:
    """The CUDA source of K5's chained backward for ``plan`` (the
    ``fusion.autodiff.ChainedBackwardPlan`` of a simplified chained graph)
    at ``head_dim``: the same text for the same graph and head dim, every
    run, naming no graph.  Raises ``FusionLegalityError`` (TPP228) for a
    graph or head dim the backward mainloop does not take."""
    from repro_torch.fusion.autodiff import flash_node
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    graph, dz = plan.forward, plan.graphs["dz"]
    check_supported(graph)
    if not plan.rhs_trans or head_dim not in HEAD_DIMS:
        raise FusionLegalityError(
            f"graph {graph.name!r}: the chained backward reads k stored (N, K) at a head "
            f"dim in {HEAD_DIMS}; k trans={plan.rhs_trans}, head dim {head_dim}", code="TPP228")
    sg = flash_node(plan)
    lines, z, dead = _chain_pre(graph)
    em = _Emitter(dz)
    em.roots(["s"])
    at = dz.nodes.index(sg)
    em.nodes(dz.nodes[:at])
    em.env[sg.name] = "dz"
    em.lines.append(f"    // {sg.name} = softmax_grad({', '.join(sg.inputs)}): dz, the flash identity")
    em.nodes(dz.nodes[at + 1:])
    for nd in dz.nodes:
        if nd.op not in _EXPR and nd is not sg:
            raise FusionLegalityError(
                f"graph {dz.name!r}: node {nd.name!r} ({nd.op}) has no CUDA expression",
                code="TPP225")
    described = "\n".join(f"//   {line}" for line in graph.describe().splitlines()[1:])
    params = "const attn_bwd::Params&"
    return "\n".join([
        "// K5's chained backward, generated by repro_torch/kernels/fused_gemm.py for the TppGraph",
        described,
        f"// at head dim {head_dim}: the backward mainloop of csrc/attention_bwd.cuh on the",
        "// graph's pre-reduce nodes (pre) and the derivative nodes of its dz graph (grad),",
        "// softmax_grad replaced by the flash identity P * (dP - D).",
        "//",
        "// Replaces the TPU kernels repro/fusion/lowering.py:330 `_compile_pallas` runs for",
        "// the six graphs of repro/fusion/autodiff.py:236 ChainedBackwardPlan.  What bounds it",
        "// on an H100 and what the design does about it is in the mainloop's header.",
        '#include "fused_gemm.cuh"',
        '#include "attention_bwd.cuh"',
        "",
        "struct Epi {",
        "  // the pre-reduce nodes on a score s at (gm, gn): the softmax_online input",
        f"  __device__ __forceinline__ static float pre(float s, int gm, int gn, {params}) {{",
        *lines, f"    return {z};", "  }",
        "  // the dz graph's nodes on dz, the softmax input's cotangent: the score's",
        f"  __device__ __forceinline__ static float grad(float dz, float s, int gm, int gn, {params}) {{",
        *em.lines, f"    return {em.env[dz.outputs[0]]};", "  }",
        "  // a score tile (rows m0.., columns n0..) whose every score is masked",
        f"  __host__ __device__ static bool tile_dead(int m0, int bm, int n0, int bn, {params}) {{",
        f"    return {dead};", "  }",
        "};",
        "",
        'extern "C" int attention_bwd(const void* q, const void* k, const void* v, const void* o,',
        "                             const void* lse, const void* dout, void* stats, void* dq,",
        "                             void* dk, void* dv, int bf16_, int B, int H, int Hk, int Sq,",
        "                             int Skv, int D, const int* plan, const long long* strides,",
        "                             int causal, int window, float scale, void* stream) {",
        f"  return attn_bwd::entry<Epi, {head_dim}>(q, k, v, o, lse, dout, stats, dq, dk, dv, bf16_,",
        "                                     B, H, Hk, Sq, Skv, D, plan, strides, causal, window,",
        "                                     scale, stream);",
        "}",
        "",
    ])


def backward_source_name(source: str) -> str:
    """The build name of a chained backward source: a hash of its text."""
    return f"fused_attention_bwd_{hashlib.sha256(source.encode()).hexdigest()[:12]}"


def source_name(graph: TppGraph, source: str) -> str:
    """The build name of a graph's source: a hash of the text, which is
    the same for every graph of one structure."""
    return f"fused_gemm_{hashlib.sha256(source.encode()).hexdigest()[:12]}"


_L2 = ctypes.c_longlong * 2


class _Args(ctypes.Structure):
    """The C struct ``FusedArgs`` of ``csrc/fused_gemm.cuh``."""
    _fields_ = [("lhs", ctypes.c_void_p * MAX_ROOTS),
                ("rhs", ctypes.c_void_p * MAX_ROOTS),
                ("crhs", ctypes.c_void_p),
                ("ep", ctypes.c_void_p * MAX_EPILOGUE_OPERANDS),
                ("out", ctypes.c_void_p),
                ("scratch", ctypes.c_void_p),
                ("lda", ctypes.c_longlong * MAX_ROOTS),
                ("ldb", ctypes.c_longlong * MAX_ROOTS),
                ("ldc", ctypes.c_longlong),
                ("ld_ep", ctypes.c_longlong * MAX_EPILOGUE_OPERANDS),
                ("s_lhs", _L2 * MAX_ROOTS),
                ("s_rhs", _L2 * MAX_ROOTS),
                ("s_crhs", _L2),
                ("s_ep", _L2 * MAX_EPILOGUE_OPERANDS),
                ("s_out", _L2),
                ("s_scratch", _L2),
                ("lhs_bf16", ctypes.c_int * MAX_ROOTS),
                ("rhs_bf16", ctypes.c_int * MAX_ROOTS),
                ("crhs_bf16", ctypes.c_int),
                ("ep_dtype", ctypes.c_int * MAX_EPILOGUE_OPERANDS),
                ("ep_u32", ctypes.c_uint * MAX_EPILOGUE_OPERANDS),
                ("M", ctypes.c_int), ("N", ctypes.c_int), ("K", ctypes.c_int),
                ("N2", ctypes.c_int), ("R", ctypes.c_int),
                ("width", ctypes.c_int * MAX_ROOTS),
                ("B1", ctypes.c_int), ("batch", ctypes.c_int),
                ("all_bf16", ctypes.c_int), ("out_bf16", ctypes.c_int), ("vec", ctypes.c_int),
                ("order", ctypes.c_void_p), ("n_order", ctypes.c_int),
                ("prng_tm", ctypes.c_int), ("prng_tn", ctypes.c_int), ("hw", ctypes.c_int),
                ("lse", ctypes.c_void_p)]


def cta_tile(graph: TppGraph, m: int, n: int, all_bf16: bool) -> tuple[int, int]:
    """The (rows, columns) of the output one K5 block computes, as the
    templates' dispatch picks them: a chained root 64 rows, a row panel 64
    (bf16) or 128 (SIMT) whole rows; else SIMT 128x64, bf16 16x64 for M <=
    16, 128x128 for one root and 128x64 for two or three."""
    if graph.chained_root() is not None:
        return 64, n
    if graph.reducing_node() is not None:
        return (64 if all_bf16 else 128), n
    if not all_bf16:
        return 128, 64
    if m <= 16:
        return 16, 64
    return (128, 128) if len(graph.base_roots) == 1 else (128, 64)


def order_table(gp, m: int, n: int, cta: tuple[int, int]) -> torch.Tensor:
    """(T, 2) int32 origins of K5's CTA tiles ``cta`` in the order the
    plan ``gp`` (``fusion.lowering.GraphPlan``) first visits them: each
    visited output block lists the tiles it touches (a full-row block: the
    row bands), a tile shared with an earlier block keeping its first
    place.  A stacking axis of several outputs is not a tile dimension."""
    letters = gp.out_letters
    bi, ci = letters.index("b"), (letters.index("c") if "c" in letters else None)
    block = gp.plan.out_block
    visits = [(v[bi], v[ci] if ci is not None else 0) for v in gp.plan.visit_order.tolist()]
    return tile_order(visits, (block[bi], block[ci] if ci is not None else n), cta)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """An operand whose rows have unit stride (a contiguous copy of
    anything else); its leading batch axes may have any strides."""
    if t.stride(-1) == 1 and (t.shape[-2] <= 1 or t.stride(-2) >= max(t.shape[-1], 1)):
        return t
    return t.contiguous()


def _batch_strides(t: torch.Tensor, nb: int) -> tuple[int, int]:
    """Strides of the (B0, B1) problem axes for an operand with ``nb``
    leading batch axes (0 for an operand every problem shares)."""
    if t.dim() == 2:
        return 0, 0
    if nb == 1:
        return 0, t.stride(0)
    return t.stride(0), t.stride(1)


class FusedKernel:
    """K5 for one simplified graph: ``kernel(operands, out_dtype=None)`` on
    CUDA tensors returns what the composed reference returns (``(*batch,
    M, N)``, ``(*batch, NOUT, M, N)`` stacked and zero-padded past narrow
    roots, or ``(*batch, M, N2)`` for a chained graph).  The source is
    generated here (raising for a graph the generator does not take); it is
    built and loaded at the first launch."""

    def __init__(self, graph: TppGraph):
        self.graph = graph
        self.source = generate_source(graph)
        self.name = source_name(graph, self.source)
        self.roots = graph.base_roots
        self.lhs = _lhs_names(graph)
        self.chain = graph.chained_root()
        self.contraction = graph.contraction_operands
        self.epilogue = graph.epilogue_operands
        self.panel = graph.reducing_node() is not None and self.chain is None
        self.staged = len(graph.staged_values()) if self.panel else 0
        consumed = {graph.resolve_acc(ref) for nd in graph.nodes for ref in nd.inputs}
        self.output_only = {r.name for r in self.roots if r.name not in consumed}
        # draws counter or K13 bits: a dropout_rng node that simplification kept
        self.draws = any(nd.op in HW_PRNG_OPS for nd in graph.nodes)
        self._lib = None

    def library(self):
        """The built and loaded library, held after the first call so a
        launch reads no file and hashes no source."""
        if self._lib is None:
            self._lib = _build.load_generated(self.name, self.source)
        return self._lib

    def _stored(self, name, operands):
        """The (M, K)-style shape an operand is read as: its last two axes,
        swapped when it is stored transposed."""
        t = operands[name]
        if t.dim() < 2:
            raise ValueError(f"graph {self.graph.name!r}: operand {name!r} has shape "
                             f"{tuple(t.shape)}, need at least 2 axes")
        r, c = t.shape[-2:]
        return (c, r) if self.graph.operand(name).trans else (r, c)

    def _shapes(self, operands):
        """→ (M, K, N, per-root widths, N2, batch shape); raises as the
        reference's Pallas path does on shapes the graph cannot take."""
        g = self.graph
        m, k = self._stored(self.lhs[0], operands)
        for nm in self.lhs:
            if self._stored(nm, operands) != (m, k):
                raise FusionLegalityError(
                    f"graph {g.name!r}: lhs operand {nm!r} has shape "
                    f"{tuple(operands[nm].shape)}, expected {(m, k)} — multi-root "
                    "graphs share one (M, K, N) problem shape")
        widths = []
        for r in self.roots:
            kk, w = self._stored(r.rhs, operands)
            if kk != k:
                raise FusionLegalityError(
                    f"graph {g.name!r}: rhs operand {r.rhs!r} has shape "
                    f"{tuple(operands[r.rhs].shape)}, expected K = {k} on its contraction dim — "
                    "all roots share the (M, K) problem")
            widths.append(int(w))
        n = max(widths)
        narrow = sorted(r.name for r, w in zip(self.roots, widths)
                        if w < n and r.name not in self.output_only)
        if narrow:
            raise FusionLegalityError(
                f"graph {g.name!r}: rhs widths differ ({widths}) but root(s) "
                f"{narrow} feed epilogue nodes — per-root N widths apply only to "
                "output-only roots (stacked, zero-padded)")
        n2 = 0
        if self.chain is not None:
            nn, n2 = operands[self.chain.rhs].shape[-2:]
            if nn != n:
                raise FusionLegalityError(
                    f"graph {g.name!r}: chain operand {self.chain.rhs!r} has "
                    f"{nn} rows, expected N = {n}")
            if n2 > MAX_CHAIN:
                raise FusionLegalityError(
                    f"graph {g.name!r}: chain width {n2}; the chained kernel takes at "
                    f"most {MAX_CHAIN}", code="TPP226")
        batched = [tuple(operands[s.name].shape[:-2]) for s in self.contraction + self.epilogue
                   if s.kind in ("lhs", "rhs", "crhs", "tile", "mask")
                   and operands[s.name].dim() > 2]
        batch = batched[0] if batched else ()
        if any(b != batch for b in batched) or len(batch) > 2:
            raise ValueError(f"graph {g.name!r}: batch axes {sorted(set(batched))}: every "
                             "batched operand needs the same one or two leading axes")
        return m, k, n, widths, int(n2), batch

    def _check(self, operands, out_dtype):
        g = self.graph
        m, k, n, widths, n2, batch = self._shapes(operands)
        for spec in self.contraction:
            if operands[spec.name].dtype not in _DTYPES:
                raise ValueError(f"graph {g.name!r}: operand {spec.name!r} dtype "
                                 f"{operands[spec.name].dtype}: need one of {_DTYPES}")
        odt = out_dtype or operands[self.roots[0].lhs].dtype
        if odt not in _DTYPES:
            raise ValueError(f"graph {g.name!r}: out_dtype {odt}: need one of {_DTYPES}")
        for spec in self.epilogue:
            v = operands[spec.name]
            if spec.kind == "scalar":
                if isinstance(v, torch.Tensor) and (v.numel() != 1 or v.is_floating_point()):
                    raise ValueError(f"graph {g.name!r}: scalar operand {spec.name!r} must "
                                     f"be one integer, got {v.dtype} {tuple(v.shape)}")
                continue
            want = (n,) if spec.kind == "rowvec" else (m, n)
            if tuple(v.shape[-len(want):]) != want or (spec.kind == "rowvec" and v.dim() != 1):
                raise ValueError(f"graph {g.name!r}: {spec.kind} operand {spec.name!r} "
                                 f"has shape {tuple(v.shape)}, want {want}")
            ok = (torch.bool,) if spec.kind == "mask" else _DTYPES
            if v.dtype not in ok:
                raise ValueError(f"graph {g.name!r}: operand {spec.name!r} dtype "
                                 f"{v.dtype}: need one of {ok}")
        for nm, v in operands.items():
            if (isinstance(v, torch.Tensor) and v.device.type != "cuda"
                    and nm in g.operand_names and g.operand(nm).kind != "scalar"):
                raise ValueError(f"graph {g.name!r}: K5 needs CUDA tensors, got {v.device}")
        return m, k, n, widths, n2, batch, odt

    def __call__(self, operands, *, out_dtype=None, plan=None, hw_prng=False, with_lse=False):
        """Launch on ``operands``; ``plan`` (a ``fusion.lowering.GraphPlan``
        at these shapes) orders the CTA tiles by its visit order and sets
        K13's tile, which ``hw_prng`` draws ``dropout_rng`` from.  With
        ``with_lse`` (a chained graph) → (out, lse): lse (*batch, M) fp32,
        each row's log-sum-exp of its live softmax inputs (-inf for a row
        with none), the chained backward's row statistics."""
        global LAUNCHES, HW_PRNG_LAUNCHES
        g = self.graph
        if hw_prng and plan is None:
            raise ValueError(f"graph {g.name!r}: hw_prng needs a plan (its tiles key K13)")
        if with_lse and self.chain is None:
            raise ValueError(f"graph {g.name!r}: only a chained root writes row statistics")
        m, k, n, widths, n2, batch, odt = self._check(operands, out_dtype)
        nout = len(g.outputs)
        nb = len(batch)
        nprob = 1
        for b in batch:
            nprob *= b
        dev = operands[self.lhs[0]].device
        if self.chain is not None:
            shape = (*batch, m, n2)
        else:
            shape = (*batch, nout, m, n) if nout > 1 else (*batch, m, n)
        out = torch.empty(shape, dtype=odt, device=dev)
        lse = torch.empty((*batch, m), dtype=torch.float32, device=dev) if with_lse else None
        if out.numel() == 0:
            return (out, lse.fill_(float("-inf"))) if with_lse else out
        args = _Args()
        keep = [out]       # the tensors whose pointers the struct holds
        vec = True

        def bind(t, ptrs, lds, strides, i):
            nonlocal vec
            t = _rows(t)
            keep.append(t)
            ptrs[i], lds[i] = t.data_ptr(), max(t.stride(-2), 1)
            s = _batch_strides(t, nb)
            strides[i][0], strides[i][1] = s
            vec = (vec and t.dtype == torch.bfloat16 and lds[i] % 8 == 0
                   and t.data_ptr() % 16 == 0 and s[0] % 8 == 0 and s[1] % 8 == 0)
            return t

        bf16 = []
        for i, nm in enumerate(self.lhs):
            t = bind(operands[nm], args.lhs, args.lda, args.s_lhs, i)
            args.lhs_bf16[i] = int(t.dtype == torch.bfloat16)
            bf16.append(t.dtype == torch.bfloat16)
        for i, r in enumerate(self.roots):
            t = bind(operands[r.rhs], args.rhs, args.ldb, args.s_rhs, i)
            args.rhs_bf16[i] = int(t.dtype == torch.bfloat16)
            bf16.append(t.dtype == torch.bfloat16)
        if self.chain is not None:
            t = _rows(operands[self.chain.rhs])
            keep.append(t)
            args.crhs, args.ldc = t.data_ptr(), max(t.stride(-2), 1)
            args.s_crhs[0], args.s_crhs[1] = _batch_strides(t, nb)
            args.crhs_bf16 = int(t.dtype == torch.bfloat16)
            args.N2 = n2
        for i, spec in enumerate(self.epilogue):
            v = operands[spec.name]
            if spec.kind == "scalar":
                args.ep_dtype[i] = _SCALAR
                args.ep_u32[i] = int(v) & 0xFFFFFFFF
                continue
            if spec.kind == "rowvec":
                t, ld = v.contiguous(), 0
            else:
                t = _rows(v)
                ld = max(t.stride(-2), 1)
                args.s_ep[i][0], args.s_ep[i][1] = _batch_strides(t, nb)
            if spec.kind == "mask":
                t = t.view(torch.uint8)
            keep.append(t)
            args.ep[i], args.ld_ep[i] = t.data_ptr(), ld
            args.ep_dtype[i] = _EP_DTYPE[v.dtype]
        args.out = out.data_ptr()
        per = out[0].numel() if nb == 1 else out[0, 0].numel() if nb == 2 else 0
        args.s_out[0] = out.shape[1] * per if nb == 2 else 0
        args.s_out[1] = per
        if self.staged:
            scratch = torch.empty((nprob, self.staged, m, n), dtype=torch.float32, device=dev)
            keep.append(scratch)
            args.scratch = scratch.data_ptr()
            args.s_scratch[0] = (batch[1] if nb == 2 else 1) * self.staged * m * n
            args.s_scratch[1] = self.staged * m * n
        args.M, args.N, args.K, args.R = m, n, k, len(widths)
        for i, w in enumerate(widths):
            args.width[i] = w
        args.B1 = batch[-1] if nb else 1
        args.batch = nprob
        args.all_bf16 = int(all(bf16))
        args.out_bf16 = int(odt == torch.bfloat16)
        args.vec = int(vec)
        args.prng_tm, args.prng_tn = plan.prng_tile if plan is not None else (1, 1)
        args.hw = int(bool(hw_prng) and self.draws)
        if with_lse:
            args.lse = lse.data_ptr()
        if plan is not None:
            cta = cta_tile(g, m, n, bool(args.all_bf16))
            order = _device_table((plan, m, n, cta), lambda: order_table(plan, m, n, cta), dev)
            args.order, args.n_order = order.data_ptr(), order.shape[0]
        lib = self.library()
        err = lib.fused_gemm(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, f"fused_gemm {g.name}")
        LAUNCHES += 1
        GRAPH_LAUNCHES[g.name] = GRAPH_LAUNCHES.get(g.name, 0) + 1
        if args.hw:
            HW_PRNG_LAUNCHES += 1
        return (out, lse) if with_lse else out


class ChainedBackward:
    """K5's chained backward for one ``fusion.autodiff.ChainedBackwardPlan``:
    ``kernel(q, k, v, o, lse, do)`` on CUDA tensors, the chained graph's
    operands (``(*batch, S, D)``, up to two batch axes, k stored (Skv, D)),
    its output ``o`` and row log-sum-exp ``lse`` (``(*batch, Sq)``, from
    ``FusedKernel(..., with_lse=True)``) and the output's cotangent → (dq,
    dk, dv) in the compute dtype, shaped as the operands (operands of
    mixed dtypes run in fp32).  The source is generated per head dim and
    built and loaded at its first launch; the checks are
    ``flash_attention.attention_backward``'s."""

    def __init__(self, plan):
        self.plan = plan
        self.name = plan.forward.name + BACKWARD_SUFFIX
        generate_backward_source(plan, 64)     # raises for a graph it does not take
        self._libs: dict[int, ctypes.CDLL] = {}

    def source(self, head_dim: int) -> str:
        return generate_backward_source(self.plan, head_dim)

    def library(self, head_dim: int):
        if head_dim not in self._libs:
            src = self.source(head_dim)
            self._libs[head_dim] = _build.load_generated(backward_source_name(src), src,
                                                         "attention_bwd")
        return self._libs[head_dim]

    def plain(self, q, k, v, o, lse, do):
        """The plain version on the same arguments: ``ref.flash_bwd_ref``
        on the graph's ``pre`` and ``grad`` (``autodiff.chained_epilogue``),
        fp32 results shaped as the operands."""
        from repro_torch.fusion.autodiff import chained_epilogue
        from repro_torch.kernels.ref import flash_bwd_ref

        pre, grad = chained_epilogue(self.plan)
        four = [_four(t) for t in (q, k, v, o, do)]
        grads = flash_bwd_ref(*four[:4], _four(lse[..., None])[..., 0], four[4], pre=pre, grad=grad)
        return tuple(g.reshape(t.shape) for g, t in zip(grads, (q, k, v)))

    def __call__(self, q, k, v, o, lse, do):
        global LAUNCHES
        from repro_torch.kernels import flash_attention as fa

        dt = q.dtype if k.dtype == v.dtype == q.dtype else torch.float32
        q4, k4, v4, o4, do4 = (_four(t.to(dt)) for t in (q, k, v, o, do))
        lse4 = _four(lse[..., None])[..., 0]
        d = q4.shape[-1]
        (dq, dk, dv), _ = fa.attention_backward(lambda: self.library(d), self.name, q4, k4, v4,
                                                o4, lse4, do4)
        LAUNCHES += 1
        GRAPH_LAUNCHES[self.name] = GRAPH_LAUNCHES.get(self.name, 0) + 1
        return tuple(g.reshape(t.shape) for g, t in zip((dq, dk, dv), (q, k, v)))


def _four(t: torch.Tensor) -> torch.Tensor:
    """A (*batch, S, D) operand with up to two batch axes as (B, H, S, D)."""
    while t.dim() < 4:
        t = t.unsqueeze(0)
    return t
