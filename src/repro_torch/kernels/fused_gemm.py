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
    streamed over the base root's N tiles (flash attention as IR): its
    ``Epi`` is the pre-reduce nodes (``pre``) and, from the graph's
    attn_mask node, the key tiles a block of rows can see (``key_range``),
    the tiles the mask crosses (``tile_mixed``) and those it masks whole
    (``tile_dead``).  One generated text serves both variants
    ``chain_plan`` picks: bf16 operands laid out as attention's (q (M, K),
    k stored (N, K), K = N2 a head dim of ``flash_attention.HEAD_DIMS``)
    run K2's forward mainloop ``csrc/attention_fwd.cuh`` (wgmma, a TMA-fed
    K/V ring; ``CHAIN_WGMMA_LAUNCHES`` counts them), every other graph an
    fp32 SIMT kernel.

And for a chained graph's gradient, ``generate_backward_source`` emits one
source per graph and head dim around ``csrc/attention_bwd.cuh`` (the
backward mainloop K6 also runs): its ``Epi`` is the graph's pre-reduce
nodes (``pre``, what the forward's ``chain_pre`` computes), the derivative
nodes its derived dz graph holds after ``softmax_grad`` (``grad``, with
``softmax_grad`` replaced by the flash identity P ∘ (dP - D), P rebuilt from
the forward's row log-sum-exp) and the forward's dead-tile rule
(``tile_dead``); ``ChainedBackward`` launches it in place of the six
derived graphs of ``fusion.autodiff.ChainedBackwardPlan``.

A graph without a chained root runs one of five variants, which
``gemm_plan`` names from the operands' dtypes, M and layout (never from a
build or launch that failed; one counter each, ``VARIANT_COUNTERS``):
``wgmma`` (bf16, M > 16, every operand TMA can read) and ``wgmma_decode``
(bf16, M <= 16: K1's split-K weight stream, splits from ``(K, N)`` alone)
on the Hopper GEMM mainloop ``csrc/gemm_mainloop.cuh``; ``wgmma_split``
(fp32 lhs against bf16 rhs or the reverse: the derived backward graphs'
fp32 dz, split by a pre-pass into bf16 hi + lo pieces that run on the same
mainloop at the fp32 tolerance); ``wmma`` (bf16 operands TMA cannot read);
``simt`` (fp32 operands).  Every variant takes operands stored transposed
(``trans=True``, read in place), leading batch
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
``hw`` flag and the plan's PRNG tile, so ``dropout_rng`` draws K13's
Philox4x32-10 bits (``csrc/philox.cuh``) instead of threefry; where that
tile's width is a multiple of 4 (``shares_draw``) the launch takes the
graph's second source (``generate_source(..., shared_draw=True)``), whose
wgmma tile draws one call for four columns.  A plain or pre-reduce body
reads its draws from a keep word the template draws; post-reduce and
chained bodies draw per element.  Without a plan the fixed 2-D grid runs,
as before schedules existed.

What the generator does not take raises ``FusionLegalityError`` with a
stable code; the composed reference path (``fusion.lowering``) takes all of
these:

  ========  ==========================================================
  TPP207    a contraction operand read as an epilogue value (the
            reference's code)
  TPP224    more than 3 roots or 8 epilogue operands
  TPP225    an op without a CUDA expression or close (registered after
            this generator was written)
  TPP226    a chained graph with more than one base root or with an
            epilogue operand (its pre-reduce nodes run inside the
            attention mainloops, which read q, k and v only); or, at call
            time, a chain wider than 256
  TPP228    a chained backward whose k is not stored (N, K), whose dz
            graph holds no single softmax_grad of dP, or whose head dim
            the backward mainloop does not build
  ========  ==========================================================
"""
from __future__ import annotations

import ctypes
import hashlib
import struct
from typing import NamedTuple

import torch

from repro_torch.fusion import rng
from repro_torch.fusion.graph import EPILOGUE_OPS, FusionLegalityError, TppGraph
from repro_torch.fusion.lowering import HW_PRNG_OPS, contraction_operand_values
from repro_torch.kernels import _build
from repro_torch.kernels.brgemm import _device_table, tile_order

__all__ = ["FusedKernel", "ChainedBackward", "generate_source", "generate_backward_source",
           "source_name", "shares_draw", "check_supported", "cta_tile", "order_table", "chain_plan",
           "chain_key_range", "chain_tile_mixed", "ChainPlan", "GemmPlan", "gemm_variant",
           "variant_of", "gemm_plan", "wgmma_tile", "split_bf16", "VARIANTS",
           "VARIANT_COUNTERS", "LAUNCHES", "GRAPH_LAUNCHES", "HW_PRNG_LAUNCHES",
           "CHAIN_WGMMA_LAUNCHES", "CHAIN_BWD_WGMMA_LAUNCHES", "WGMMA_LAUNCHES",
           "WGMMA_DECODE_LAUNCHES", "WGMMA_SPLIT_LAUNCHES", "WMMA_LAUNCHES", "SIMT_LAUNCHES",
           "MAX_ROOTS", "MAX_EPILOGUE_OPERANDS", "MAX_CHAIN", "BACKWARD_SUFFIX"]

# Launches of a generated kernel since import (or since a caller reset them),
# in all and by graph name (a chained backward under its forward graph's
# name + BACKWARD_SUFFIX); those that drew K13's bits (hw_prng=True on a
# graph with a dropout_rng node); the chained forwards and backwards that
# ran on the tensor cores (wgmma); and the launches of graphs without a
# chained root by variant (``gemm_plan``).
LAUNCHES = 0
GRAPH_LAUNCHES: dict[str, int] = {}
HW_PRNG_LAUNCHES = 0
CHAIN_WGMMA_LAUNCHES = 0
CHAIN_BWD_WGMMA_LAUNCHES = 0
WGMMA_LAUNCHES = 0
WGMMA_DECODE_LAUNCHES = 0
WGMMA_SPLIT_LAUNCHES = 0
WMMA_LAUNCHES = 0
SIMT_LAUNCHES = 0

# The variants of a graph without a chained root, by the code FusedArgs
# takes (wmma and simt share 0: all_bf16 tells them apart), and the counter
# each adds to.
VARIANTS = {"wgmma": 1, "wgmma_decode": 2, "wgmma_split": 3, "wmma": 0, "simt": 0}
VARIANT_COUNTERS = {"wgmma": "WGMMA_LAUNCHES", "wgmma_decode": "WGMMA_DECODE_LAUNCHES",
                    "wgmma_split": "WGMMA_SPLIT_LAUNCHES", "wmma": "WMMA_LAUNCHES",
                    "simt": "SIMT_LAUNCHES"}
DECODE_ROWS = 16            # wgmma_decode: M <= 16 (csrc/fused_gemm.cuh kDecodeRows)
DECODE_COLUMNS = 128        # wgmma_decode: columns of C a CTA (kDecodeCols)
_K_STEP = 64                # the mainloop's k-step (csrc/gemm_mainloop.cuh BK)
_SMEM_MAX = 232448

MAX_ROOTS = 3
MAX_EPILOGUE_OPERANDS = 8
MAX_CHAIN = 256             # the widest of flash_attention.HEAD_DIMS
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
    if graph.chained_root() is not None and graph.epilogue_operands:
        raise FusionLegalityError(
            f"graph {graph.name!r}: a chained root with epilogue operands "
            f"{[o.name for o in graph.epilogue_operands]}; the attention mainloops read "
            "q, k and v only", code="TPP226")
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
    value, operands read where a node takes them.  With ``drawn`` (the
    plain and pre-reduce bodies) a ``dropout_rng`` node tests bit j of the
    element's ``keep`` word, drawn before the body runs (``draws`` lists
    each draw's seed expression, salt and keep threshold); otherwise it
    draws its own bits (the post-reduce and chained bodies)."""

    def __init__(self, graph: TppGraph, full_row: bool = False, drawn: bool = False):
        self.graph = graph
        self.full_row = full_row
        self.drawn = drawn
        self.draws: list[tuple[str, int, int]] = []
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

    def _drawn_expr(self, nd, args) -> str:
        """A dropout_rng node on its pre-drawn keep bit."""
        at = nd.attr_dict()
        rate = float(at.get("rate", 0.0))
        if rate <= 0.0:
            return args[0]
        j = len(self.draws)
        self.draws.append((args[1], int(at.get("salt", 0)) & 0xFFFFFFFF, rng.keep_threshold(rate)))
        return f"((keep >> {j}) & 1u ? {args[0]} * {_f32_literal(1.0 / (1.0 - rate))} : 0.0f)"

    def nodes(self, nodes):
        if not self.drawn and any(nd.op in HW_PRNG_OPS for nd in nodes):
            # the width of K13's tile: the plan's, or full rows after the
            # reducing node
            self.lines.append(f"    const int prng_tn = {'a.N' if self.full_row else 'a.prng_tn'};")
        for nd in nodes:
            args = [self.value(r) for r in nd.inputs]
            var = f"v_{_ident(nd.name)}"
            attrs = ", ".join(f"{a}={v}" for a, v in nd.attrs)
            expr = (self._drawn_expr(nd, args) if self.drawn and nd.op in HW_PRNG_OPS
                    else _EXPR[nd.op](args, nd.attr_dict()))
            self.lines.append(
                f"    const float {var} = {expr};"
                f"  // {nd.name} = {nd.op}({', '.join(nd.inputs)}" + (f"; {attrs}" if attrs else "") + ")")
            self.env[nd.name] = var

    def outputs(self):
        for q, o in enumerate(self.graph.outputs):
            self.lines.append(f"    out[{q}] = {self.env[o]};")


_ARGS = "int gm, int gn, const FusedArgs& a, const FgCtx& c"
_KEEP_ARGS = "uint32_t keep, " + _ARGS
# Epi in an anonymous namespace: every template instantiated on it (and
# each function-local static there, such as a kernel's shared-memory
# attribute set once) belongs to its own library.  Under one external name
# the generated libraries would share those statics (GNU unique symbols
# ignore RTLD_LOCAL), and the second graph of a tile would skip its
# kernel's attribute and fail at launch.
_ANON = "namespace {"


def _scratch(j: int) -> str:
    return f"a.scratch[c.off(a.s_scratch) + ((long long){j} * a.M + gm) * a.N + gn]"


def _draw_members(draws, shared: bool) -> list[str]:
    """The Epi members that key the plain or pre-reduce body's draws: their
    count, whether the wgmma tile shares one K13 call among four columns,
    and each draw's seed, salt and keep threshold."""
    seeds = _select([d[0] for d in draws], "0u", "j")
    salts = _select([f"{d[1]}u" for d in draws], "0u", "j")
    thresh = _select([f"{d[2]}u" for d in draws], "0u", "j")
    return [
        "  // the dropout_rng draws of the body below, bit j of its keep word",
        f"  static constexpr int NDRAW = {len(draws)};",
        "  // K13 under the wgmma tile: one Philox call for four columns of a row",
        "  // (the plan's PRNG tile width a multiple of 4), shared by a lane pair",
        f"  static constexpr bool DRAW4 = {_bool(shared)};",
        "  __device__ __forceinline__ static void draw_key(int j, const FusedArgs& a, uint32_t& seed,",
        "                                                  uint32_t& salt, uint32_t& thresh) {",
        f"    seed = {seeds};",
        f"    salt = {salts};",
        f"    thresh = {thresh};",
        "  }",
    ]


def _plain_body(graph: TppGraph, shared_draw: bool = False) -> list[str]:
    em = _Emitter(graph, drawn=True)
    em.roots([f"acc[{i}]" for i in range(len(graph.base_roots))])
    em.nodes(graph.nodes)
    em.outputs()
    return [*_draw_members(em.draws, shared_draw),
            f"  __device__ __forceinline__ static void apply(const float* acc, {_KEEP_ARGS}, "
            "float* out) {", *em.lines, "  }"]


def _panel_body(graph: TppGraph, shared_draw: bool = False) -> list[str]:
    red = graph.reducing_node()
    idx = graph.nodes.index(red)
    op = EPILOGUE_OPS[red.op]
    staged = graph.staged_values()
    kind, eps = _RED[red.op]
    eps = float(red.attr_dict().get("eps", eps))
    pre = _Emitter(graph, drawn=True)
    pre.roots([f"acc[{i}]" for i in range(len(graph.base_roots))])
    pre.nodes(graph.nodes[:idx])
    stage = [f"    staged[{j}] = {pre.env[nm]};  // {nm}" for j, nm in enumerate(staged)]
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
        *_draw_members(pre.draws, shared_draw),
        "  // pre-reduce nodes, per N tile: the reducer's computed inputs, which the",
        "  // template stages (fg::stage) in the scratch panel",
        f"  __device__ __forceinline__ static void pre(const float* acc, {_KEEP_ARGS}, "
        "float* staged) {",
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


def _chain_mask(graph: TppGraph):
    """The attrs of the attn_mask node the graph's reducer reads directly
    (what ``key_range``, ``tile_mixed`` and ``tile_dead`` are computed
    from), or None."""
    red = graph.reducing_node()
    z = red.inputs[EPILOGUE_OPS[red.op].stats_input or 0]
    by_name = {nd.name: nd for nd in graph.nodes}
    if z in by_name and by_name[z].op == "attn_mask":
        return by_name[z].attr_dict()
    return None


def _mask_ints(mask):
    return bool(mask.get("causal", True)), int(mask.get("window", 0)), int(mask.get("offset", 0))


def chain_key_range(mask, q0: int, rows: int, sq: int, skv: int, bn: int) -> range:
    """The key tiles of ``bn`` keys that the query rows [q0, q0 + rows)
    below ``sq`` of a chained graph can see, from its attn_mask node's
    attrs ``mask`` (``_chain_mask``; None: every key): the generated
    ``key_range``, which the wgmma mainloop visits; every tile outside
    holds only masked pairs.  Row i sits at key position i + offset."""
    last = min(q0 + rows, sq) - 1
    begin, end = 0, skv
    if mask is not None:
        causal, win, off = _mask_ints(mask)
        if causal:
            end = min(skv, last + off + 1)
        if win > 0:
            begin = max(0, q0 + off - win + 1)
    if last < q0 or end <= begin:
        return range(0)
    return range(begin // bn, -(-end // bn))


def chain_tile_mixed(mask, m0: int, bm: int, n0: int, bn: int) -> bool:
    """Whether the chained graph's attn_mask node (attrs ``mask``, or None)
    drops some pair of the tile of rows [m0, m0 + bm) and keys [n0, n0 +
    bn): the generated ``tile_mixed`` (on a tile ``key_range`` visits, one
    the mask cuts).  Elsewhere the mainloop runs ``pre`` without that
    mask's test."""
    if mask is None:
        return False
    causal, win, off = _mask_ints(mask)
    return bool((causal and n0 + bn - 1 > m0 + off) or (win > 0 and n0 <= m0 + bm - 1 + off - win))


class _ChainPre(NamedTuple):
    lines: list          # C++ lines of the pre-reduce nodes on a score s
    z: str               # the softmax input's variable
    dead: str            # tile_dead's condition
    mixed: str           # tile_mixed's condition
    key_range: list      # key_range's body
    causal: bool


def _chain_pre(graph: TppGraph, guard: bool = False) -> _ChainPre:
    """A chained graph's pre-reduce nodes on a score ``s`` and its mask's
    tile rules.  With ``guard`` the reducer's attn_mask node tests its pairs
    only under the template flag ``MIXED`` (``pre<false>`` runs on tiles
    where the mask keeps every pair)."""
    red = graph.reducing_node()
    idx = graph.nodes.index(red)
    em = _Emitter(graph)
    em.roots(["s"])
    em.nodes(graph.nodes[:idx])
    z = red.inputs[EPILOGUE_OPS[red.op].stats_input or 0]
    mask = _chain_mask(graph)
    dead, mixed, causal = "false", "false", False
    end, begin = "p.Skv", "0"
    if mask is not None:
        # the reducer reads the mask's fills directly: a tile every score
        # of which is masked adds nothing, and is skipped
        causal, win, off = _mask_ints(mask)
        dead_parts, mixed_parts = [], []
        if causal:
            dead_parts.append(f"n0 > m0 + bm - 1 + {off}")
            mixed_parts.append(f"n0 + bn - 1 > m0 + {off}")
            end = f"min(p.Skv, last + {off} + 1)"
        if win > 0:
            dead_parts.append(f"n0 + bn - 1 <= m0 + {off} - {win}")
            mixed_parts.append(f"n0 <= m0 + bm - 1 + {off} - {win}")
            begin = f"max(0, q0 + {off} - {win} + 1)"
        dead = " || ".join(dead_parts) or "false"
        mixed = " || ".join(mixed_parts) or "false"
        if guard:
            keep = _keep(mask)
            head = f"    const float {em.env[z]} = "
            em.lines = [ln.replace(f"({keep} ?", f"((!MIXED || {keep}) ?", 1)
                        if ln.startswith(head) else ln for ln in em.lines]
    key_range = [
        "    const int last = min(q0 + rows, p.Sq) - 1;",
        f"    const int end = {end}, begin = {begin};",
        "    if (last < q0 || end <= begin) {",
        "      lo = hi = 0;",
        "      return;",
        "    }",
        "    lo = begin / bn;",
        "    hi = (end + bn - 1) / bn;",
    ]
    return _ChainPre(em.lines, em.env[z], dead, mixed, key_range, causal)


def _chain_body(graph: TppGraph) -> list[str]:
    c = _chain_pre(graph, guard=True)
    params = "const attn_fwd::Params& p"
    return [
        "  // the pre-reduce nodes on a score s at (gm, gn): the softmax_online input;",
        "  // MIXED false on a tile where the mask keeps every pair (tile_mixed false)",
        "  template <bool MIXED = true>",
        f"  __device__ __forceinline__ static float pre(float s, int gm, int gn, {params}) {{",
        *c.lines, f"    return {c.z};", "  }",
        "  // a score tile (rows m0.., columns n0..) whose every score is masked",
        "  __host__ __device__ static constexpr bool tile_dead(int m0, int bm, int n0, int bn) {",
        f"    return {c.dead};", "  }",
        "  // a score tile where the mask drops some pair (cuts it, if key_range visits it)",
        "  __host__ __device__ static constexpr bool tile_mixed(int m0, int bm, int n0, int bn,",
        "                                                       const attn_fwd::Params&) {",
        f"    return {c.mixed};", "  }",
        "  // the key tiles [lo, hi) of bn keys the query rows [q0, q0 + rows) below Sq can see",
        "  __device__ __forceinline__ static void key_range(int q0, int rows, int bn, int& lo,",
        f"                                                   int& hi, {params}) {{",
        *c.key_range, "  }",
        "  // the fixed grid takes the heaviest query tiles first under a causal mask",
        f"  static constexpr bool CAUSAL = {_bool(c.causal)};",
    ]


def shares_draw(graph: TppGraph, hw_prng: bool, prng_tile) -> bool:
    """Whether a launch takes the source whose wgmma tile draws K13's bits
    once for four columns (``generate_source(..., shared_draw=True)``):
    under ``hw_prng``, for a graph without a chained root that draws, on a
    plan whose PRNG tile width is a multiple of 4 (so the four columns of
    a lane pair are the four words of one Philox call)."""
    return bool(hw_prng and graph.chained_root() is None and prng_tile is not None
                and prng_tile[1] % 4 == 0 and any(nd.op in HW_PRNG_OPS for nd in graph.nodes))


def generate_source(graph: TppGraph, shared_draw: bool = False) -> str:
    """The CUDA source of K5 for ``graph`` (already simplified): the same
    text for the same graph, every run.  The text names no graph, so graphs
    of one structure share it (and its library).  ``shared_draw`` (see
    ``shares_draw``) writes the source whose wgmma tile shares each K13
    call among four columns; the plan chooses it, the kernel never does."""
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
    body = (_chain_body(graph) if chain else _panel_body(graph, shared_draw) if panel
            else _plain_body(graph, shared_draw))
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
        _ANON,
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
        "}  // namespace",
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
    lines, z, dead = _chain_pre(graph)[:3]
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
        _ANON,
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
        "}  // namespace",
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
                ("lse", ctypes.c_void_p), ("chain_plan", ctypes.c_int * 5),
                ("variant", ctypes.c_int), ("cta_m", ctypes.c_int), ("cta_n", ctypes.c_int),
                ("ws", ctypes.c_void_p), ("counters", ctypes.c_void_p),
                ("splits", ctypes.c_int), ("split_steps", ctypes.c_int),
                ("lhs_split", ctypes.c_void_p * MAX_ROOTS),
                ("rhs_split", ctypes.c_void_p * MAX_ROOTS)]


def _chain_wgmma(graph: TppGraph, all_bf16: bool, head_dim: int) -> bool:
    """The rule that runs a chained graph on the wgmma mainloop: every
    contraction operand bf16, the lhs stored (M, K), the rhs stored (N, K)
    and K = N2 = ``head_dim`` one of ``flash_attention.HEAD_DIMS`` (pass 0
    when K and N2 differ)."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    root = graph.base_roots[0]
    return bool(all_bf16 and not graph.operand(root.lhs).trans and graph.operand(root.rhs).trans
                and head_dim in HEAD_DIMS)


def cta_tile(graph: TppGraph, m: int, n: int, variant: str, head_dim: int = 0) -> tuple[int, int]:
    """The (rows, columns) of the output one K5 block computes, as the
    templates' dispatch picks them for ``variant``: a ``gemm_plan`` variant,
    or for a chained root a ``chain_plan`` one (wgmma, simt).  A chained
    root on the wgmma mainloop (``_chain_wgmma``; ``head_dim`` = K = N2, or
    0) takes 64 rows a warpgroup of ``flash_attention.WGMMA_TILES`` (128 at
    D <= 64, 64 at D 128 and 256), on the SIMT kernel 64 rows; a row panel
    64 whole rows (wgmma, wmma) or 128 (simt); else wgmma and wgmma_split
    128x128 for one root and 128x64 for two or three, wgmma_decode 16x128
    (its K splits share one tile), wmma 16x64 for M <= 16 and else as
    wgmma, simt 128x64."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown K5 variant {variant!r}")
    if graph.chained_root() is not None:
        if variant != "simt" and _chain_wgmma(graph, True, head_dim):
            from repro_torch.kernels.flash_attention import WGMMA_TILES
            return 64 * WGMMA_TILES[head_dim][0], n
        return 64, n
    panel = graph.reducing_node() is not None
    roots = len(graph.base_roots)
    if panel:
        return (128 if variant == "simt" else 64), n
    if variant in ("wgmma", "wgmma_split"):
        return 128, (128 if roots == 1 else 64)
    if variant == "wgmma_decode":
        return DECODE_ROWS, DECODE_COLUMNS
    if variant == "wmma":
        return (16, 64) if m <= 16 else (128, 128) if roots == 1 else (128, 64)
    return 128, 64


def wgmma_tile(roots: int, nlhs: int, pieces=(1, 1), panel: bool = False):
    """→ (rows, columns, stages, dynamic shared memory bytes, CTAs an SM) of
    ``csrc/fused_gemm.cuh``'s WTile for ``roots`` roots over ``nlhs``
    distinct lhs operands with ``pieces`` (PA, PB) bf16 pieces of each lhs
    and rhs (2 on wgmma_split's fp32 side); a row panel has one consumer
    warpgroup (64 rows).  A stage holds every piece's 64-deep tile; two
    CTAs an SM where a thread's accumulators (roots x columns / 2) are at
    most 64, there is one piece a side (the split keeps a second set: each
    64-deep step summed apart, then added in fp32) and the ring fits
    twice, else one with up to 4 stages."""
    wg = 1 if panel else 2
    bm, bn = 64 * wg, 128 if roots == 1 else 64
    small = roots * bn <= 128
    stage = (nlhs * pieces[0] * bm + roots * pieces[1] * bn) * _K_STEP * 2
    stages = min(4, max(2, (112 if small else 224) * 1024 // stage))
    smem = 1024 + stages * stage + 16 * stages + 16
    return bm, bn, stages, smem, 2 if small and pieces == (1, 1) and 2 * smem <= 227 * 1024 else 1


def gemm_variant(m: int, lhs_dtypes, rhs_dtypes, aligned: bool = True, panel: bool = False) -> str:
    """Which variant of K5 runs a graph without a chained root, from its
    contraction operands' dtypes, M and layout alone: every operand bf16 →
    ``wmma`` when TMA cannot read one where it lies (``aligned`` false: a
    base, row stride or batch stride not a multiple of 16 bytes, or K 0),
    else ``wgmma_decode`` for m <= ``DECODE_ROWS`` (not a row panel) and
    ``wgmma`` above; every operand fp32 → ``simt``; every lhs fp32 and every
    rhs bf16, or the reverse, outside a row panel with the bf16 side
    TMA-readable and the pieces' ring in shared memory (``wgmma_tile``: not
    three fp32 lhs for three roots) → ``wgmma_split``; any other mix →
    ``simt``.  ``lhs_dtypes`` lists the distinct lhs operands',
    ``rhs_dtypes`` each root's.  K, N and the transpositions choose
    nothing."""
    lhs, rhs = set(lhs_dtypes), set(rhs_dtypes)
    if torch.float32 not in lhs | rhs:
        if not aligned:
            return "wmma"
        return "wgmma_decode" if m <= DECODE_ROWS and not panel else "wgmma"
    if not panel and aligned and len(lhs) == 1 and len(rhs) == 1 and lhs != rhs:
        pieces = (2, 1) if lhs == {torch.float32} else (1, 2)
        if wgmma_tile(len(rhs_dtypes), len(lhs_dtypes), pieces)[3] <= _SMEM_MAX:
            return "wgmma_split"
    return "simt"


def _has_rows(t: torch.Tensor) -> bool:
    return t.stride(-1) == 1 and (t.shape[-2] <= 1 or t.stride(-2) >= max(t.shape[-1], 1))


def _tma_readable(t: torch.Tensor) -> bool:
    """Whether TMA reads the operand ``t`` as the wrapper binds it (``_rows``
    copies one whose rows are not unit-stride into a contiguous tensor): a
    16-byte aligned base, and the stride of every axis but the last that is
    longer than 1 and not shared (stride 0) a multiple of 16 bytes."""
    if _has_rows(t):
        if t.data_ptr() % 16:
            return False
        strides = t.stride()
    else:
        strides, acc = [], 1
        for size in reversed(t.shape):
            strides.insert(0, acc)
            acc *= max(size, 1)
    size = t.element_size()
    return all(n <= 1 or st == 0 or st * size % 16 == 0
               for n, st in zip(t.shape[:-1], strides[:-1]))


def _contraction(graph: TppGraph, operands):
    """→ (lhs tensors, rhs tensors, M, K, N) of a graph's base roots."""
    lhs = [operands[nm] for nm in _lhs_names(graph)]
    rhs = [operands[r.rhs] for r in graph.base_roots]
    t = lhs[0]
    m, k = (t.shape[-1], t.shape[-2]) if graph.operand(_lhs_names(graph)[0]).trans else t.shape[-2:]
    n = max((t.shape[-2] if graph.operand(r.rhs).trans else t.shape[-1])
            for r, t in zip(graph.base_roots, rhs))
    return lhs, rhs, int(m), int(k), int(n)


def variant_of(graph: TppGraph, operands) -> str:
    """The variant ``FusedKernel`` launches for a graph without a chained
    root on ``operands`` (on any device): ``gemm_variant`` of the contraction
    operands' dtypes, M and whether TMA reads the bf16 ones where they lie."""
    if graph.chained_root() is not None:
        raise ValueError(f"graph {graph.name!r} has a chained root: see chain_plan")
    lhs, rhs, m, k, _ = _contraction(graph, operands)
    aligned = k > 0 and all(_tma_readable(t) for t in lhs + rhs if t.dtype == torch.bfloat16)
    return gemm_variant(m, [t.dtype for t in lhs], [t.dtype for t in rhs], aligned,
                        graph.reducing_node() is not None)


class GemmPlan(NamedTuple):
    """How a graph without a chained root runs one call: ``variant`` (one
    of ``VARIANTS``), ``tile`` the (rows, columns) of the output a CTA
    computes (``cta_tile``), ``pieces`` (PA, PB) the bf16 pieces of each lhs
    and rhs (wgmma_split: 2 on the fp32 side), and wgmma_decode's K split:
    ``splits`` parts of ``split_steps`` 64-deep steps (1, 1 otherwise)."""
    variant: str
    tile: tuple
    pieces: tuple
    splits: int
    split_steps: int


def gemm_plan(graph: TppGraph, operands) -> GemmPlan:
    """The plan of a graph without a chained root on ``operands``, from
    their dtypes, shapes, strides and base pointers alone (nothing is
    launched): ``variant_of``; its CTA tile; wgmma_split's pieces; and
    wgmma_decode's split of K, ``brgemm.decode_splits(K, N)`` (never M, so a
    decoded row has the same bits at every M <= 16)."""
    from repro_torch.kernels.brgemm import decode_splits

    variant = variant_of(graph, operands)
    lhs, _, m, k, n = _contraction(graph, operands)
    pieces = (1, 1)
    if variant == "wgmma_split":
        pieces = (2, 1) if lhs[0].dtype == torch.float32 else (1, 2)
    splits, steps = decode_splits(k, n) if variant == "wgmma_decode" else (1, 1)
    return GemmPlan(variant, cta_tile(graph, m, n, variant), pieces, splits, steps)


def split_bf16(x: torch.Tensor, pieces: int = 2) -> list[torch.Tensor]:
    """The bf16 pieces of an fp32 tensor as wgmma_split's pre-pass writes
    them (``csrc/fused_gemm.cuh`` fg_split_bf16, ``pieces`` 2): hi =
    bf16(x), lo = bf16(x - hi), and with ``pieces`` 3 lo2 = bf16(x - hi -
    lo); their fp32 sum is x to about 2^-17 (2^-25) of |x|.  The plain
    model of the split that the CPU tests hold against an fp64 product."""
    out, rest = [], x.float()
    for _ in range(pieces):
        p = rest.to(torch.bfloat16)
        out.append(p)
        rest = rest - p.float()
    return out


class ChainPlan(NamedTuple):
    """How a chained graph's forward runs one call: ``variant`` "wgmma"
    (K2's mainloop, csrc/attention_fwd.cuh) or "simt"; ``rows`` query rows
    a block; ``bn`` keys a tile; ``stages`` tiles in the K/V ring;
    ``smem_bytes`` of dynamic shared memory; ``grid`` of the fixed order
    (query tiles, B1, B0); a schedule's grid has one block an order-table
    entry instead."""
    variant: str
    rows: int
    bn: int
    stages: int
    smem_bytes: int
    grid: tuple

    def ints(self):
        """The 5 ints of FusedArgs::chain_plan."""
        return (int(self.variant == "wgmma"), self.rows, self.bn, self.stages, self.smem_bytes)


def _tma_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` without the leading batch axes it shares (stride 0): the
    tensor map of such an operand has extent 1 there."""
    for ax in reversed(range(t.dim() - 2)):
        if t.stride(ax) == 0:
            t = t.select(ax, 0)
    return t


def chain_plan(graph: TppGraph, operands) -> ChainPlan:
    """The plan of a chained graph's forward on ``operands`` (the graph's
    q, k and v, shaped as ``FusedKernel`` takes them), from their dtypes,
    shapes, strides and base pointers alone (nothing is launched): the
    wgmma variant when every contraction operand is bf16, the lhs is stored
    (M, K), the rhs (N, K) and K = N2 is one of
    ``flash_attention.HEAD_DIMS``; the SIMT variant for every other graph.
    Raises ``FusionLegalityError`` (TPP226) for a chain wider than
    ``MAX_CHAIN`` and ``ValueError`` for a wgmma operand whose base pointer
    or strides (but the unit last one, and those of the batch axes it
    shares) are not multiples of 16 bytes: TMA reads its rows, and there is
    no silent copy."""
    from repro_torch.kernels import flash_attention as fa

    chain = graph.chained_root()
    if chain is None:
        raise ValueError(f"graph {graph.name!r} has no chained root")
    root = graph.base_roots[0]
    names = {"q": root.lhs, "k": root.rhs, "v": chain.rhs}
    ops = {role: operands[nm] for role, nm in names.items()}
    q, v = ops["q"], ops["v"]
    m, k = (q.shape[-1], q.shape[-2]) if graph.operand(root.lhs).trans else q.shape[-2:]
    n, n2 = v.shape[-2:]
    if n2 > MAX_CHAIN:
        raise FusionLegalityError(
            f"graph {graph.name!r}: chain width {n2}; the chained kernel takes at most "
            f"{MAX_CHAIN}", code="TPP226")
    batch = next((tuple(t.shape[:-2]) for t in ops.values() if t.dim() > 2), ())
    b1 = batch[-1] if batch else 1
    b0 = batch[0] if len(batch) == 2 else 1
    all_bf16 = all(t.dtype == torch.bfloat16 for t in ops.values())
    head_dim = int(n2) if k == n2 else 0
    wgmma = _chain_wgmma(graph, all_bf16, head_dim)
    rows = cta_tile(graph, m, n, "wgmma" if wgmma else "simt", head_dim)[0]
    if not wgmma:
        return ChainPlan("simt", rows, 64, 1, 0, (-(-m // rows), 1, b0 * b1))
    for role, t in ops.items():
        if _rows(t) is t:       # a copy (K-major rows, 16-byte aligned) is always readable
            fa.tma_readable(role, _tma_view(t))
    _, bn, stages = fa.WGMMA_TILES[head_dim]
    return ChainPlan("wgmma", rows, bn, stages, fa.wgmma_smem(head_dim, rows, bn, stages),
                     (-(-m // rows), b1, b0))


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
    return t if _has_rows(t) else t.contiguous()


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
        self._libs: dict[bool, ctypes.CDLL] = {}
        # a chained graph's plans by what decides them: each of q, k and v's
        # shape, strides, dtype and base pointer modulo 16 bytes
        # a graph without one: gemm_plan's, by the same of every lhs and rhs
        self._plans: dict = {}
        self._planned = ((self.roots[0].lhs, self.roots[0].rhs, self.chain.rhs)
                         if self.chain is not None else
                         self.lhs + tuple(r.rhs for r in self.roots))

    def planned(self, operands):
        """``chain_plan`` (a chained graph) or ``gemm_plan`` on ``operands``,
        kept for the next call whose contraction operands agree in what
        decides it."""
        ts = [operands[nm] for nm in self._planned]
        key = tuple((t.shape, t.stride(), t.dtype, t.data_ptr() % 16) for t in ts)
        found = self._plans.get(key)
        if found is None:
            make = chain_plan if self.chain is not None else gemm_plan
            found = self._plans[key] = make(self.graph, operands)
        return found

    def library(self, shared_draw: bool = False):
        """The built and loaded library (of the source that shares K13's
        draws, ``shares_draw``, with ``shared_draw``), held after the first
        call so a launch reads no file and hashes no source."""
        lib = self._libs.get(shared_draw)
        if lib is None:
            src = generate_source(self.graph, shared_draw=True) if shared_draw else self.source
            lib = self._libs[shared_draw] = _build.load_generated(source_name(self.graph, src), src)
        return lib

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

    def __call__(self, operands, *, out_dtype=None, plan=None, hw_prng=False, with_lse=False,
                 variant=None):
        """Launch on ``operands``; ``plan`` (a ``fusion.lowering.GraphPlan``
        at these shapes) orders the CTA tiles by its visit order and sets
        K13's tile, which ``hw_prng`` draws ``dropout_rng`` from.  With
        ``with_lse`` (a chained graph) → (out, lse): lse (*batch, M) fp32,
        each row's log-sum-exp of its live softmax inputs (-inf for a row
        with none), the chained backward's row statistics.  ``variant``
        (a graph without a chained root) is ``gemm_plan``'s unless given, to
        time one variant beside another on the same operands: ``wmma``
        beside a bf16 wgmma variant, ``simt`` beside ``wgmma_split``."""
        global LAUNCHES, HW_PRNG_LAUNCHES, CHAIN_WGMMA_LAUNCHES
        g = self.graph
        if hw_prng and plan is None:
            raise ValueError(f"graph {g.name!r}: hw_prng needs a plan (its tiles key K13)")
        if with_lse and self.chain is None:
            raise ValueError(f"graph {g.name!r}: only a chained root writes row statistics")
        m, k, n, widths, n2, batch, odt = self._check(operands, out_dtype)
        planned = self.planned(operands)
        cplan, gplan = (planned, None) if self.chain is not None else (None, planned)
        if variant is not None and gplan is not None and variant != gplan.variant:
            allowed = {"wgmma": "wmma", "wgmma_decode": "wmma", "wgmma_split": "simt"}
            if allowed.get(gplan.variant) != variant:
                raise ValueError(f"graph {g.name!r}: K5 variant {variant!r} does not take these "
                                 f"operands (planned {gplan.variant!r})")
            gplan = GemmPlan(variant, cta_tile(g, m, n, variant), (1, 1), 1, 1)
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
        stream = torch.cuda.current_stream(dev).cuda_stream
        if cplan is not None:
            args.chain_plan[:] = cplan.ints()
        else:
            self._bind_plan(args, gplan, operands, keep, nprob, m, n, dev, stream)
        if plan is not None:
            cta = (cplan.rows, n) if cplan is not None else gplan.tile
            order = _device_table((plan, m, n, cta), lambda: order_table(plan, m, n, cta), dev)
            args.order, args.n_order = order.data_ptr(), order.shape[0]
        lib = self.library(shares_draw(g, bool(args.hw), plan.prng_tile if plan is not None else None))
        err = lib.fused_gemm(ctypes.byref(args), stream)
        _build.check(err, f"fused_gemm {g.name}")
        LAUNCHES += 1
        GRAPH_LAUNCHES[g.name] = GRAPH_LAUNCHES.get(g.name, 0) + 1
        if args.hw:
            HW_PRNG_LAUNCHES += 1
        if cplan is not None and cplan.variant == "wgmma":
            CHAIN_WGMMA_LAUNCHES += 1
        if gplan is not None:
            globals()[VARIANT_COUNTERS[gplan.variant]] += 1
        return (out, lse) if with_lse else out

    def _bind_plan(self, args, gplan: GemmPlan, operands, keep, nprob, m, n, dev, stream):
        """Set a graph's ``gemm_plan`` in ``args``: the variant and its tile;
        for wgmma_decode the K split, the fp32 partials and the panels'
        counters (``brgemm``'s per-stream ones, which each launch leaves at
        zero); for wgmma_split a (2, B0 or 1, B1 or 1, rows, cols) bf16
        buffer for the pieces of each fp32 operand."""
        from repro_torch.kernels.brgemm import _decode_counters

        args.variant = VARIANTS[gplan.variant]
        args.cta_m, args.cta_n = gplan.tile
        if gplan.variant == "wgmma_decode":
            args.splits, args.split_steps = gplan.splits, gplan.split_steps
            if gplan.splits > 1:
                ws = torch.empty((nprob, gplan.splits, len(self.roots), m, n),
                                 dtype=torch.float32, device=dev)
                keep.append(ws)
                args.ws = ws.data_ptr()
                panels = -(-n // DECODE_COLUMNS)
                args.counters = _decode_counters(dev, stream, nprob * panels).data_ptr()
        elif gplan.variant == "wgmma_split":
            b1 = args.B1
            b0 = nprob // b1

            def pieces(name, strides):
                rows, cols = operands[name].shape[-2:]   # as stored
                t = torch.empty((2, b0 if strides[0] else 1, b1 if strides[1] else 1, rows, cols),
                                dtype=torch.bfloat16, device=dev)
                keep.append(t)
                return t.data_ptr()

            for i, nm in enumerate(self.lhs):
                if not args.lhs_bf16[i]:
                    args.lhs_split[i] = pieces(nm, args.s_lhs[i])
            for i, r in enumerate(self.roots):
                if not args.rhs_bf16[i]:
                    args.rhs_split[i] = pieces(r.rhs, args.s_rhs[i])


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
        global LAUNCHES, CHAIN_BWD_WGMMA_LAUNCHES
        from repro_torch.kernels import flash_attention as fa

        dt = q.dtype if k.dtype == v.dtype == q.dtype else torch.float32
        q4, k4, v4, o4, do4 = (_four(t.to(dt)) for t in (q, k, v, o, do))
        lse4 = _four(lse[..., None])[..., 0]
        d = q4.shape[-1]
        (dq, dk, dv), variant = fa.attention_backward(lambda: self.library(d), self.name, q4, k4,
                                                      v4, o4, lse4, do4)
        LAUNCHES += 1
        GRAPH_LAUNCHES[self.name] = GRAPH_LAUNCHES.get(self.name, 0) + 1
        if variant == "wgmma":
            CHAIN_BWD_WGMMA_LAUNCHES += 1
        return tuple(g.reshape(t.shape) for g, t in zip((dq, dk, dv), (q, k, v)))


def _four(t: torch.Tensor) -> torch.Tensor:
    """A (*batch, S, D) operand with up to two batch axes as (B, H, S, D)."""
    while t.dim() < 4:
        t = t.unsqueeze(0)
    return t
