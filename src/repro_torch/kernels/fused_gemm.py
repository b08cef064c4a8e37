"""K5: the fused-TppGraph kernel, a CUDA C++ code generator and its wrapper.

Replaces ``repro/fusion/lowering.py:330 _compile_pallas`` (→
``core/pallas_lowering.py make_pallas_fn``) for graphs whose contraction
roots are base roots and whose epilogue nodes are pointwise.  For each
distinct simplified graph, ``generate_source`` emits one CUDA source: a
header naming what it replaces, a struct ``Epi`` holding the graph's root
count, its lhs map and its epilogue DAG as straight-line fp32 C++ (one
expression per node, in topological order), and the C entry point, all
around the fixed mainloop of ``csrc/fused_gemm.cuh`` (whose header says
what bounds the kernel on an H100 and what the design does about it).  The
source is built by ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` (``_build.load_generated``) and launched through one
fixed C signature.

What the generator does not take raises ``FusionLegalityError`` with a
stable code; the composed reference path (``fusion.lowering``) takes all of
these, and the fusion compiler's training slice brings them to the card:

  ========  ==========================================================
  TPP207    a contraction operand read as an epilogue value (the
            reference's code)
  TPP220    a reducing node: layernorm, rmsnorm, softmax and their
            gradients (the row panel)
  TPP221    a chained contraction root (flash attention as IR)
  TPP222    a transposed (``trans=True``) contraction operand
  TPP223    an op keyed on element coordinates: ``dropout_rng``,
            ``attn_mask`` and their gradients
  TPP224    more than 3 roots or 8 epilogue operands
  TPP225    an op without a CUDA expression (registered after this
            generator was written)
  ========  ==========================================================
"""
from __future__ import annotations

import ctypes
import hashlib
import struct

import torch

from repro_torch.fusion.graph import EPILOGUE_OPS, FusionLegalityError, TppGraph
from repro_torch.kernels import _build

__all__ = ["FusedKernel", "generate_source", "source_name", "check_supported",
           "LAUNCHES", "GRAPH_LAUNCHES", "MAX_ROOTS", "MAX_EPILOGUE_OPERANDS"]

# Launches of a generated kernel since import (or since a caller reset them),
# in all and by graph name.
LAUNCHES = 0
GRAPH_LAUNCHES: dict[str, int] = {}

MAX_ROOTS = 3
MAX_EPILOGUE_OPERANDS = 8
_DTYPES = (torch.float32, torch.bfloat16)
_EP_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.bool: 2}
_NEXT = ("the fusion compiler's training slice (ROADMAP.md, Queue 1 item 8); "
         "the composed reference path takes it on the CPU")


def _f32_literal(x: float) -> str:
    """``x`` rounded to fp32, as an exact C++ hex float literal."""
    v = struct.unpack("f", struct.pack("f", float(x)))[0]
    return f"{v.hex()}f"


def _dropout_expr(v, mask, attrs):
    rate = float(attrs.get("rate", 0.0))
    if rate <= 0.0:
        return v
    return f"({mask} ? {v} * {_f32_literal(1.0 / (1.0 - rate))} : 0.0f)"


# One C++ expression per pointwise op: value inputs first, then the
# operands, as strings; the node's attrs last.
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
    "relu_grad": lambda v, at: f"({v[1]} > 0.0f ? {v[0]} : {v[0]} * 0.0f)",
    "gelu_grad": lambda v, at: f"fg_gelu_grad({v[0]}, {v[1]})",
    "silu_grad": lambda v, at: f"fg_silu_grad({v[0]}, {v[1]})",
    "sigmoid_grad": lambda v, at: f"fg_sigmoid_grad({v[0]}, {v[1]})",
}


def _refuse(graph, what, code):
    raise FusionLegalityError(
        f"graph {graph.name!r}: {what} — the CUDA generator of K5 does not take "
        f"it yet; it comes with {_NEXT}", code=code)


def check_supported(graph: TppGraph) -> None:
    """Raise ``FusionLegalityError`` (codes in the module docstring) for a
    graph the generator does not take."""
    con = {o.name for o in graph.operands if o.kind in ("lhs", "rhs")}
    bad = sorted({r for nd in graph.nodes for r in nd.inputs if r in con})
    if bad:
        raise FusionLegalityError(
            f"graph {graph.name!r}: contraction operand(s) {bad} are referenced "
            "as epilogue values — the fused kernel only sees their K-indexed "
            "tiles; use the reference path for this graph", code="TPP207")
    if graph.chained_root() is not None:
        _refuse(graph, f"chained root {graph.chained_root().name!r}", "TPP221")
    trans = [o.name for o in graph.contraction_operands if o.trans]
    if trans:
        _refuse(graph, f"transposed contraction operand(s) {trans}", "TPP222")
    for nd in graph.nodes:
        op = EPILOGUE_OPS[nd.op]
        if op.reduces is not None:
            _refuse(graph, f"reducing node {nd.name!r} ({nd.op}, a row panel)", "TPP220")
        if op.wants_offsets:
            _refuse(graph, f"coordinate-keyed node {nd.name!r} ({nd.op})", "TPP223")
        if nd.op not in _EXPR:
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


def _epilogue_body(graph: TppGraph) -> list[str]:
    """The straight-line C++ of the epilogue DAG: one ``const float`` per
    root and node, operands read where a node takes them."""
    roots = graph.base_roots
    ep_index = {o.name: i for i, o in enumerate(graph.epilogue_operands)}
    env: dict[str, str] = {}
    lines = []
    for i, r in enumerate(roots):
        env[r.name] = f"r_{_ident(r.name)}"
        lines.append(f"    const float {env[r.name]} = acc[{i}];  // root {r.name} = "
                     f"{r.lhs} @ {r.rhs}")
    if len(roots) == 1:
        env["acc"] = env[roots[0].name]

    def operand(ref: str) -> str:
        spec = graph.operand(ref)
        i = ep_index[ref]
        if spec.kind == "rowvec":
            return f"fg_load(a.ep[{i}], a.ep_dtype[{i}], gn)"
        at = f"(long long)gm * a.ld_ep[{i}] + gn"
        if spec.kind == "mask":
            return f"fg_mask(a.ep[{i}], {at})"
        return f"fg_load(a.ep[{i}], a.ep_dtype[{i}], {at})"

    for k, nd in enumerate(graph.nodes):
        args = [env[r] if r in env else operand(r) for r in nd.inputs]
        var = f"v{k}_{_ident(nd.name)}"
        attrs = ", ".join(f"{a}={v}" for a, v in nd.attrs)
        lines.append(f"    const float {var} = {_EXPR[nd.op](args, nd.attr_dict())};"
                     f"  // {nd.name} = {nd.op}({', '.join(nd.inputs)}"
                     + (f"; {attrs}" if attrs else "") + ")")
        env[nd.name] = var
    for q, o in enumerate(graph.outputs):
        lines.append(f"    out[{q}] = {env[o]};")
    return lines


def generate_source(graph: TppGraph) -> str:
    """The CUDA source of K5 for ``graph`` (already simplified): the same
    text for the same graph, every run."""
    check_supported(graph)
    roots = graph.base_roots
    lhs = _lhs_names(graph)
    lhs_of = [lhs.index(r.lhs) for r in roots]
    sel = " : ".join(f"r == {i} ? {l}" for i, l in enumerate(lhs_of[:-1]))
    lhs_expr = f"{sel} : {lhs_of[-1]}" if sel else f"{lhs_of[-1]}"
    described = "\n".join(f"//   {line}" for line in graph.describe().splitlines())
    return "\n".join([
        f"// K5, generated by repro_torch/kernels/fused_gemm.py for TppGraph {graph.name!r}:",
        described,
        "//",
        "// Replaces the TPU kernel repro/fusion/lowering.py:330 `_compile_pallas` for this",
        "// graph.  Bound on an H100: tensor-core operations at prefill (M in the",
        "// thousands), HBM bytes of the root weights at decode (M <= 16).  The design",
        "// (K1's mainloop with one fp32 accumulator per root, the lhs tile shared by",
        "// every root, the epilogue below run on the accumulators) is described in",
        "// csrc/fused_gemm.cuh.",
        '#include "fused_gemm.cuh"',
        "",
        "struct Epi {",
        f"  static constexpr int R = {len(roots)};",
        f"  static constexpr int NLHS = {len(lhs)};",
        f"  static constexpr int NOUT = {len(graph.outputs)};",
        "  // which distinct lhs operand (" + ", ".join(lhs) + ") each root reads",
        f"  __host__ __device__ static constexpr int lhs_of(int r) {{ return {lhs_expr}; }}",
        "  __device__ __forceinline__ static void apply(const float* acc, int gm, int gn,",
        "                                               const FusedArgs& a, float* out) {",
        *_epilogue_body(graph),
        "  }",
        "};",
        "",
        'extern "C" int fused_gemm(const FusedArgs* args, int M, int N, int K, int R, int w0,',
        "                          int w1, int w2, int in_bf16, int out_bf16, int vec,",
        "                          void* stream) {",
        "  return fg::entry<Epi>(args, M, N, K, R, w0, w1, w2, in_bf16, out_bf16, vec, stream);",
        "}",
        "",
    ])


def source_name(graph: TppGraph, source: str) -> str:
    """The build name of a graph's source: its graph name and a hash of the
    text, so two graphs of one name never share a library."""
    digest = hashlib.sha256(source.encode()).hexdigest()[:8]
    return f"fused_gemm_{_ident(graph.name)}_{digest}"


class _Args(ctypes.Structure):
    """The C struct ``FusedArgs`` of ``csrc/fused_gemm.cuh``."""
    _fields_ = [("lhs", ctypes.c_void_p * MAX_ROOTS),
                ("rhs", ctypes.c_void_p * MAX_ROOTS),
                ("ep", ctypes.c_void_p * MAX_EPILOGUE_OPERANDS),
                ("out", ctypes.c_void_p),
                ("lda", ctypes.c_longlong * MAX_ROOTS),
                ("ldb", ctypes.c_longlong * MAX_ROOTS),
                ("ld_ep", ctypes.c_longlong * MAX_EPILOGUE_OPERANDS),
                ("ep_dtype", ctypes.c_int * MAX_EPILOGUE_OPERANDS)]


def _rows(t: torch.Tensor) -> torch.Tensor:
    """A 2-D operand whose rows have unit stride (a contiguous copy of
    anything else)."""
    if t.stride(-1) == 1 and (t.shape[0] <= 1 or t.stride(0) >= max(t.shape[1], 1)):
        return t
    return t.contiguous()


class FusedKernel:
    """K5 for one simplified graph: ``kernel(operands, out_dtype=None)`` on
    CUDA tensors returns what the composed reference returns (``(M, N)``,
    or ``(NOUT, M, N)`` stacked and zero-padded past narrow roots).  The
    source is generated here (raising for a graph the generator does not
    take); it is built and loaded at the first launch."""

    def __init__(self, graph: TppGraph):
        self.graph = graph
        self.source = generate_source(graph)
        self.name = source_name(graph, self.source)
        self.roots = graph.base_roots
        self.lhs = _lhs_names(graph)
        self.contraction = graph.contraction_operands
        self.epilogue = graph.epilogue_operands
        consumed = {graph.resolve_acc(ref) for nd in graph.nodes for ref in nd.inputs}
        self.output_only = {r.name for r in self.roots if r.name not in consumed}
        self._lib = None

    def library(self):
        """The built and loaded library, held after the first call so a
        launch reads no file and hashes no source."""
        if self._lib is None:
            self._lib = _build.load_generated(self.name, self.source)
        return self._lib

    def _shapes(self, operands):
        """→ (M, K, N, per-root widths); raises as the reference's Pallas
        path does on shapes the graph cannot take."""
        g = self.graph
        m, k = operands[self.lhs[0]].shape
        for nm in self.lhs:
            if tuple(operands[nm].shape) != (m, k):
                raise FusionLegalityError(
                    f"graph {g.name!r}: lhs operand {nm!r} has shape "
                    f"{tuple(operands[nm].shape)}, expected {(m, k)} — multi-root "
                    "graphs share one (M, K, N) problem shape")
        widths = []
        for r in self.roots:
            w = operands[r.rhs]
            if w.dim() != 2 or w.shape[0] != k:
                raise FusionLegalityError(
                    f"graph {g.name!r}: rhs operand {r.rhs!r} has shape "
                    f"{tuple(w.shape)}, expected K = {k} on its contraction dim — "
                    "all roots share the (M, K) problem")
            widths.append(int(w.shape[1]))
        n = max(widths)
        narrow = sorted(r.name for r, w in zip(self.roots, widths)
                        if w < n and r.name not in self.output_only)
        if narrow:
            raise FusionLegalityError(
                f"graph {g.name!r}: rhs widths differ ({widths}) but root(s) "
                f"{narrow} feed epilogue nodes — per-root N widths apply only to "
                "output-only roots (stacked, zero-padded)")
        return m, k, n, widths

    def _check(self, operands, out_dtype):
        g = self.graph
        m, k, n, widths = self._shapes(operands)
        tensors = [operands[s.name] for s in self.contraction]
        dtype = tensors[0].dtype
        if dtype not in _DTYPES or any(t.dtype != dtype for t in tensors):
            raise ValueError(f"graph {g.name!r}: lhs/rhs dtypes "
                             f"{sorted({str(t.dtype) for t in tensors})}: need one of {_DTYPES}")
        odt = out_dtype or dtype
        if odt not in _DTYPES:
            raise ValueError(f"graph {g.name!r}: out_dtype {odt}: need one of {_DTYPES}")
        for spec in self.epilogue:
            v = operands[spec.name]
            want = (n,) if spec.kind == "rowvec" else (m, n)
            if tuple(v.shape) != want:
                raise ValueError(f"graph {g.name!r}: {spec.kind} operand {spec.name!r} "
                                 f"has shape {tuple(v.shape)}, want {want}")
            ok = (torch.bool,) if spec.kind == "mask" else _DTYPES
            if v.dtype not in ok:
                raise ValueError(f"graph {g.name!r}: operand {spec.name!r} dtype "
                                 f"{v.dtype}: need one of {ok}")
        for v in list(operands.values()):
            if isinstance(v, torch.Tensor) and v.device.type != "cuda":
                raise ValueError(f"graph {g.name!r}: K5 needs CUDA tensors, got {v.device}")
        return m, k, n, widths, dtype, odt

    def __call__(self, operands, *, out_dtype=None):
        global LAUNCHES
        g = self.graph
        m, k, n, widths, dtype, odt = self._check(operands, out_dtype)
        nout = len(g.outputs)
        out = torch.empty((nout, m, n) if nout > 1 else (m, n), dtype=odt,
                          device=operands[self.lhs[0]].device)
        if out.numel() == 0:
            return out
        args = _Args()
        keep = []       # the tensors whose pointers the struct holds
        vec = dtype == torch.bfloat16
        for i, nm in enumerate(self.lhs):
            t = _rows(operands[nm])
            keep.append(t)
            args.lhs[i], args.lda[i] = t.data_ptr(), max(t.stride(0), 1)
            vec = vec and args.lda[i] % 8 == 0 and t.data_ptr() % 16 == 0
        for i, r in enumerate(self.roots):
            t = _rows(operands[r.rhs])
            keep.append(t)
            args.rhs[i], args.ldb[i] = t.data_ptr(), max(t.stride(0), 1)
            vec = vec and args.ldb[i] % 8 == 0 and t.data_ptr() % 16 == 0
        for i, spec in enumerate(self.epilogue):
            t = operands[spec.name]
            if spec.kind == "rowvec":
                t = t.contiguous()
                ld = 0
            else:
                t = _rows(t)
                ld = max(t.stride(0), 1)
            if spec.kind == "mask":
                t = t.view(torch.uint8)
            keep.append(t)
            args.ep[i], args.ld_ep[i] = t.data_ptr(), ld
            args.ep_dtype[i] = _EP_DTYPE[operands[spec.name].dtype]
        args.out = out.data_ptr()
        w = widths + [0] * (MAX_ROOTS - len(widths))
        lib = self.library()
        err = lib.fused_gemm(ctypes.byref(args), m, n, k, len(widths), *w,
                             int(dtype == torch.bfloat16), int(odt == torch.bfloat16), int(vec),
                             torch.cuda.current_stream(out.device).cuda_stream)
        _build.check(err, f"fused_gemm {g.name}")
        LAUNCHES += 1
        GRAPH_LAUNCHES[g.name] = GRAPH_LAUNCHES.get(g.name, 0) + 1
        return out
