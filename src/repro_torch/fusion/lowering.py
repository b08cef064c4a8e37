"""Lower a ``TppGraph`` two ways, ported from ``repro/fusion/lowering.py``:

  * ``path="reference"``: the composed reference, the counterpart of the
    reference's ``path="xla"``: each root an fp32-accumulated product, the
    epilogue DAG run with the registered ``apply`` functions on full
    arrays.  It is the plain version of K5: the CPU path of every graph, and
    what ``chip_smoke.py`` holds the kernel against on the card.
  * ``path="cuda"``: K5, one generated CUDA C++ kernel per simplified graph
    (``kernels.fused_gemm``): base roots with a pointwise epilogue, a row
    panel (softmax, the norms and their gradients), a chained root (flash
    attention as IR), transposed and mixed-dtype operands and the
    coordinate-keyed ops.  What the generator does not take raises
    ``FusionLegalityError`` when the graph is compiled; a CPU tensor raises
    when the kernel is called.

Operands may carry leading batch axes (the reference's ``vmap`` over a 2-D
graph, written out): every batched operand shares them, 2-D operands are
shared by every problem, and the output gets them in front.

``compile`` first runs ``simplify_graph`` and the salt guard; operands the
simplification removed are still accepted at call time and ignored.
``compile_for_device`` memoizes one callable per graph and output dtype
that sends CPU tensors to the reference path and CUDA tensors to the
kernel, as ``kernels/ops.py`` does: there is no backend switch, and a graph
that fails on the card raises, it is never rerouted to the reference path
(the reference's ``_guarded_pallas`` fallback and blocklist are
deliberately not ported).  A ``scalar`` operand (the PRNG seed) may be a
Python int or a CPU tensor whatever the device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.fusion import rng
from repro_torch.fusion.graph import EPILOGUE_OPS, TppGraph, simplify_graph
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = ["compile", "compile_for_device", "contraction_operand_values", "PATHS"]

PATHS = ("reference", "cuda")


def contraction_operand_values(graph: TppGraph) -> frozenset[str]:
    """Contraction (lhs/rhs) operands referenced as epilogue values: the
    reference path takes them (full arrays), K5 does not (TPP207)."""
    con = {o.name for o in graph.operands if o.kind in ("lhs", "rhs")}
    return frozenset(r for nd in graph.nodes for r in nd.inputs if r in con)


def _pack_operands(graph: TppGraph, operands: dict, ignore=frozenset()):
    """Operands in canonical order ([*contraction operands, *epilogue
    operands]), rowvecs (n,) as (1, n) and scalars as (1, 1); names in
    ``ignore`` (operands simplification removed) are accepted and dropped."""
    packed = []
    for spec in graph.contraction_operands + graph.epilogue_operands:
        if spec.name not in operands:
            raise TypeError(
                f"graph {graph.name!r}: missing operand {spec.name!r}; "
                f"expected {graph.operand_names}")
        v = operands[spec.name]
        if spec.kind == "rowvec":
            v = v.reshape(1, -1)
        elif spec.kind == "scalar":
            v = torch.as_tensor(v).reshape(1, 1)
        packed.append(v)
    extra = set(operands) - set(graph.operand_names) - set(ignore)
    if extra:
        raise TypeError(f"graph {graph.name!r}: unexpected operands {sorted(extra)}")
    return packed


# ---------------------------------------------------------------------------
# Path 1: the composed reference (K5's plain version)
# ---------------------------------------------------------------------------

def _compile_reference(graph: TppGraph, *, out_dtype=None, ignore=frozenset()):
    def fn(**operands):
        _pack_operands(graph, operands, ignore)  # validates the operand set
        base = graph.base_roots
        x = operands[base[0].lhs]
        env = {}
        for root in base:
            a, b = operands[root.lhs], operands[root.rhs]
            if graph.operand(root.lhs).trans:
                a = a.transpose(-1, -2)
            if graph.operand(root.rhs).trans:
                b = b.transpose(-1, -2)
            # bf16 products are exact in fp32: the reference's
            # tpp.gemm(..., out_dtype=float32)
            env[root.name] = torch.matmul(a.float(), b.float())
        if len(graph.roots) == 1:
            env["acc"] = env[graph.roots[0].name]

        def value(ref):
            if ref in env:
                return env[ref]
            spec = graph.operand(ref)
            v = operands[ref]
            return v if spec.kind in ("mask", "scalar") else v.float()

        for nd in graph.nodes:
            op = EPILOGUE_OPS[nd.op]
            # offset-keyed ops see the whole (M, N) array: offsets (0, 0)
            env[nd.name] = op.apply(*(value(r) for r in nd.inputs), **nd.attr_dict())
        # a chained root consumes the reduced panel, after the DAG
        for root in graph.roots:
            if root.chained:
                env[root.name] = torch.matmul(env[root.lhs], operands[root.rhs].float())
        odt = out_dtype or x.dtype
        if len(graph.outputs) > 1:
            outs = [env[o] for o in graph.outputs]
            # narrow roots (GQA k/v) zero-pad to the stack's width
            wmax = max(o.shape[-1] for o in outs)
            outs = [o if o.shape[-1] == wmax else F.pad(o, (0, wmax - o.shape[-1]))
                    for o in outs]
            return torch.stack(outs, dim=-3).to(odt)
        return env[graph.outputs[0]].to(odt)

    return fn


# ---------------------------------------------------------------------------
# Path 2: K5, one generated CUDA kernel
# ---------------------------------------------------------------------------

def _compile_cuda(graph: TppGraph, *, out_dtype=None, ignore=frozenset()):
    from repro_torch.kernels import fused_gemm
    kernel = fused_gemm.FusedKernel(graph)     # raises on what it cannot take
    seen: set = set()

    def fn(**operands):
        packed = _pack_operands(graph, operands, ignore)
        key = tuple((tuple(v.shape), v.dtype) for v in packed)
        if key in seen:
            return kernel(operands, out_dtype=out_dtype)
        # a new operand shape: where the reference plans a new lowering;
        # here the first launch, which builds and loads the graph's kernel
        # on its first use
        obs_metrics.default_registry().counter("fusion.lowerings").inc()
        with obs_trace.get_tracer().span("fusion.lower", cat="fusion", graph=graph.name):
            out = kernel(operands, out_dtype=out_dtype)
        seen.add(key)
        return out

    return fn


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def compile(graph: TppGraph, *, path: str = "cuda", simplify: bool = True,
            out_dtype=None):
    """Lower ``graph`` to ``fn(**operands) -> (M, N)`` (``(R, M, N)`` for R
    outputs).  The graph is first simplified (identity and rate-0 dropout
    nodes and dead operands go; dropped operands stay accepted) and its
    PRNG salts checked (TPP203).  ``path="cuda"`` generates K5's CUDA source
    now and raises ``FusionLegalityError`` for a graph it does not take;
    ``path="reference"`` is the composed reference."""
    lowered = simplify_graph(graph) if simplify else graph
    rng.assert_unique_salts(lowered)
    ignore = frozenset(graph.operand_names) - frozenset(lowered.operand_names)
    if path == "reference":
        return _compile_reference(lowered, out_dtype=out_dtype, ignore=ignore)
    if path == "cuda":
        return _compile_cuda(lowered, out_dtype=out_dtype, ignore=ignore)
    raise ValueError(f"unknown lowering path {path!r}; use one of {PATHS}")


_COMPILE_CACHE: dict = {}


def compile_for_device(graph: TppGraph, *, out_dtype=None):
    """The memoized callable the library helpers and the derived backward
    graphs use: CPU operands run the composed reference, CUDA operands K5's
    generated kernel (compiled at the graph's first CUDA call, which raises
    for a graph the generator does not take); the output is ``out_dtype``,
    by default the first lhs operand's dtype.  Memoized per graph and
    ``out_dtype``; counts ``fusion.compile_cache.hits``/``.misses`` in the
    default registry."""
    reg = obs_metrics.default_registry()
    key = (graph, out_dtype)
    hit = _COMPILE_CACHE.get(key)
    if hit is not None:
        reg.counter("fusion.compile_cache.hits").inc()
        return hit
    reg.counter("fusion.compile_cache.misses").inc()
    with obs_trace.get_tracer().span("fusion.compile", cat="fusion", graph=graph.name):
        reference = compile(graph, path="reference", out_dtype=out_dtype)
    scalars = {o.name for o in graph.operands if o.kind == "scalar"}
    cuda = []

    def fn(**operands):
        kinds = {v.device.type for nm, v in operands.items()
                 if isinstance(v, torch.Tensor) and nm not in scalars}
        if kinds == {"cpu"}:
            return reference(**operands)
        if kinds != {"cuda"}:
            raise ValueError(f"graph {graph.name!r}: operands on {sorted(kinds)}; "
                             "need all on cpu or all on cuda")
        if not cuda:
            cuda.append(compile(graph, path="cuda", out_dtype=out_dtype))
        return cuda[0](**operands)

    _COMPILE_CACHE[key] = fn
    return fn
