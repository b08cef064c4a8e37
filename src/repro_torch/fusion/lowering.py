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

**Schedules** (the planning half of the reference's ``_compile_pallas``):
``spec_string``, ``tiles`` (bm, bk, bn) and ``block_steps`` plan a graph as
the reference's PARLOOPER nest over (K, M, N) blocks (``plan_graph``:
``build_nest_inputs`` → ``ThreadedLoop`` → ``validate_reduction_innermost``
→ ``validate_epilogue_band`` → ``check_prng_mesh``, then the port's mesh
refusal and ``plan_cuda``), from the operands' shapes at each call, on the
CPU as on the card, so an illegal schedule raises the reference's code on
either device.  On the card the plan's output visit order becomes K5's
table of CTA tiles (or of row blocks for a row panel or a chained root):
the spec sets the order the tiles are rasterised in, and every legal spec
gives the same bits.  ``hw_prng=True`` draws the ``dropout_rng`` bits from
K13, Philox4x32-10 per plan tile (``rng.hw_tile_bits``): a pre-reduce node
keys on the (acc_m, acc_n) tile at (ib·bm, jc·bn), a post-reduce node on
the full-row (acc_m, n) tile at (ib·bm, 0), as the reference's
``node_kwargs`` gives them.  Unlike the reference, whose interpret mode and
XLA path ignore ``hw_prng``, the CPU path draws the same Philox bits per
tile (``plain_version``), so CPU and card agree bit for bit.  With no
schedule keyword nothing is planned and K5 launches its fixed grid.
``vmem_limit_bytes`` (a TPU knob) is not ported; a mesh level raises.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.analysis import footprint
from repro_torch.core.autotune import _freeze
from repro_torch.core.cuda_lowering import (CudaPlan, TensorMap, plan_cuda,
                                            validate_reduction_innermost)
from repro_torch.core.executor import require_no_mesh
from repro_torch.core.loops import LoopSpec, ThreadedLoop
from repro_torch.fusion import rng
from repro_torch.fusion.graph import (EPILOGUE_OPS, FusionLegalityError, TppGraph,
                                      simplify_graph)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = ["compile", "compile_for_device", "plain_version", "contraction_operand_values",
           "validate_epilogue_band", "build_nest_inputs", "plan_graph", "GraphPlan",
           "DEFAULT_SPEC", "PATHS"]

PATHS = ("reference", "cuda")
DEFAULT_SPEC = "bca"  # M, N outer; K (reduction) innermost: output-stationary
# The ops whose draw ``hw_prng`` moves to K13 (attn_mask stays keyed on
# coordinates: the reference would hand it an ``_impl`` it does not take).
HW_PRNG_OPS = frozenset({"dropout_rng", "dropout_rng_grad"})


# ---------------------------------------------------------------------------
# Legality and planning
# ---------------------------------------------------------------------------

def validate_epilogue_band(nest, graph: TppGraph, *, m_letter="b", n_letter="c"):
    """A normalizing epilogue reduces over N, so its row closes only when
    all N tiles of a row are visited consecutively: ``TPP103`` for an N
    level outside the deepest M level, ``TPP104`` for a parallel N,
    ``TPP105`` for an N sharded over a mesh axis."""
    footprint.enforce(
        footprint.check_epilogue_band(nest, graph, m_letter=m_letter, n_letter=n_letter),
        exc=FusionLegalityError)


def build_nest_inputs(graph: TppGraph, m: int, k: int, n: int, tiles,
                      block_steps: Optional[dict] = None, *,
                      rhs_widths: Optional[dict] = None, chain_n2: Optional[int] = None):
    """The reference's ``LoopSpec``s and ``TensorMap``s for ``graph`` at
    problem (M, K, N) with base tiles (bm, bk, bn): operands in canonical
    order (each shared lhs once), rowvecs and scalars wholly visible,
    (M, N) operands tiled with the output except the row-resident ones
    (full ``(bm, n)`` rows), transposed contraction operands in their
    stored layout, narrow rhs operands (``rhs_widths``, GQA's k and v)
    wholly resident, the chain operand ``(bn, chain_n2)`` walked by N; the
    output ``(bm, bn)``, full rows ``(bm, n)`` for a reducing graph,
    ``(bm, chain_n2)`` for a chained one, with a leading stacking axis for
    several outputs.  ``TPP108`` when the tiles do not divide the shape."""
    bm, bk, bn = tiles
    if m % bm or k % bk or n % bn:
        raise FusionLegalityError(
            f"graph {graph.name!r}: problem ({m},{k},{n}) not divisible by "
            f"tiles ({bm},{bk},{bn}) — pick tiles dividing the problem "
            "shape (pick_tiles chooses divisors automatically)", code="TPP108")
    mb, kb, nb = m // bm, k // bk, n // bn
    block_steps = block_steps or {}
    rhs_widths = rhs_widths or {}
    if graph.chained_root() is not None and chain_n2 is None:
        chain_n2 = k   # attention: the chain restores the lhs width
    loops = [
        LoopSpec(0, kb, 1, block_steps=tuple(block_steps.get("a", ())), name="K"),
        LoopSpec(0, mb, 1, block_steps=tuple(block_steps.get("b", ())), name="M"),
        LoopSpec(0, nb, 1, block_steps=tuple(block_steps.get("c", ())), name="N"),
    ]
    row_res = graph.row_resident_operands()
    in_maps = []
    for spec in graph.contraction_operands:
        if spec.kind == "lhs":
            in_maps.append(TensorMap(("a", "b"), (bk, bm), layout="flat") if spec.trans
                           else TensorMap(("b", "a"), (bm, bk), layout="flat"))
        elif spec.kind == "crhs":
            in_maps.append(TensorMap(("c", None), (bn, chain_n2), layout="flat"))
        elif spec.name in rhs_widths:
            w = rhs_widths[spec.name]
            in_maps.append(TensorMap((None, "a"), (w, bk), layout="flat") if spec.trans
                           else TensorMap(("a", None), (bk, w), layout="flat"))
        else:
            in_maps.append(TensorMap(("c", "a"), (bn, bk), layout="flat") if spec.trans
                           else TensorMap(("a", "c"), (bk, bn), layout="flat"))
    for spec in graph.epilogue_operands:
        if spec.kind in ("tile", "mask"):
            in_maps.append(TensorMap(("b", None), (bm, n), layout="flat")
                           if spec.name in row_res
                           else TensorMap(("b", "c"), (bm, bn), layout="flat"))
        elif spec.kind == "scalar":
            in_maps.append(TensorMap((None, None), (1, 1), layout="flat"))
        else:  # rowvec: the whole vector every call (norms need all of N)
            in_maps.append(TensorMap((None, None), (1, n), layout="flat"))
    n_out = len(graph.outputs)
    if graph.chained_root() is not None:
        out_map = TensorMap(("b", None), (bm, chain_n2), layout="flat")
    elif graph.reducing_node() is not None:
        out_map = (TensorMap((None, "b", None), (n_out, bm, n), layout="flat") if n_out > 1
                   else TensorMap(("b", None), (bm, n), layout="flat"))
    elif n_out > 1:
        out_map = TensorMap((None, "b", "c"), (n_out, bm, bn), layout="flat")
    else:
        out_map = TensorMap(("b", "c"), (bm, bn), layout="flat")
    return loops, in_maps, out_map


@dataclasses.dataclass(frozen=True, eq=False)
class GraphPlan:
    """A graph's nest planned at one problem shape.  ``plan`` is the
    ``CudaPlan`` (its ``visit_order`` lists output blocks, one column per
    letter of ``out_letters``); ``tiles`` the base tiles; ``prng_tile`` the
    (acc_m, acc_n) tile a pre-reduce PRNG node keys on (a post-reduce node
    keys on (acc_m, n)).  Compares by identity, so a cached plan keys the
    order tables made from it."""

    plan: CudaPlan
    tiles: tuple[int, int, int]
    prng_tile: tuple[int, int]
    out_letters: tuple


def _steps_key(block_steps):
    return tuple(sorted((k, tuple(v)) for k, v in (block_steps or {}).items()))


@functools.lru_cache(maxsize=512)
def _plan(graph, m, k, n, itemsize, spec_string, tiles, steps, widths, chain_n2):
    from repro_torch.kernels.brgemm import pick_tiles
    rhs_widths = dict(widths)
    bm, bk, bn = tiles or pick_tiles(m, k, n, torch.bfloat16 if itemsize == 2 else torch.float32)
    if rhs_widths and tiles is None:
        # every narrow width a whole number of N tiles (the gcd still
        # divides n); tiles the caller gave are checked as they are
        bn = math.gcd(bn, *rhs_widths.values())
    loops, in_maps, out_map = build_nest_inputs(
        graph, m, k, n, (bm, bk, bn), dict(steps), rhs_widths=rhs_widths, chain_n2=chain_n2)
    tl = ThreadedLoop(loops, spec_string, reduction_letters=("a",))
    validate_reduction_innermost(tl.nest, ("b", "c"), ("a",))
    validate_epilogue_band(tl.nest, graph)
    if any(EPILOGUE_OPS[nd.op].wants_offsets for nd in graph.nodes):
        footprint.enforce(footprint.check_prng_mesh(tl.nest, graph), exc=FusionLegalityError)
    acc_m = tl.nest.innermost_step("b") * bm
    acc_n = tl.nest.innermost_step("c") * bn
    for nm, w in rhs_widths.items():
        if w % acc_n:
            raise FusionLegalityError(
                f"graph {graph.name!r}: narrow rhs operand {nm!r} width {w} is not a "
                f"whole number of N blocks (block {acc_n}) — pass tiles/block_steps "
                "whose N block divides every per-root width", code="TPP108")
    require_no_mesh(tl.nest)
    plan = plan_cuda(tl.nest, in_maps, out_map, reduction_letters=("a",))
    return GraphPlan(plan, (bm, bk, bn), (acc_m, acc_n), out_map.letters)


def plan_graph(graph: TppGraph, m: int, k: int, n: int, dtype, *, spec_string=None,
               tiles=None, block_steps=None, rhs_widths=None, chain_n2=None) -> GraphPlan:
    """The reference's nest for ``graph`` (already simplified) at problem
    (M, K, N), planned and checked in the reference's order: ``TPP108``
    for tiles that do not divide the shape (default tiles
    ``brgemm.pick_tiles``, N shrunk to divide every narrow width), the
    nest's own codes (``TPP101``, ``TPP107``, ``TPP108``), ``TPP102``,
    ``TPP103``-``TPP105`` for a reducing graph, ``TPP106`` for a
    coordinate-keyed one; then a mesh level raises (nothing runs one), and
    ``plan_cuda``.  Memoized."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return _plan(graph, m, k, n, itemsize, spec_string or DEFAULT_SPEC,
                 tuple(tiles) if tiles else None, _steps_key(block_steps),
                 tuple(sorted((rhs_widths or {}).items())), chain_n2)


def _problem(graph: TppGraph, operands: dict):
    """(M, K, N, narrow rhs widths, chain width, lhs dtype) of a call, from
    the last two axes of its contraction operands."""
    def stored(nm):
        r, c = operands[nm].shape[-2:]
        return (c, r) if graph.operand(nm).trans else (r, c)

    base = graph.base_roots
    m, k = stored(base[0].lhs)
    widths = {r.rhs: stored(r.rhs)[1] for r in base}
    n = max(widths.values())
    chain = graph.chained_root()
    n2 = operands[chain.rhs].shape[-1] if chain is not None else None
    return (m, k, n, {nm: w for nm, w in widths.items() if w < n}, n2,
            operands[base[0].lhs].dtype)


def _schedule(spec_string, tiles, block_steps, hw_prng) -> dict:
    """The schedule keywords a caller gave (their non-default values)."""
    given = dict(spec_string=spec_string, tiles=tiles, block_steps=block_steps or None,
                 hw_prng=bool(hw_prng) or None)
    return {k: v for k, v in given.items() if v is not None}


def _plan_call(graph: TppGraph, operands: dict, schedule: dict) -> GraphPlan:
    m, k, n, widths, n2, dtype = _problem(graph, operands)
    return plan_graph(graph, m, k, n, dtype, spec_string=schedule.get("spec_string"),
                      tiles=schedule.get("tiles"), block_steps=schedule.get("block_steps"),
                      rhs_widths=widths, chain_n2=n2)


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

def _reference(graph: TppGraph, *, out_dtype=None, ignore=frozenset()):
    """``run(operands, hw_tile=None)``: the composed reference; with
    ``hw_tile`` (acc_m, acc_n) each ``dropout_rng``(``_grad``) node draws
    K13's bits per plan tile, full-row tiles after the reducing node."""
    post = {nd.name for nd in graph.post_reduce_nodes()}

    def run(operands, hw_tile=None):
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
            kw = nd.attr_dict()
            args = [value(r) for r in nd.inputs]
            if hw_tile is not None and nd.op in HW_PRNG_OPS:
                width = args[0].shape[-1] if nd.name in post else hw_tile[1]
                kw.update(_impl="hw", _tile=(hw_tile[0], width))
            env[nd.name] = op.apply(*args, **kw)
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

    return run


def _compile_reference(graph: TppGraph, *, out_dtype=None, ignore=frozenset(), schedule=None):
    run = _reference(graph, out_dtype=out_dtype, ignore=ignore)
    if not schedule:
        return lambda **operands: run(operands)

    def fn(**operands):
        gp = _plan_call(graph, operands, schedule)
        return run(operands, gp.prng_tile if schedule.get("hw_prng") else None)

    return fn


# ---------------------------------------------------------------------------
# Path 2: K5, one generated CUDA kernel
# ---------------------------------------------------------------------------

def _compile_cuda(graph: TppGraph, *, out_dtype=None, ignore=frozenset(), schedule=None):
    from repro_torch.kernels import fused_gemm
    kernel = fused_gemm.FusedKernel(graph)     # raises on what it cannot take
    hw = bool((schedule or {}).get("hw_prng"))
    seen: set = set()

    def launch(operands, with_lse):
        gp = _plan_call(graph, operands, schedule) if schedule else None
        return kernel(operands, out_dtype=out_dtype, plan=gp, hw_prng=hw, with_lse=with_lse)

    def run(operands, with_lse):
        packed = _pack_operands(graph, operands, ignore)
        key = tuple((tuple(v.shape), v.dtype) for v in packed)
        if key in seen:
            return launch(operands, with_lse)
        # a new operand shape: where the reference plans a new lowering;
        # here the first launch, which builds and loads the graph's kernel
        # on its first use
        obs_metrics.default_registry().counter("fusion.lowerings").inc()
        with obs_trace.get_tracer().span("fusion.lower", cat="fusion", graph=graph.name):
            out = launch(operands, with_lse)
        seen.add(key)
        return out

    def fn(**operands):
        return run(operands, False)

    # a chained graph's forward with its row log-sum-exp: → (out, lse)
    fn.with_lse = lambda **operands: run(operands, True)
    return fn


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def compile(graph: TppGraph, *, path: str = "cuda", simplify: bool = True,
            out_dtype=None, spec_string=None, tiles=None, block_steps=None,
            hw_prng: bool = False):
    """Lower ``graph`` to ``fn(**operands) -> (M, N)`` (``(R, M, N)`` for R
    outputs).  The graph is first simplified (identity and rate-0 dropout
    nodes and dead operands go; dropped operands stay accepted) and its
    PRNG salts checked (TPP203).  ``path="cuda"`` generates K5's CUDA source
    now and raises ``FusionLegalityError`` for a graph it does not take;
    ``spec_string``, ``tiles``, ``block_steps`` and ``hw_prng`` schedule it
    (module docstring), planned at each call from the operands' shapes.
    ``path="reference"`` is the composed reference and takes ``out_dtype``
    only: ``TypeError`` for a schedule, as the reference's XLA path."""
    lowered = simplify_graph(graph) if simplify else graph
    rng.assert_unique_salts(lowered)
    ignore = frozenset(graph.operand_names) - frozenset(lowered.operand_names)
    schedule = _schedule(spec_string, tiles, block_steps, hw_prng)
    if path == "reference":
        if schedule:
            raise TypeError(f"reference path does not accept {sorted(schedule)}")
        return _compile_reference(lowered, out_dtype=out_dtype, ignore=ignore)
    if path == "cuda":
        return _compile_cuda(lowered, out_dtype=out_dtype, ignore=ignore, schedule=schedule)
    raise ValueError(f"unknown lowering path {path!r}; use one of {PATHS}")


def plain_version(graph: TppGraph, *, simplify: bool = True, out_dtype=None,
                  spec_string=None, tiles=None, block_steps=None, hw_prng: bool = False):
    """K5's plain version under a schedule, on tensors of any device: the
    composed reference, with each ``dropout_rng``(``_grad``) node's draw
    taken per plan tile from K13's plain version under ``hw_prng=True``.
    The schedule is planned and checked at each call as ``path="cuda"``
    plans it.  It is what ``compile_for_device`` runs for CPU tensors, and
    what a scheduled kernel is held against on the card."""
    lowered = simplify_graph(graph) if simplify else graph
    rng.assert_unique_salts(lowered)
    return _compile_reference(
        lowered, out_dtype=out_dtype,
        ignore=frozenset(graph.operand_names) - frozenset(lowered.operand_names),
        schedule=_schedule(spec_string, tiles, block_steps, hw_prng))


_COMPILE_CACHE: dict = {}
_SCHEDULE_KW = ("spec_string", "tiles", "block_steps", "hw_prng")


def compile_for_device(graph: TppGraph, *, out_dtype=None, **schedule):
    """The memoized callable the library helpers and the derived backward
    graphs use: CPU operands run the composed reference (``plain_version``
    under a schedule), CUDA operands K5's generated kernel (compiled at the
    graph's first CUDA call, which raises for a graph the generator does
    not take); the output is ``out_dtype``, by default the first lhs
    operand's dtype.  ``schedule``: ``spec_string``, ``tiles``,
    ``block_steps``, ``hw_prng``, planned and checked on either device.
    Memoized per graph, ``out_dtype`` and schedule; counts
    ``fusion.compile_cache.hits``/``.misses`` in the default registry."""
    bad = sorted(set(schedule) - set(_SCHEDULE_KW))
    if bad:
        raise TypeError(f"compile_for_device does not accept {bad}")
    reg = obs_metrics.default_registry()
    key = (graph, out_dtype, _freeze(schedule))
    hit = _COMPILE_CACHE.get(key)
    if hit is not None:
        reg.counter("fusion.compile_cache.hits").inc()
        return hit
    reg.counter("fusion.compile_cache.misses").inc()
    with obs_trace.get_tracer().span("fusion.compile", cat="fusion", graph=graph.name):
        reference = plain_version(graph, out_dtype=out_dtype, **schedule)
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
            cuda.append(compile(graph, path="cuda", out_dtype=out_dtype, **schedule))
        return cuda[0](**operands)

    _COMPILE_CACHE[key] = fn
    return fn
