"""Cost path for TppGraphs: performance-model scoring and end-to-end
autotuning of the fused nest (paper Fig. 1 Box B3, extended to fused
epilogues), ported from ``repro/fusion/cost.py``.

Fusing the epilogue changes the traffic picture in two ways the base GEMM
model does not see:

  * the epilogue operands (residual tiles, masks, row vectors) ride the same
    nest and add HBM reads: they enter ``perf_model.predict`` as extra
    ``TensorMap``s built by ``lowering.build_nest_inputs``;
  * the epilogue itself costs elementwise time proportional to the output
    elements: ``predict``'s ``epilogue_flops`` term.

What fusion *saves* is the unfused chain's intermediate round-trips: each
stand-alone epilogue op re-reads and re-writes the (M, N) activation from
HBM.  ``estimate_unfused`` prices that chain.

The target is the card's (``perf_model.H100Target``) unless a caller passes
another; the ``TpuTarget`` gives the reference's numbers.  A tuned
schedule runs through ``lowering.compile_for_device`` (``schedule_kwargs``):
on CUDA operands K5 under that schedule, on CPU operands its plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core import autotune, perf_model
from repro_torch.core.loops import ThreadedLoop
from repro_torch.fusion import lowering
from repro_torch.fusion.graph import EPILOGUE_OPS, TppGraph, simplify_graph

__all__ = ["graph_cost", "autotune_graph", "measured_autotune_graph",
           "estimate_unfused", "UnfusedEstimate", "schedule_kwargs",
           "graph_signature"]


def schedule_kwargs(candidate: autotune.Candidate) -> dict:
    """Turn an ``autotune_graph`` winner into ``fusion.compile`` kwargs —
    multi-level blockings live in the candidate's loops, not the spec string:

        best = fusion.autotune_graph(g, m, k, n, ...)[0]
        fn = fusion.compile_for_device(g, **fusion.schedule_kwargs(best.candidate))
    """
    return {
        "spec_string": candidate.spec_string,
        "block_steps": {
            letter: tuple(loop.block_steps)
            for letter, loop in zip("abc", candidate.loops)
            if loop.block_steps
        },
    }


# Completeness contract for :func:`graph_signature` (TPP301): every field of
# every IR dataclass must be listed here, and listing it asserts the
# signature string encodes it.  An unencoded field would let schedules
# tuned for differently-lowered graphs collide in the persistent tune cache.
SIGNATURE_FIELDS = {
    "TppGraph": frozenset({"name", "operands", "roots", "nodes", "outputs"}),
    "OperandSpec": frozenset({"name", "kind", "trans"}),
    "Node": frozenset({"name", "op", "inputs", "attrs"}),
    "ContractionRoot": frozenset({"name", "lhs", "rhs", "chained"}),
}


def graph_signature(graph: TppGraph) -> str:
    """Stable identity of a graph's cost-relevant structure — the epilogue
    component of the persistent tune-cache key.  Root structure (how many
    contractions, which operands they share) and the output tuple are part of
    the identity: a two-root gated-MLP nest costs differently from a
    single-GEMM nest over the same operand kinds."""
    parts = [graph.name]
    parts += [f"{o.name}:{o.kind}" + ("^T" if o.trans else "")
              for o in graph.operands]
    # chained roots lower to a different kernel (chain accumulator +
    # streaming maxsum strip): the "~chain" marker keys them apart
    parts += [f"{r.name}<-{r.lhs}@{r.rhs}" + ("~chain" if r.chained else "")
              for r in graph.roots]
    parts += [
        f"{nd.name}={nd.op}({','.join(nd.inputs)};{sorted(nd.attrs)})"
        for nd in graph.nodes
    ]
    parts.append("out:" + ",".join(graph.outputs))
    # in-kernel PRNG ops: the bit-generation scheme is part of the identity —
    # a schedule tuned under a different generator (different flops/elem)
    # must not be served from the cache.  Node attrs already carry the rate
    # and salt, so rate-0 (simplified-away) vs rate>0 graphs, and the legacy
    # mask op vs dropout_rng, all key distinct entries.
    if any(EPILOGUE_OPS[nd.op].wants_offsets for nd in graph.nodes):
        from repro_torch.fusion import rng
        parts.append(f"rng:{rng.SCHEME}")
    return "|".join(parts)


def _epilogue_flops(graph: TppGraph, m: int, n: int, k: int = 0) -> float:
    f = graph.epilogue_flops_per_elem() * m * n
    if graph.chained_root() is not None and k:
        # the chained GEMM streams inside the epilogue band: one (bm, bn) x
        # (bn, N2) product per N visit, 2·M·N·N2 flops total.  N2 is not
        # known at cost time; K is the attention default (the chain restores
        # the lhs width) and exact for fused_attention_graph.
        f += 2.0 * m * n * k
    return f


def _acc_scratch(graph: TppGraph, acc_m: int, acc_n: int, n: int,
                 k: int) -> int:
    """Shared tail of the scratch estimates: base-root accumulators plus the
    chain accumulator/strip (chained) or staged panels + strip (reducing)."""
    sb = len(graph.base_roots) * acc_m * acc_n * 4
    if graph.chained_root() is not None:
        sb += acc_m * max(k, 1) * 4     # chain accumulator (N2 ≈ K)
        sb += acc_m * 2 * 4             # (running max, running sum)
    elif graph.reducing_node() is not None:
        sb += max(1, len(graph.staged_values())) * acc_m * n * 4
        sb += acc_m * 2 * 4
    return sb


def _scratch_bytes(graph: TppGraph, nest, tiles, n: int, k: int = 0) -> int:
    """On-chip scratch of the fused kernel: one fp32 accumulator tile per
    contraction root plus, for normalizing epilogues, one full-row panel per
    staged value and the stats strip."""
    bm, bk, bn = tiles
    acc_m = nest.innermost_step("b") * bm
    acc_n = nest.innermost_step("c") * bn
    return _acc_scratch(graph, acc_m, acc_n, n, k)


def _scratch_bytes_static(graph: TppGraph, loops, tiles, n: int,
                          k: int = 0) -> int:
    """``_scratch_bytes`` without a planned nest: the innermost occurrence of
    a letter always advances by the loop's base step, so the accumulator
    footprint is schedule-invariant (loops are [K, M, N] from
    ``build_nest_inputs``)."""
    bm, bk, bn = tiles
    acc_m = loops[1].step * bm
    acc_n = loops[2].step * bn
    return _acc_scratch(graph, acc_m, acc_n, n, k)


def _default_tiles(m, k, n, dtype):
    from repro_torch.kernels.brgemm import pick_tiles
    return pick_tiles(m, k, n, torch.bfloat16 if perf_model.dtype_bytes(dtype) == 2
                      else torch.float32)


def graph_cost(
    graph: TppGraph,
    m: int, k: int, n: int,
    *,
    tiles: tuple[int, int, int],
    dtype,
    spec_string: str = lowering.DEFAULT_SPEC,
    block_steps: Optional[dict] = None,
    target=perf_model.H100Target(),
    mode: str = "analytic",
) -> perf_model.PerfReport:
    """Predict one fused-nest schedule, epilogue traffic and time included.
    Multi-root graphs issue one GEMM per root per body visit (the
    ``flops_per_body`` factor) and map each distinct contraction operand once
    — a shared lhs is fetched once per (M, K) visit, which is precisely the
    traffic the fusion saves over R separate GEMMs."""
    graph = simplify_graph(graph)
    bm, bk, bn = tiles
    loops, in_maps, out_map = lowering.build_nest_inputs(
        graph, m, k, n, tiles, block_steps)
    tl = ThreadedLoop(loops, spec_string, reduction_letters=("a",))
    lowering.validate_reduction_innermost(tl.nest, ("b", "c"), ("a",))
    lowering.validate_epilogue_band(tl.nest, graph)
    return perf_model.predict(
        tl.nest, in_maps, out_map,
        dtype=dtype,
        flops_per_body=2.0 * bm * bn * bk * len(graph.base_roots),
        tile_mnk=(bm, bn, bk),
        target=target,
        reduction_letters=("a",),
        epilogue_flops=_epilogue_flops(graph, m, n, k),
        scratch_bytes=_scratch_bytes(graph, tl.nest, tiles, n, k),
        mode=mode,
    )


def _graph_schedule_filter(graph: TppGraph, *, m_letter="b", n_letter="c",
                           reduction=("a",)):
    """Generation-time counterpart of ``validate_reduction_innermost`` +
    ``validate_epilogue_band``, expressed on the raw occurrence sequence so
    the streaming tuner can reject graph-illegal schedules without planning a
    nest.  Positions in ``mesh_pos`` are sharded levels (excluded from the
    grid-order comparisons, like ``nest.grid_levels``); ``par_pos`` are
    occurrences with parallel semantics (uppercase or mesh-implied).  The
    survivors are re-validated against the real validators on the planned
    top-k — and a test pins this filter to them.

    Multi-root graphs add no *schedule* constraints beyond these: every root
    rides the same (K, M, N) nest, so K-innermost and (for a reducing
    epilogue) the N-inside-M band rules cover all roots at once."""
    reducing = graph.reducing_node() is not None

    def ok(perm, par_pos, mesh_pos):
        if not autotune.reduction_inside_outputs(perm, mesh_pos, (m_letter, n_letter),
                                                 reduction):
            return False  # no CTA would own its output block
        if reducing:
            mesh = set(mesh_pos)
            out_pos = [i for i, ch in enumerate(perm)
                       if (ch == m_letter or ch == n_letter) and i not in mesh]
            m_pos = [i for i in out_pos if perm[i] == m_letter]
            n_pos = [i for i in out_pos if perm[i] == n_letter]
            if m_pos and n_pos and max(m_pos) > min(n_pos):
                return False  # row statistics close before the row completes
            if any(perm[i] == n_letter for i in par_pos):
                return False  # statistics accumulate sequentially
            if any(perm[i] == n_letter for i in mesh_pos):
                return False  # per-shard partial row statistics
        return True

    return ok


def _graph_validator(graph: TppGraph):
    """Planned-nest legality for ``graph`` (single- or multi-root): K in the
    innermost band, plus the reducing-epilogue band rules when present."""
    def validate(tl):
        lowering.validate_reduction_innermost(tl.nest, ("b", "c"), ("a",))
        lowering.validate_epilogue_band(tl.nest, graph)
    return validate


def autotune_graph(
    graph: TppGraph,
    m: int, k: int, n: int,
    *,
    tiles: Optional[tuple[int, int, int]] = None,
    dtype=torch.float32,
    parallel_letters: Sequence[str] = ("b", "c"),
    max_blockings: Optional[Sequence[int]] = None,
    max_candidates: Optional[int] = 200,
    target=perf_model.H100Target(),
    seed: int = 0,
    strategy: str = "streaming",
    top_k: Optional[int] = 32,
    measure_fn=None,
    measure_top_k: int = 5,
    cache=None,
    cache_dir=None,
    use_cache: bool = True,
    return_stats: bool = False,
    cache_extra: tuple = (),
):
    """Tune the fused nest end-to-end: stream loop_spec_strings under the
    paper's constraint grammar, drop candidates that are illegal *for this
    graph* (epilogue band conflicts) at generation time, score the rest with
    the fused perf model in batches, and persist the ranked schedules in the
    tune cache keyed on the graph signature (and ``cache_extra``).  Returns
    results best-first; feed the winner into
    ``fusion.compile_for_device(graph, **schedule_kwargs(...))``.  ``tiles``
    default to ``brgemm.pick_tiles``, as K5's own plan takes them."""
    graph = simplify_graph(graph)
    if tiles is None:
        tiles = _default_tiles(m, k, n, dtype)
    bm, bk, bn = tiles
    loops, in_maps, out_map = lowering.build_nest_inputs(graph, m, k, n, tiles)
    # a normalizing epilogue forbids PARALLEL semantics on the N loop
    if graph.reducing_node() is not None:
        parallel_letters = tuple(l for l in parallel_letters if l != "c")
    results, stats = autotune.autotune_with_stats(
        loops, in_maps, out_map,
        dtype=dtype,
        flops_per_body=2.0 * bm * bn * bk * len(graph.base_roots),
        tile_mnk=(bm, bn, bk),
        reduction_letters=("a",),
        epilogue_flops=_epilogue_flops(graph, m, n, k),
        scratch_bytes=_scratch_bytes_static(graph, loops, tiles, n, k),
        max_blockings=list(max_blockings) if max_blockings else None,
        parallel_letters=parallel_letters,
        target=target,
        max_candidates=max_candidates,
        seed=seed,
        strategy=strategy,
        top_k=top_k,
        spec_filter=_graph_schedule_filter(graph),
        validate_fn=_graph_validator(graph),
        measure_fn=measure_fn,
        measure_top_k=measure_top_k,
        cache=cache,
        cache_dir=cache_dir,
        use_cache=use_cache,
        cache_extra=("tppgraph", graph_signature(graph), m, k, n) + tuple(cache_extra),
    )
    return (results, stats) if return_stats else results


def measured_autotune_graph(graph, m, k, n, *, device="cuda",
                            measure_iters: int = 3, measure_warmup: int = 1,
                            seed: int = 0, **kw):
    """:func:`autotune_graph` with the model's top candidates re-ranked by
    measurement (``repro_torch.obs.profiler``'s warmup + median): on
    ``device="cuda"`` K5 launched under each candidate's schedule and timed
    on the card (``profiler.time_callable``), on ``"cpu"`` its plain
    version on the host clock.  Measured times persist in the tune cache
    (``measured_s``) under a key of their own that names the device, so
    later processes measuring on that device inherit the re-ranking, and
    no other device's times and no model-only search ever read it."""
    from repro_torch.obs import profiler

    measure_fn = profiler.make_measure_fn(
        graph, m, k, n, dtype=kw.get("dtype", torch.float32), device=device,
        tiles=kw.get("tiles"), seed=seed, iters=measure_iters,
        warmup=measure_warmup)
    return autotune_graph(graph, m, k, n, measure_fn=measure_fn,
                          cache_extra=("measured on", _measuring_device(device)), **kw)


def _measuring_device(device) -> str:
    """The device a re-rank is measured on, as its tune-cache entry names
    it: "cpu", or the card's type and name."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda {torch.cuda.get_device_name(dev)}"
    return dev.type


# ---------------------------------------------------------------------------
# The unfused comparison chain
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class UnfusedEstimate:
    """Price of running the graph as one stand-alone GEMM per contraction
    root plus one HBM round-trip per epilogue op (an op-by-op runtime at
    size).  A shared lhs operand is re-read per GEMM — that re-read is
    exactly what the multi-root fused nest saves."""

    gemm_time: float
    epilogue_time: float
    hbm_bytes: float
    total_time: float
    per_op: dict


def _elementwise_rate(target) -> float:
    """The rate of stand-alone elementwise work: a TPU's vector unit, an
    H100's fp32 CUDA cores."""
    if isinstance(target, perf_model.H100Target):
        return target.peak_flops_fp32
    return target.vpu_flops


def estimate_unfused(
    graph: TppGraph,
    m: int, k: int, n: int,
    *,
    dtype,
    tiles: Optional[tuple[int, int, int]] = None,
    spec_string: str = lowering.DEFAULT_SPEC,
    target=perf_model.H100Target(),
) -> UnfusedEstimate:
    graph = simplify_graph(graph)
    db = perf_model.dtype_bytes(dtype)
    act_bytes = m * n * db
    n_roots = len(graph.roots)

    if tiles is not None:
        # price the stand-alone GEMM with the same schedule-aware model the
        # fused nest is scored with (apples-to-apples refetch traffic); every
        # root runs as its own nest, re-reading its operands
        gemm_graph = TppGraph(
            name=f"{graph.name}_gemm_only",
            operands=(dataclasses.replace(graph.lhs),
                      dataclasses.replace(graph.rhs)))
        rep = graph_cost(gemm_graph, m, k, n, tiles=tiles, dtype=dtype,
                         spec_string=spec_string, target=target)
        gemm_time, gemm_bytes = n_roots * rep.total_time, n_roots * rep.hbm_bytes
    else:
        gemm_flops = 2.0 * m * n * k
        gemm_bytes = (m * k + k * n + m * n) * db
        gemm_time = n_roots * max(gemm_flops / target.peak_flops(db),
                                  gemm_bytes / target.hbm_bw)
        gemm_bytes *= n_roots

    rate = _elementwise_rate(target)
    per_op = {}
    ep_time = 0.0
    ep_bytes = 0.0
    for nd in graph.nodes:
        op = EPILOGUE_OPS[nd.op]
        operand_bytes = 0
        for ref in nd.inputs:
            try:
                spec = graph.operand(ref)
            except KeyError:
                continue  # chained value — already on HBM, counted as read
            operand_bytes += (m * n if spec.kind in ("tile", "mask")
                              else (1 if spec.kind == "scalar" else n)) * db
        bytes_op = 2 * act_bytes + operand_bytes      # read + write the act
        flops_op = op.flops_per_elem * m * n
        t = max(bytes_op / target.hbm_bw, flops_op / rate)
        per_op[nd.name] = t
        ep_time += t
        ep_bytes += bytes_op

    return UnfusedEstimate(
        gemm_time=gemm_time,
        epilogue_time=ep_time,
        hbm_bytes=gemm_bytes + ep_bytes,
        total_time=gemm_time + ep_time,
        per_op=per_op,
    )
