"""Write-footprint race analysis for planned loop nests (``TPP1xx``).

The nest passes of ``repro/analysis/footprint.py``: :class:`WriteSink`,
:func:`nest_sinks`, :func:`check_nest` and :func:`check_reduction_innermost`.
For a perfectly nested ``ThreadedLoop`` the block a body visit writes is
selected by the letters that index the sink and by nothing else, so two
iterations of a level touch disjoint blocks exactly when the level's letter
indexes the sink.  A parallel level (uppercase, or an ``{axis:N}``
decomposition) is race-free when its letter indexes every sink the nest
writes.

The graph passes plan a fused ``TppGraph`` (``fusion.lowering.plan_graph``):
:func:`graph_sinks` (a reducing epilogue narrows the output to full rows and
adds the row panels and the statistics strip, all indexed by M only),
:func:`check_epilogue_band` (``TPP103``/``TPP104``/``TPP105``),
:func:`check_prng_mesh` (``TPP106``) and :func:`verify_schedule`, their
union.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.analysis.diagnostics import Diagnostic, diag, enforce

__all__ = ["WriteSink", "nest_sinks", "graph_sinks", "check_nest",
           "check_reduction_innermost", "check_epilogue_band", "check_prng_mesh",
           "verify_schedule", "enforce"]


@dataclasses.dataclass(frozen=True)
class WriteSink:
    """One write target of the nest and the letters that index its blocks."""

    name: str                  # "output", "row-panel[v]", "stats-strip"
    letters: frozenset         # loop letters selecting the written block
    detail: str = ""           # extra context for the diagnostic message


def nest_sinks(letters: Sequence[str],
               reduction_letters: Sequence[str]) -> tuple[WriteSink, ...]:
    """Default sink set for a bare ``ThreadedLoop``: one output whose block
    index is every non-reduction letter (reduction letters revisit)."""
    out = frozenset(l for l in letters if l not in reduction_letters)
    return (WriteSink("output", out),)


def graph_sinks(graph, *, m_letter: str = "b",
                n_letter: str = "c") -> tuple[WriteSink, ...]:
    """The sinks of a fused ``TppGraph``'s nest: what the lowering writes.
    A reducing epilogue narrows the output to full rows (indexed by M
    only) and adds the staged row panels and the statistics strip; a
    chained root stages no panel, and its accumulator and (running max,
    running sum) strip are indexed by M only."""
    reducing = graph.reducing_node()
    if reducing is None:
        return (WriteSink("output", frozenset((m_letter, n_letter))),)
    chained = graph.chained_root()
    if chained is not None:
        return (
            WriteSink("output", frozenset((m_letter,)),
                      detail=f"chained-root close ({chained.name} = "
                             f"{reducing.op!r} panel @ {chained.rhs})"),
            WriteSink("chain-accumulator", frozenset((m_letter,)),
                      detail="(M, N2) partial products, rescaled on each "
                             "new running max"),
            WriteSink("stats-strip", frozenset((m_letter,)),
                      detail="(running max, running sum) accumulated over "
                             "N tiles"),
        )
    sinks = [WriteSink("output", frozenset((m_letter,)),
                       detail=f"full-row close of reducing op {reducing.op!r}")]
    for v in sorted(graph.staged_values()):
        sinks.append(WriteSink(f"row-panel[{v}]", frozenset((m_letter,)),
                               detail="staged row panel, one row at a time"))
    sinks.append(WriteSink("stats-strip", frozenset((m_letter,)),
                           detail="(sum, sum-sq) accumulated over N tiles"))
    return tuple(sinks)


def _race_code(level, sink: WriteSink) -> str:
    if sink.name == "output" and len(sink.letters) > 1:
        return "TPP101"
    return "TPP105" if level.mesh_axis is not None else "TPP104"


def check_nest(levels, *, spec_raw: str, letters: Sequence[str],
               reduction_letters: Sequence[str],
               sinks: Optional[Sequence[WriteSink]] = None) -> list[Diagnostic]:
    """Footprint disjointness for every parallel-marked level against every
    sink: a reduction letter is a letter that indexes no sink."""
    if sinks is None:
        sinks = nest_sinks(letters, reduction_letters)
    out = []
    for pos, lvl in enumerate(levels):
        if not (lvl.parallel or lvl.mesh_axis is not None):
            continue
        for sink in sinks:
            if lvl.letter in sink.letters:
                continue  # disjoint footprints per iteration: race-free
            how = (f"sharded {lvl.ways}-ways over mesh axis "
                   f"{lvl.mesh_axis!r}" if lvl.mesh_axis is not None
                   else "marked PARALLEL")
            alt = (f"write it lowercase ('{lvl.letter}'), parallelize a "
                   f"letter that indexes the {sink.name} instead"
                   + (f" (one of {sorted(sink.letters)})" if sink.letters
                      else ""))
            if lvl.letter in reduction_letters:
                alt += (", or pass allow_races=True with a reduction-"
                        "combine plan (e.g. mesh split-K + psum)")
            detail = f" — {sink.detail}" if sink.detail else ""
            out.append(diag(
                _race_code(lvl, sink),
                f"spec {spec_raw!r}: loop {lvl.letter!r} at level {pos} is "
                f"{how}, but the {sink.name} write footprint is indexed by "
                f"{sorted(sink.letters)} only{detail}; concurrent "
                f"iterations would write the same blocks. Suggested fix: "
                f"{alt}.",
                site=spec_raw))
            break  # one diagnostic per level: the first sink hit explains it
    return out


def check_reduction_innermost(nest, out_letters: Sequence[str],
                              reduction_letters: Sequence[str]
                              ) -> list[Diagnostic]:
    """``TPP102``: every in-grid reduction level must sit strictly below the
    deepest output-indexing level, so an output block's visits are
    consecutive.  On the card one CTA owns an output block and walks the
    reduction inside it, which needs the same order.  Mesh levels are
    excluded (split-K shards would combine above the grid)."""
    grid = [(p, l) for p, l in enumerate(nest.levels) if l.mesh_axis is None]
    out_pos = [p for p, l in grid if l.letter in out_letters]
    red_pos = [p for p, l in grid if l.letter in reduction_letters]
    if out_pos and red_pos and min(red_pos) < max(out_pos):
        return [diag(
            "TPP102",
            f"spec {nest.spec.raw!r}: reduction loop level at grid position "
            f"{min(red_pos)} is outside the innermost band (deepest output "
            f"level at {max(out_pos)}) — output revisits would not be "
            "consecutive, and one CUDA block owns an output block and "
            "reduces inside it. Use a K-innermost "
            "order, the executor path, or a mesh split-K decomposition.",
            site=nest.spec.raw)]
    return []


def check_epilogue_band(nest, graph, *, m_letter: str = "b",
                        n_letter: str = "c") -> list[Diagnostic]:
    """Reducing-epilogue schedule rules: band order (``TPP103``) and the
    races on the M-only sinks (``TPP104``, ``TPP105``)."""
    nd = graph.reducing_node()
    if nd is None:
        return []
    out = []
    grid = [(p, l) for p, l in enumerate(nest.levels) if l.mesh_axis is None]
    m_pos = [p for p, l in grid if l.letter == m_letter]
    n_pos = [p for p, l in grid if l.letter == n_letter]
    if m_pos and n_pos and max(m_pos) > min(n_pos):
        out.append(diag(
            "TPP103",
            f"graph {graph.name!r}: epilogue {nd.op!r} reduces over the N "
            f"axis but spec {nest.spec.raw!r} places an N loop level (grid "
            f"position {min(n_pos)}) outside the innermost band (deepest M "
            f"level at {max(m_pos)}) — row statistics would close before "
            "the row is complete. Use an N-inside-M order, e.g. 'bca'.",
            site=f"{graph.name}:{nest.spec.raw}"))
    sinks = graph_sinks(graph, m_letter=m_letter, n_letter=n_letter)
    for pos, lvl in enumerate(nest.levels):
        if lvl.letter != n_letter:
            continue
        if not (lvl.parallel or lvl.mesh_axis is not None):
            continue
        sink = next(s for s in sinks if lvl.letter not in s.letters)
        if lvl.mesh_axis is not None:
            out.append(diag(
                "TPP105",
                f"graph {graph.name!r}: epilogue {nd.op!r} reduces over N; "
                f"sharding N over mesh axis {lvl.mesh_axis!r} in "
                f"{nest.spec.raw!r} would leave per-shard partial row "
                "statistics (no cross-shard norm combine). Keep N "
                "unsharded, or shard the M loop instead.",
                site=f"{graph.name}:{nest.spec.raw}"))
        else:
            out.append(diag(
                "TPP104",
                f"graph {graph.name!r}: epilogue {nd.op!r} reduces over N; "
                f"the N loop at level {pos} of spec {nest.spec.raw!r} "
                f"cannot take PARALLEL grid semantics — the {sink.name} "
                f"({sink.detail}) is indexed by {sorted(sink.letters)} "
                "only, so concurrent N iterations race on it. Write the N "
                f"letter lowercase, or parallelize {m_letter!r}.",
                site=f"{graph.name}:{nest.spec.raw}"))
    return out


def check_prng_mesh(nest, graph, *, m_letter: str = "b",
                    n_letter: str = "c") -> list[Diagnostic]:
    """``TPP106``: coordinate-keyed epilogues (counter-PRNG dropout, the
    attention mask) regenerate their pattern from global (M, N) element
    coordinates; a mesh-sharded output loop makes block coordinates
    shard-local, so the pattern would repeat across shards."""
    from repro_torch.fusion.graph import EPILOGUE_OPS
    if not any(EPILOGUE_OPS[nd.op].wants_offsets for nd in graph.nodes):
        return []
    sharded = [l for l in nest.mesh_levels if l.letter in (m_letter, n_letter)]
    if not sharded:
        return []
    lvl = sharded[0]
    return [diag(
        "TPP106",
        f"graph {graph.name!r}: a coordinate-keyed epilogue (PRNG draw or "
        f"attention mask) keys its pattern on global (M, N) element "
        f"coordinates, but spec {nest.spec.raw!r} shards the output loop "
        f"{lvl.letter!r} over mesh axis {lvl.mesh_axis!r} — block "
        "coordinates inside a shard are local, so the regenerated pattern "
        "would repeat across shards.",
        site=f"{graph.name}:{nest.spec.raw}")]


def verify_schedule(nest, graph=None, *, out_letters: Sequence[str] = ("b", "c"),
                    reduction_letters: Sequence[str] = ("a",)
                    ) -> list[Diagnostic]:
    """Every schedule-level pass over one planned nest (and optionally a
    graph); returns all findings instead of raising."""
    diags = check_nest(
        nest.levels, spec_raw=nest.spec.raw, letters=nest.letters,
        reduction_letters=reduction_letters)
    diags += check_reduction_innermost(nest, out_letters, reduction_letters)
    if graph is not None:
        diags += check_epilogue_band(nest, graph, m_letter=out_letters[0],
                                     n_letter=out_letters[1])
        diags += check_prng_mesh(nest, graph, m_letter=out_letters[0],
                                 n_letter=out_letters[1])
    return diags
