"""Write-footprint race analysis for planned loop nests (``TPP1xx``).

The nest passes of ``repro/analysis/footprint.py``: :class:`WriteSink`,
:func:`nest_sinks`, :func:`check_nest` and :func:`check_reduction_innermost`.
For a perfectly nested ``ThreadedLoop`` the block a body visit writes is
selected by the letters that index the sink and by nothing else, so two
iterations of a level touch disjoint blocks exactly when the level's letter
indexes the sink.  A parallel level (uppercase, or an ``{axis:N}``
decomposition) is race-free when its letter indexes every sink the nest
writes.

The graph passes (``graph_sinks``, ``check_epilogue_band``,
``check_prng_mesh``, ``verify_schedule``) are not ported yet; they wait for
ROADMAP.md, Queue 1 item 11.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.analysis.diagnostics import Diagnostic, diag, enforce

__all__ = ["WriteSink", "nest_sinks", "check_nest", "check_reduction_innermost",
           "enforce"]


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
