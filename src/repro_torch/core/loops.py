"""PARLOOPER logical-loop declaration and nest planning (paper §II-B).

The user declares *logical* loops (``LoopSpec``) and gets a ``ThreadedLoop``
whose instantiation (order, multi-level blocking, parallelization) is set
by one runtime knob, the ``loop_spec_string``.  A port of
``repro/core/loops.py``; the nest is planned the same way and raises the
same codes.  Its instantiation targets here:
  * the executor (``repro_torch.core.executor``), plain Python loops over
    torch tensors;
  * a CUDA plan (``repro_torch.core.cuda_lowering.plan_cuda``): the grid,
    the block shapes and the order in which the output blocks are first
    visited, which a kernel reads to rasterise its blocks;
  * ``{axis:N}`` mesh levels plan, but nothing runs them yet (one card;
    ROADMAP.md, Queue 1 item 12).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.analysis import footprint
from repro_torch.core import executor
from repro_torch.core.legality import LegalityError
from repro_torch.core.parser import ParsedSpec, parse_spec_string

__all__ = [
    "LoopSpec", "Level", "LoopNest", "ThreadedLoop", "LegalityError",
    "loop_signature",
]


@dataclasses.dataclass(frozen=True)
class LoopSpec:
    """One logical loop: ``for i in range(start, bound, step)``.

    ``block_steps`` is the optional list of *additional* step/blocking sizes
    (outer→inner), used when the loop's letter appears more than once in the
    spec string (paper Listing 1: ``{l1_k_step, l0_k_step}``).
    """

    start: int
    bound: int
    step: int = 1
    block_steps: tuple[int, ...] = ()
    name: str = ""

    def __post_init__(self):
        if self.step <= 0:
            raise ValueError(f"loop step must be positive, got {self.step}")
        if (self.bound - self.start) <= 0:
            raise ValueError(f"empty loop [{self.start}, {self.bound})")
        object.__setattr__(self, "block_steps", tuple(self.block_steps))

    @property
    def extent(self) -> int:
        return self.bound - self.start

    @property
    def signature(self) -> tuple:
        """Plan-relevant identity of this loop.  Excludes ``name``: two loops
        that differ only in their label plan identically, so plan/tune caches
        keyed on signatures share entries across call sites."""
        return (self.start, self.bound, self.step, self.block_steps)

    def steps_for(self, n_occurrences: int) -> tuple[int, ...]:
        """Outer→inner step sizes when this loop appears ``n_occurrences`` times.

        The innermost occurrence always advances by ``step``; outer occurrences
        take their steps from ``block_steps`` in declaration order.
        """
        if n_occurrences == 1:
            return (self.step,)
        n_blockings = n_occurrences - 1
        if n_blockings > len(self.block_steps):
            raise LegalityError(
                f"loop {self.name or '?'}: {n_occurrences} occurrences need "
                f"{n_blockings} block steps, only {len(self.block_steps)} "
                "declared — declare more block_steps or drop the extra "
                "occurrence from the spec string",
                code="TPP108",
            )
        outer = tuple(self.block_steps[:n_blockings])
        return outer + (self.step,)


def loop_signature(loops: Sequence["LoopSpec"]) -> str:
    """Stable, cheap string signature of a declared nest, the key the
    reference's plan and tune caches share (``repro/core/autotune.py``,
    ``tunecache.py``; not ported yet).  Two nests with equal signatures
    plan identically."""
    return ";".join(
        f"{start}:{bound}:{step}:{','.join(map(str, blocks))}"
        for start, bound, step, blocks in (l.signature for l in loops)
    )


@dataclasses.dataclass(frozen=True)
class Level:
    """One level of the instantiated loop nest (outer→inner order)."""

    letter: str
    loop_index: int          # which LoopSpec
    depth_in_loop: int       # 0 = outermost occurrence of this letter
    span: int                # iteration extent covered at this level
    step: int                # advance per iteration at this level
    parallel: bool
    mesh_axis: Optional[str]
    ways: Optional[int]
    barrier_after: bool
    is_innermost_of_loop: bool

    @property
    def trip_count(self) -> int:
        return self.span // self.step


@dataclasses.dataclass(frozen=True)
class LoopNest:
    """A fully planned instantiation of the logical loops."""

    spec: ParsedSpec
    loops: tuple[LoopSpec, ...]
    levels: tuple[Level, ...]        # outer→inner
    letters: tuple[str, ...]         # letter of each logical loop, 'a'..'z'

    # ---- derived views -------------------------------------------------
    @property
    def grid_levels(self) -> tuple[Level, ...]:
        """Levels that become grid/loop dimensions (mesh levels excluded)."""
        return tuple(l for l in self.levels if l.mesh_axis is None)

    @property
    def mesh_levels(self) -> tuple[Level, ...]:
        return tuple(l for l in self.levels if l.mesh_axis is not None)

    @property
    def mesh_axes(self) -> tuple[str, ...]:
        return tuple(dict.fromkeys(l.mesh_axis for l in self.mesh_levels))

    @property
    def grid(self) -> tuple[int, ...]:
        return tuple(l.trip_count for l in self.grid_levels)

    def total_body_calls(self) -> int:
        return math.prod(l.trip_count for l in self.levels)

    def innermost_step(self, letter: str) -> int:
        for l in reversed(self.levels):
            if l.letter == letter:
                return l.step
        raise KeyError(letter)

    def logical_index_exprs(self):
        """For each logical loop, the list of (level_position_in_levels, step)
        terms whose weighted sum yields the logical index value."""
        terms: dict[str, list[tuple[int, int]]] = {l: [] for l in self.letters}
        for pos, lvl in enumerate(self.levels):
            terms[lvl.letter].append((pos, lvl.step))
        return terms

    def describe(self) -> str:
        """Human-readable rendering of the generated nest (paper Listing 2/3)."""
        out = []
        indent = 0
        for lvl in self.levels:
            par = ""
            if lvl.mesh_axis is not None:
                par = f"  # sharded {lvl.ways}-ways over mesh axis '{lvl.mesh_axis}'"
            elif lvl.parallel:
                # the reference's wording, kept so both render alike
                par = "  # parallel (TPU grid PARALLEL semantics)"
            bar = "  # barrier after" if lvl.barrier_after else ""
            out.append(
                " " * indent
                + f"for {lvl.letter}{lvl.depth_in_loop} in range(0, {lvl.span}, {lvl.step})"
                + par
                + bar
            )
            indent += 2
        out.append(" " * indent + f"body(ind={list(self.letters)})")
        return "\n".join(out)


class ThreadedLoop:
    """Paper's ``ThreadedLoop<N>``: declare N logical loops, instantiate via a
    ``loop_spec_string``.  The instantiation is planned eagerly (and cached by
    the callers keyed on the spec string — mirroring the paper's JIT cache).
    """

    def __init__(
        self,
        loop_specs: Sequence[LoopSpec],
        spec_string: str,
        *,
        reduction_letters: Sequence[str] = (),
        allow_races: bool = False,
    ):
        self.loops = tuple(loop_specs)
        if len(self.loops) > 26:
            raise LegalityError("at most 26 logical loops (letters a..z)")
        self.letters = tuple(chr(ord("a") + i) for i in range(len(self.loops)))
        self.spec = parse_spec_string(spec_string)
        self.reduction_letters = tuple(reduction_letters)
        self.allow_races = allow_races
        self.nest = self._plan()

    # ------------------------------------------------------------------
    def _plan(self) -> LoopNest:
        spec, loops = self.spec, self.loops
        # Every letter used must correspond to a declared loop; every declared
        # loop must appear at least once (paper requires full traversal).
        for i, o in enumerate(spec.occurrences):
            if o.loop_index >= len(loops):
                raise LegalityError(
                    f"{spec.raw!r}: letter {o.letter!r} (occurrence {i}) has "
                    f"no declared loop — only {len(loops)} loops declared "
                    f"(letters {self.letters[:len(loops)]})",
                    code="TPP107",
                )
        missing = [
            l for i, l in enumerate(self.letters)
            if not spec.occurrences_of(l)
        ]
        if missing:
            raise LegalityError(
                f"{spec.raw!r}: loops {missing} never appear — the paper "
                "requires full traversal; add each declared letter to the "
                "spec string at least once",
                code="TPP107",
            )

        # Assign steps per occurrence of each letter (outer→inner).
        occ_count = {l: len(spec.occurrences_of(l)) for l in self.letters}
        steps: dict[str, tuple[int, ...]] = {}
        for i, letter in enumerate(self.letters):
            loop = loops[i]
            try:
                s = loop.steps_for(occ_count[letter])
            except LegalityError as e:
                raise LegalityError(f"{spec.raw!r}: {e}", code=e.code) from e
            # Perfect-nesting legality (paper POC): each outer step must be a
            # multiple of the next inner one, and the extent a multiple of the
            # outermost step.
            for outer, inner in zip(s, s[1:]):
                if outer % inner != 0:
                    raise LegalityError(
                        f"{spec.raw!r}: loop {letter!r} has imperfect "
                        f"blocking {outer} % {inner} != 0 — pick block "
                        "steps where each outer step is a multiple of the "
                        "next inner one",
                        code="TPP108",
                    )
            if loop.extent % s[0] != 0:
                raise LegalityError(
                    f"{spec.raw!r}: loop {letter!r} extent {loop.extent} not "
                    f"divisible by outermost step {s[0]} — choose a "
                    "divisor of the extent",
                    code="TPP108",
                )
            steps[letter] = s

        # Build levels in occurrence (nesting) order.
        depth_seen: dict[str, int] = {l: 0 for l in self.letters}
        levels: list[Level] = []
        for o in spec.occurrences:
            letter = o.letter
            d = depth_seen[letter]
            depth_seen[letter] += 1
            loop = loops[o.loop_index]
            step = steps[letter][d]
            span = loop.extent if d == 0 else steps[letter][d - 1]
            if o.ways is not None:
                trip = span // step
                if trip % o.ways != 0:
                    raise LegalityError(
                        f"{spec.raw!r}: {letter!r} level {d} trip {trip} not "
                        f"divisible by {o.ways} ways over axis {o.mesh_axis!r}"
                        " — pick a ways count dividing the trip, or change "
                        "the blocking",
                        code="TPP108",
                    )
            levels.append(
                Level(
                    letter=letter,
                    loop_index=o.loop_index,
                    depth_in_loop=d,
                    span=span,
                    step=step,
                    parallel=o.parallel,
                    mesh_axis=o.mesh_axis,
                    ways=o.ways,
                    barrier_after=o.barrier_after,
                    is_innermost_of_loop=(d == occ_count[letter] - 1),
                )
            )
        # Write-footprint race analysis: a parallel or mesh-sharded level
        # must index the output's write footprint.  ``allow_races=True``
        # keeps the analysis and demotes its findings to AnalysisWarning.
        footprint.enforce(
            footprint.check_nest(
                levels, spec_raw=spec.raw, letters=self.letters,
                reduction_letters=self.reduction_letters),
            exc=LegalityError, downgrade_errors=self.allow_races,
        )
        return LoopNest(
            spec=spec, loops=loops, levels=tuple(levels), letters=self.letters
        )

    # Convenience passthroughs -----------------------------------------
    @property
    def grid(self) -> tuple[int, ...]:
        return self.nest.grid

    def describe(self) -> str:
        return self.nest.describe()

    def __call__(self, body, init_func=None, term_func=None, **kw):
        """Paper's call syntax: run the nest over ``body(ind, carry)`` through
        the executor."""
        return executor.run_nest(
            self.nest, body, init_func=init_func, term_func=term_func, **kw
        )
