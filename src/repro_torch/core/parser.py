"""loop_spec_string parser: the PARLOOPER schedule grammar (paper §II-B).

A copy of ``repro/core/parser.py``, which the port may not import.  The
grammar is the same:

    spec        := occurrences ('@' directives)?
    occurrences := (occurrence | '|')*
    occurrence  := LETTER decomposition?
    decomposition := '{' NAME ':' INT '}'
    LETTER      := [a-zA-Z]        # uppercase: parallelize at this nesting level
    directives  := free-form, comma/space separated (e.g. "schedule(dynamic,1)")

  * RULE 1: character order = loop nesting order (outer to inner); a
    repeated character = multi-level blocking (k occurrences: blocked k-1
    times).
  * RULE 2: uppercase = parallelize this occurrence.  ``{name:N}`` (PAR-MODE
    2) splits the occurrence N ways over a named mesh axis; the port plans
    such a level but runs none yet (one card; ROADMAP.md, Queue 1 item 12).
  * ``|`` asks for a barrier after the loop level it follows.
  * ``@`` directives are kept; ``schedule(dynamic...)`` is recorded and has
    no effect.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

__all__ = [
    "Occurrence",
    "ParsedSpec",
    "SpecSyntaxError",
    "parse_spec_string",
]


class SpecSyntaxError(ValueError):
    """Raised when a loop_spec_string is syntactically malformed."""


@dataclasses.dataclass(frozen=True)
class Occurrence:
    """One character of the loop part of a spec string."""

    letter: str               # lowercase canonical letter ('a'..'z')
    parallel: bool            # True when the character was uppercase
    mesh_axis: Optional[str]  # '{name:N}' decomposition axis name, if any
    ways: Optional[int]       # N of '{name:N}', if any
    barrier_after: bool       # a '|' directly followed this occurrence
    position: int             # index among occurrences (nesting depth order)

    @property
    def loop_index(self) -> int:
        return ord(self.letter) - ord("a")


@dataclasses.dataclass(frozen=True)
class ParsedSpec:
    raw: str
    occurrences: tuple[Occurrence, ...]
    directives: tuple[str, ...]

    def occurrences_of(self, letter: str) -> tuple[Occurrence, ...]:
        letter = letter.lower()
        return tuple(o for o in self.occurrences if o.letter == letter)

    @property
    def letters(self) -> tuple[str, ...]:
        """Distinct letters in first-appearance order."""
        seen: list[str] = []
        for o in self.occurrences:
            if o.letter not in seen:
                seen.append(o.letter)
        return tuple(seen)

    @property
    def mesh_axes(self) -> tuple[str, ...]:
        seen: list[str] = []
        for o in self.occurrences:
            if o.mesh_axis is not None and o.mesh_axis not in seen:
                seen.append(o.mesh_axis)
        return tuple(seen)

    def has_directive(self, name: str) -> bool:
        return any(d.split("(")[0].strip() == name for d in self.directives)


_DECOMP_RE = re.compile(r"\{\s*([A-Za-z_][A-Za-z0-9_]*)\s*:\s*(\d+)\s*\}")


def parse_spec_string(spec: str) -> ParsedSpec:
    """Parse a loop_spec_string into an ordered occurrence list + directives."""
    if not isinstance(spec, str):
        raise SpecSyntaxError(f"loop_spec_string must be str, got {type(spec)}")
    raw = spec
    # Split off '@' directives (paper: special character '@' as separator).
    if "@" in spec:
        loop_part, _, directive_part = spec.partition("@")
        directives = tuple(
            d.strip() for d in re.split(r"[;,]", directive_part) if d.strip()
        )
    else:
        loop_part, directives = spec, ()

    occurrences: list[Occurrence] = []
    i = 0
    pos = 0
    loop_part = loop_part.strip()
    while i < len(loop_part):
        ch = loop_part[i]
        if ch.isspace():
            i += 1
            continue
        if ch == "|":
            if not occurrences:
                raise SpecSyntaxError(f"{raw!r}: barrier '|' before any loop")
            last = occurrences[-1]
            occurrences[-1] = dataclasses.replace(last, barrier_after=True)
            i += 1
            continue
        if not ch.isalpha():
            raise SpecSyntaxError(f"{raw!r}: unexpected character {ch!r} at {i}")
        parallel = ch.isupper()
        letter = ch.lower()
        mesh_axis, ways = None, None
        i += 1
        if i < len(loop_part) and loop_part[i] == "{":
            m = _DECOMP_RE.match(loop_part, i)
            if not m:
                raise SpecSyntaxError(f"{raw!r}: malformed decomposition at {i}")
            mesh_axis, ways = m.group(1), int(m.group(2))
            parallel = True  # an explicit decomposition implies parallelization
            i = m.end()
        occurrences.append(
            Occurrence(
                letter=letter,
                parallel=parallel,
                mesh_axis=mesh_axis,
                ways=ways,
                barrier_after=False,
                position=pos,
            )
        )
        pos += 1
    if not occurrences:
        raise SpecSyntaxError(f"{raw!r}: no loops declared")
    return ParsedSpec(raw=raw, occurrences=tuple(occurrences), directives=directives)
