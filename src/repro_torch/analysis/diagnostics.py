"""Diagnostic codes of the schedule verifier (``TPP1xx``).

The part of ``repro/analysis/diagnostics.py`` that the loop nest needs:
:class:`Diagnostic`, :class:`AnalysisWarning`, :func:`diag`, :func:`enforce`
and the ``TPP1xx`` entries of the catalog, under the reference's names and
severities.  A code reaches the user as the ``.code`` of a raised
``LegalityError``, or as an :class:`AnalysisWarning` when the caller
demoted the finding (``ThreadedLoop(allow_races=True)``).  The ``TPP2xx``
entries (graph structure) live in ``fusion/graph.py``'s raises; the
``TPP3xx`` ones wait for the invariance passes (ROADMAP.md, Queue 1 item
11).
"""
from __future__ import annotations

import dataclasses
import warnings

__all__ = ["Diagnostic", "AnalysisWarning", "CATALOG", "diag", "enforce"]


class AnalysisWarning(UserWarning):
    """A verifier finding demoted to a warning (e.g. ``allow_races=True``)."""


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding of a static analysis pass."""

    code: str        # stable identifier, e.g. "TPP101"
    name: str        # kebab-case label, e.g. "racy-parallel-reduction"
    severity: str    # "error" | "warning"
    message: str     # human explanation, incl. offending spec / site detail
    site: str = ""   # location: spec string, graph:node, module attribute

    def render(self) -> str:
        loc = f" [{self.site}]" if self.site else ""
        return f"{self.code} {self.name}{loc}: {self.message}"


# code -> (name, default severity, one-line doc), as in the reference.
CATALOG: dict[str, tuple[str, str, str]] = {
    "TPP101": ("racy-parallel-reduction", "error",
               "a parallel-marked loop level does not index the output "
               "write footprint, so concurrent iterations write the same "
               "blocks"),
    "TPP102": ("reduction-outside-innermost-band", "error",
               "a reduction loop level sits above an output-indexing level; "
               "output-block revisits would not be consecutive (undefined "
               "on the Pallas TPU grid)"),
    "TPP103": ("epilogue-band-order", "error",
               "a reducing epilogue needs every N level inside the deepest "
               "M level so the row panel is complete when the row closes"),
    "TPP104": ("racy-parallel-statistics", "error",
               "the N loop carries PARALLEL semantics but the reducing "
               "epilogue's row panel / (sum, sum-sq) strip is indexed by M "
               "only — concurrent N iterations race on the strip"),
    "TPP105": ("sharded-reduction-statistics", "error",
               "N is sharded over a mesh axis under a reducing epilogue; "
               "each shard would close partial row statistics with no "
               "cross-shard combine"),
    "TPP106": ("sharded-prng-coords", "error",
               "an in-kernel PRNG epilogue keys its draw on global (M, N) "
               "coordinates, but an output loop is mesh-sharded — block "
               "coordinates are shard-local, so bits would repeat"),
    "TPP107": ("spec-structure", "error",
               "the spec string does not cover the declared logical loops "
               "(unknown letter, missing loop, or too many loops)"),
    "TPP108": ("imperfect-blocking", "error",
               "a blocking factor does not divide its parent step / extent, "
               "or the problem shape is not divisible by the tiles"),
}


def diag(code: str, message: str, *, site: str = "",
         severity: str | None = None) -> Diagnostic:
    """Build a :class:`Diagnostic` for a catalogued code."""
    name, default_sev, _doc = CATALOG[code]
    return Diagnostic(code=code, name=name, severity=severity or default_sev,
                      message=message, site=site)


def enforce(diags, *, exc=None, downgrade_errors: bool = False,
            stacklevel: int = 3) -> None:
    """Raise on the first error-severity diagnostic; warn the rest.

    ``exc`` is the exception class (default ``LegalityError``; it must take
    a ``code=`` keyword).  With ``downgrade_errors=True`` (the
    ``allow_races`` escape) errors are emitted as :class:`AnalysisWarning`
    instead: the analysis still runs, only the severity drops.
    """
    if exc is None:
        from repro_torch.core.legality import LegalityError
        exc = LegalityError
    first_error = None
    for d in diags:
        if d.severity == "error" and not downgrade_errors:
            if first_error is None:
                first_error = d
            continue
        warnings.warn(d.render(), AnalysisWarning, stacklevel=stacklevel)
    if first_error is not None:
        raise exc(first_error.render(), code=first_error.code)
