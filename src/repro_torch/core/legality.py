"""``LegalityError``: the base of the port's diagnostics with a stable code.

Counterpart of ``repro/core/loops.py::LegalityError``.  The loop nest
(``core/loops.py``, which re-exports it), the executor and the CUDA plans
raise it; ``fusion.graph.FusionLegalityError`` derives from it.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["LegalityError"]


class LegalityError(ValueError):
    """Raised when a schedule or graph is well formed but illegal.  Every
    raise carries a stable diagnostic ``code`` (``TPP000`` = unclassified),
    the codes of the reference's catalog (``repro/analysis/diagnostics.py``),
    so tests pin the finding, not the message."""

    code = "TPP000"

    def __init__(self, *args, code: Optional[str] = None):
        super().__init__(*args)
        if code is not None:
            self.code = code
