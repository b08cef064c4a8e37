"""``repro_torch.analysis``: the schedule verifier's nest and graph passes.

:mod:`~repro_torch.analysis.footprint` checks a planned loop nest, and a
fused graph's nest, for write races and band order (``TPP1xx``);
:mod:`~repro_torch.analysis.diagnostics` holds the codes.
``ThreadedLoop._plan``, ``cuda_lowering.validate_reduction_innermost`` and
``fusion.lowering.plan_graph`` consult them, so an illegal spec string
raises the reference's coded diagnostic.  The invariance and lint passes of
``repro/analysis`` are ROADMAP.md, Queue 1 item 11.
"""
from repro_torch.analysis.diagnostics import (AnalysisWarning, CATALOG, Diagnostic,
                                              diag, enforce)
from repro_torch.analysis import footprint

__all__ = ["AnalysisWarning", "CATALOG", "Diagnostic", "diag", "enforce", "footprint"]
