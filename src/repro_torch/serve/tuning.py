"""Prefill-vs-decode schedule split: tune each serving phase as its own
shape.  A port of ``repro/serve/tuning.py``.

Serving runs the same fused layer graphs at two opposite operating points:
prefill streams a whole prompt bucket through each layer (M = bucket
tokens, compute-bound), while decode pushes one token per slot (M =
num_slots, bandwidth-bound).  A schedule tuned for one regime is routinely
bad for the other, so both shapes are registered with
:func:`repro_torch.fusion.cost.autotune_graph`; the tune cache keys on
``(graph signature, m, k, n)``, so the two phases' ranked schedules coexist
and a later tune at either shape finds its own winner
(``fusion.schedule_kwargs`` turns one into K5's schedule).

``tune_serving_shapes`` warms the cache for a model config's fused graphs
(QKV projection, attention output, MLP) at the engine's decode shape and
each prefill bucket, and returns the per-phase winners.  It scores against
``target`` (the card's by default) at ``dtype`` (default float32, the
reference's).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import perf_model
from repro_torch.fusion.cost import autotune_graph
from repro_torch.fusion.library import (fused_attn_out_graph, fused_gated_mlp_graph,
                                        fused_mlp_graph, fused_qkv_graph)

__all__ = ["serving_graph_shapes", "tune_serving_shapes"]


def serving_graph_shapes(cfg: ModelConfig) -> list[tuple[str, object, int, int]]:
    """The (name, graph, K, N) fused-layer GEMMs a decoder layer runs —
    the M dimension is supplied per phase."""
    d = cfg.d_model
    qn = cfg.num_heads * cfg.head_dim
    shapes = [
        ("qkv", fused_qkv_graph(), d, qn),
        ("attn_out", fused_attn_out_graph(), qn, d),
    ]
    if cfg.d_ff > 0:
        if cfg.gated_mlp:
            shapes.append(("gated_mlp",
                           fused_gated_mlp_graph(cfg.mlp_activation),
                           d, cfg.d_ff))
        else:
            shapes.append(("mlp", fused_mlp_graph(cfg.mlp_activation),
                           d, cfg.d_ff))
    return shapes


def tune_serving_shapes(cfg: ModelConfig, *, num_slots: int,
                        prefill_buckets: Sequence[int] = (64, 256),
                        max_candidates: Optional[int] = 64,
                        cache=None, cache_dir=None, dtype=torch.float32,
                        target=perf_model.H100Target()) -> dict:
    """Warm the tune cache for both serving phases and report the winners.

    Returns ``{phase: [{graph, m, k, n, spec, cost}]}`` where phase is
    ``"decode"`` or ``"prefill@<bucket>"``; entries land in the persistent
    tune cache so later tunes at those shapes reuse them."""
    phases = [("decode", num_slots)]
    phases += [(f"prefill@{b}", int(b)) for b in prefill_buckets]
    report: dict[str, list] = {}
    for phase, m in phases:
        rows = []
        for name, graph, k, n in serving_graph_shapes(cfg):
            results = autotune_graph(graph, m, k, n, dtype=dtype, target=target,
                                     max_candidates=max_candidates,
                                     cache=cache, cache_dir=cache_dir)
            best = results[0]
            rows.append({
                "graph": name, "m": m, "k": k, "n": n,
                "spec": best.candidate.spec_string,
                "cost": float(best.report.total_time),
            })
        report[phase] = rows
    return report
