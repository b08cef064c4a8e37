"""Runtime observability for the serving engine: the subset of
``repro/obs`` that ``serve.engine`` uses.

``metrics`` (counters, gauges, histograms), ``trace`` (spans and instant
events) and ``recorder`` (the flight recorder).  The kill switch is the same
``REPRO_OBS`` environment variable: unset or truthy → enabled;
``0``/``off``/``no``/``false`` → the default tracer and the engine's registry
are no-op null backends.  The flight recorder is not gated.  The Chrome-trace
export, the report CLI and the kernel profiler are ported later (ROADMAP.md,
Queue 1).
"""
from __future__ import annotations

import os

from repro_torch.obs import metrics, recorder, trace
from repro_torch.obs.metrics import NULL_REGISTRY, Registry
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.trace import NULL_TRACER, Tracer, get_tracer

__all__ = ["enabled", "metrics", "trace", "recorder", "Registry",
           "NULL_REGISTRY", "Tracer", "NULL_TRACER", "get_tracer",
           "FlightRecorder"]

_DISABLE_VALUES = ("0", "off", "no", "false")


def enabled() -> bool:
    """Observability master switch (``REPRO_OBS``)."""
    return os.environ.get("REPRO_OBS", "1").strip().lower() \
        not in _DISABLE_VALUES
