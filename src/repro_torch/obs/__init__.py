"""Runtime observability, ported from ``repro/obs``.

``metrics`` (counters, gauges, histograms), ``trace`` (spans and instant
events), ``recorder`` (the flight recorder), ``profiler`` (warmup + median
kernel timing — CUDA events on the card — beside ``perf_model``
predictions) and ``report`` (the attribution-table CLI: ``python -m
repro_torch.obs.report``).  The kill switch is the same ``REPRO_OBS``
environment variable: unset or truthy → enabled; ``0``/``off``/``no``/
``false`` → the default tracer and the engine's registry are no-op null
backends.  The flight recorder is not gated.  ``profiler`` imports the
fusion stack and is loaded lazily, so that ``core`` and ``serve`` modules
can import ``repro_torch.obs`` without a cycle.  The Chrome-trace export is
not ported yet.
"""
from __future__ import annotations

import os

from repro_torch.obs import metrics, recorder, trace
from repro_torch.obs.metrics import NULL_REGISTRY, Registry
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.trace import NULL_TRACER, Tracer, get_tracer

__all__ = ["enabled", "metrics", "trace", "recorder", "Registry",
           "NULL_REGISTRY", "Tracer", "NULL_TRACER", "get_tracer",
           "FlightRecorder", "profiler"]

_DISABLE_VALUES = ("0", "off", "no", "false")


def enabled() -> bool:
    """Observability master switch (``REPRO_OBS``)."""
    return os.environ.get("REPRO_OBS", "1").strip().lower() \
        not in _DISABLE_VALUES


def __getattr__(name):
    # lazy: profiler imports repro_torch.fusion, which (via core.tunecache)
    # imports repro_torch.obs.metrics — an eager import here would be a cycle
    if name == "profiler":
        import importlib

        module = importlib.import_module("repro_torch.obs.profiler")
        globals()["profiler"] = module
        return module
    raise AttributeError(f"module 'repro_torch.obs' has no attribute {name!r}")
