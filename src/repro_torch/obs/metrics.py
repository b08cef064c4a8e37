"""Metrics registry: counters, gauges and histograms, copied from
``repro/obs/metrics.py``.

:class:`Registry` holds real instruments behind a lock;
:class:`NullRegistry` hands out one shared no-op instrument, which is what
an engine gets when observability is disabled (``REPRO_OBS=0``).  Each :class:`~repro_torch.serve.engine.Engine` owns its
registry, so two engines in one process never mix counts.  The metric names
are those of the reference's catalog (``serve.*``, and ``fusion.*`` and
``tune.*`` in the process-global :func:`default_registry` that the fusion
compiler, the tuner and the tune cache write).
"""
from __future__ import annotations

import math
import threading
from typing import Optional

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "NullRegistry",
           "NULL_REGISTRY", "default_registry", "set_default_registry"]


# -- instruments ------------------------------------------------------------

class Counter:
    """Monotone accumulator.  ``inc`` is the whole API."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value (queue depth, pool occupancy)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Streaming histogram over fixed bucket upper bounds (seconds-scale
    defaults suit latency).  Keeps count/sum/min/max plus per-bucket counts,
    without storing observations."""

    __slots__ = ("name", "bounds", "_counts", "_n", "_sum", "_min", "_max",
                 "_lock")

    DEFAULT_BOUNDS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0,
                      3.0, 10.0)

    def __init__(self, name: str, bounds: Optional[tuple] = None):
        self.name = name
        self.bounds = tuple(bounds) if bounds is not None else \
            self.DEFAULT_BOUNDS
        self._counts = [0] * (len(self.bounds) + 1)   # + overflow bucket
        self._n = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for b in self.bounds:
            if v <= b:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._n += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    def quantile(self, q: float) -> float:
        """Bucket-boundary quantile estimate (exact only at boundaries)."""
        if not self._n:
            return 0.0
        rank = q * self._n
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= rank and c:
                return self.bounds[i] if i < len(self.bounds) else self._max
        return self._max

    def summary(self) -> dict:
        return {
            "count": self._n,
            "sum": self._sum,
            "min": self._min if self._n else None,
            "max": self._max if self._n else None,
            "mean": (self._sum / self._n) if self._n else None,
            "p50": self.quantile(0.5),
            "p99": self.quantile(0.99),
            "bounds": list(self.bounds),
            "bucket_counts": list(self._counts),
        }


# -- registries -------------------------------------------------------------

class Registry:
    """Get-or-create instrument store.  Asking twice for one name returns the
    same object; asking for one name as two different kinds raises."""

    def __init__(self):
        self._instruments: dict[str, object] = {}
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return True

    def _get(self, name: str, cls, *args):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, *args)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, bounds: Optional[tuple] = None) -> Histogram:
        return self._get(name, Histogram, bounds)

    def snapshot(self) -> dict:
        """JSON-serializable {name: value-or-summary}: counters → int,
        gauges → float, histograms → summary dict."""
        out = {}
        with self._lock:
            items = list(self._instruments.items())
        for name, inst in items:
            if isinstance(inst, (Counter, Gauge)):
                out[name] = inst.value
            else:
                out[name] = inst.summary()
        return out


class _NullInstrument:
    """One object, every instrument kind, every method a no-op."""

    __slots__ = ()
    name = "<null>"
    value = 0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry:
    """The disabled backend: hands out the shared no-op instrument."""

    @property
    def enabled(self) -> bool:
        return False

    def snapshot(self) -> dict:
        return {}

    def counter(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str,
                  bounds: Optional[tuple] = None) -> _NullInstrument:
        return _NULL_INSTRUMENT


NULL_REGISTRY = NullRegistry()

_default_lock = threading.Lock()
_default: "Registry | NullRegistry | None" = None


def default_registry():
    """The process-global registry: a real :class:`Registry` when
    observability is enabled, :data:`NULL_REGISTRY` otherwise.  Publishers
    without an owner (the fusion compiler) write here."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                from repro_torch.obs import enabled
                _default = Registry() if enabled() else NULL_REGISTRY
    return _default


def set_default_registry(registry) -> "Registry | NullRegistry | None":
    """Swap the process-global registry (a fresh one isolates counts);
    returns the previous one, None if none had been made."""
    global _default
    with _default_lock:
        prev = _default
        _default = registry
    return prev
