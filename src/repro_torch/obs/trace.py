"""Tracing spans, copied from ``repro/obs/trace.py`` without the
Chrome-trace export.

A :class:`Tracer` records nestable, thread-safe :class:`Span` s on an
injectable clock; ``Tracer.event`` marks instants (preemptions, fallbacks,
injected faults).  The engine's span names are the reference's:
``engine.step``, ``engine.prefill``, ``engine.decode_segment``, and the
events ``engine.preempt``, ``engine.fault``, ``engine.quarantine`` and
``engine.fallback_reserve``.  When observability is disabled
(``REPRO_OBS=0``) :func:`get_tracer` returns :data:`NULL_TRACER`.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Optional

__all__ = ["Span", "Tracer", "NullTracer", "NULL_TRACER", "get_tracer"]


@dataclasses.dataclass
class Span:
    """One closed (or in-flight) interval.  Times are the tracer clock's
    seconds; ``end`` is None while the span is open."""
    sid: int
    name: str
    cat: str
    start: float
    end: Optional[float] = None
    tid: int = 0
    parent: Optional[int] = None
    args: dict = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return (self.end - self.start) if self.end is not None else 0.0

    def set(self, **args) -> "Span":
        """Attach/overwrite args after opening (e.g. counts known at exit)."""
        self.args.update(args)
        return self


class _SpanHandle:
    """Context manager closing one span; proxies ``set`` for exit-time args."""

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def set(self, **args) -> "_SpanHandle":
        self.span.set(**args)
        return self

    def __enter__(self) -> "_SpanHandle":
        return self

    def __exit__(self, *exc) -> None:
        self._tracer._close(self.span)


class Tracer:
    """Thread-safe span recorder on an injectable clock.

    ``max_spans`` bounds memory: past the cap new spans are counted as
    dropped rather than recorded, so a long-lived engine cannot grow a trace
    without bound."""

    def __init__(self, clock=None, *, max_spans: int = 200_000):
        self._clock = clock if clock is not None else time.perf_counter
        self._spans: list[Span] = []
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._stack = threading.local()      # per-thread open-span stack
        self._tids: dict[int, int] = {}      # real thread ident → small tid
        self.max_spans = max_spans
        self.dropped = 0

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _parent(self) -> Optional[int]:
        stack = getattr(self._stack, "open", None)
        return stack[-1] if stack else None

    def span(self, name: str, cat: str = "engine", **args) -> _SpanHandle:
        """Open a span: ``with tracer.span("engine.step", step=3) as sp:``.
        ``sp.set(...)`` attaches exit-time args."""
        sp = Span(sid=next(self._ids), name=name, cat=cat,
                  start=self._clock(), tid=self._tid(),
                  parent=self._parent(), args=dict(args))
        stack = getattr(self._stack, "open", None)
        if stack is None:
            stack = self._stack.open = []
        stack.append(sp.sid)
        return _SpanHandle(self, sp)

    def _close(self, sp: Span) -> None:
        sp.end = self._clock()
        stack = getattr(self._stack, "open", None)
        if stack and stack[-1] == sp.sid:
            stack.pop()
        elif stack and sp.sid in stack:     # out-of-order close: still pop
            stack.remove(sp.sid)
        with self._lock:
            if len(self._spans) < self.max_spans:
                self._spans.append(sp)
            else:
                self.dropped += 1

    def event(self, name: str, cat: str = "engine", **args) -> None:
        """Record an instant (zero-duration) event."""
        t = self._clock()
        sp = Span(sid=next(self._ids), name=name, cat=cat, start=t, end=t,
                  tid=self._tid(), parent=self._parent(), args=dict(args))
        with self._lock:
            if len(self._spans) < self.max_spans:
                self._spans.append(sp)
            else:
                self.dropped += 1

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)


class _NullSpanHandle:
    """Shared no-op handle: enter/exit/set all do nothing."""

    __slots__ = ()
    span = None

    def set(self, **args) -> "_NullSpanHandle":
        return self

    def __enter__(self) -> "_NullSpanHandle":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpanHandle()


class NullTracer:
    """The disabled backend — ``span``/``event`` are allocation-free."""

    dropped = 0

    def span(self, name: str, cat: str = "engine", **args) -> _NullSpanHandle:
        return _NULL_SPAN

    def event(self, name: str, cat: str = "engine", **args) -> None:
        pass

    def spans(self) -> list:
        return []


NULL_TRACER = NullTracer()

_default_lock = threading.Lock()
_default: "Tracer | NullTracer | None" = None


def get_tracer():
    """Process-default tracer: a real :class:`Tracer` when observability is
    enabled, else :data:`NULL_TRACER`.  Engines accept an explicit
    tracer."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                from repro_torch.obs import enabled
                _default = Tracer() if enabled() else NULL_TRACER
    return _default

