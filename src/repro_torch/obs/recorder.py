"""A copy of ``repro/obs/recorder.py``.

Engine flight recorder: a bounded ring buffer of recent step records,
dumped automatically when something goes wrong.

Every ``Engine.step`` appends one record — the step's scheduler decisions
(admissions, preemptions, page grows, retirements, quarantines, injected
faults), the per-slot states after the step, and the queue/pool gauges.
The buffer is bounded (``capacity`` records), so a long-serving engine keeps
only the recent past — exactly the part a postmortem needs.

Dump triggers (wired in ``serve.engine``):

* ``EngineDrainError`` — ``run()`` hit ``max_steps``; the dump rides the
  exception as ``.flight``;
* ``Engine.validate()`` failure — the invariant that broke plus the steps
  that led to it;
* NaN quarantine — a request's logits went non-finite.

``dump_on_fault`` keeps the dump in memory (``last_dump``, which the chaos
tests assert on) and logs it.  The reference's dump files
(``REPRO_OBS_DUMP_DIR``) and ``replay()`` are ported with the report CLI
(ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import logging
import time
from collections import deque
from typing import Optional

__all__ = ["FlightRecorder"]

_LOG = logging.getLogger("repro_torch.obs")


class FlightRecorder:
    """Bounded ring of per-step engine records + fault-dump bookkeeping."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError("flight recorder needs capacity >= 1")
        self.capacity = capacity
        self._buf: deque[dict] = deque(maxlen=capacity)
        self.steps_recorded = 0
        self.last_dump: Optional[dict] = None

    def record(self, **fields) -> None:
        """Append one step record (plain JSON-able values only)."""
        self._buf.append(fields)
        self.steps_recorded += 1

    def records(self) -> list[dict]:
        """Oldest-first view of the retained window."""
        return list(self._buf)

    # -- fault dumps ---------------------------------------------------------

    def dump_on_fault(self, reason: str, **context) -> dict:
        """Snapshot the ring into a dump, kept on ``last_dump`` and
        logged."""
        dump = {
            "reason": reason,
            "context": context,
            "captured_at": time.time(),
            "steps_recorded": self.steps_recorded,
            "records": self.records(),
        }
        self.last_dump = dump
        _LOG.warning(
            "flight recorder: dumping last %d step records on fault %r",
            len(dump["records"]), reason)
        return dump
