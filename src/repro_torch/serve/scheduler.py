"""A copy of ``repro/serve/scheduler.py``.

Continuous-batching scheduler: FIFO admission into decode slots.

The engine runs a fixed number of decode *slots* (the decode batch
dimension).  Requests queue in arrival order; whenever slots free up —
at startup, or when a running request finishes mid-flight — the scheduler
admits waiting requests into the freed slots, so the batch is continuously
refilled instead of draining to a convoy of stragglers.

Admission is strict FIFO with head-of-line blocking: if the oldest waiting
request does not fit (no free slot, or the page pool cannot cover its
reservation), nothing behind it is admitted either — admission order is
always submission order, so no starvation (every request is eventually
the head).

Two admission modes govern the reservation size:

* ``"reserve"`` (default) — all-or-nothing worst case,
  ``ceil((prompt + max_new) / page_size)`` pages up front.  An admitted
  request can never hit a mid-flight out-of-pages condition; preemption
  never happens.
* ``"optimistic"`` — reserve only ``ceil(prompt / page_size) + 1`` pages.
  More requests fit concurrently; the engine grows each slot's pages at
  decode-segment boundaries and, when the pool runs dry, **preempts** the
  youngest-admitted running request (release pages, requeue at the queue
  head with its generated prefix folded into the prompt; counter-based
  sampling keyed on (seed, uid, position) makes the resume bit-identical).
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Optional

from repro_torch.serve.kvcache import PagedKvCache, pages_needed

__all__ = ["Request", "RequestStatus", "Scheduler"]


class RequestStatus(enum.Enum):
    """Per-request lifecycle.  ``FINISHED``/``CANCELLED``/``TIMED_OUT``/
    ``FAILED`` are terminal; ``PREEMPTED`` means the request was evicted
    under memory pressure and is back in the queue (→ ``RUNNING`` again on
    re-admission, resuming bit-identically)."""
    WAITING = "waiting"
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    TIMED_OUT = "timed_out"
    FAILED = "failed"

    @property
    def terminal(self) -> bool:
        return self in (RequestStatus.FINISHED, RequestStatus.CANCELLED,
                        RequestStatus.TIMED_OUT, RequestStatus.FAILED)


@dataclasses.dataclass
class Request:
    """One generation request (host-side).  ``uid`` keys the sampler's
    counter stream, so it must be unique per request within a seed."""
    uid: int
    prompt: list[int]
    max_new: int
    temperature: float = 0.0     # <= 0 → greedy
    top_k: int = 0               # 0 → off
    top_p: float = 1.0           # >= 1 → off

    def __post_init__(self):
        if len(self.prompt) < 1:
            raise ValueError("empty prompt")
        if self.max_new < 1:
            raise ValueError("max_new must be >= 1")

    @property
    def max_tokens(self) -> int:
        return len(self.prompt) + self.max_new


class Scheduler:
    """Admission queue + slot occupancy tracking over a ``PagedKvCache``."""

    def __init__(self, num_slots: int, kv: PagedKvCache,
                 mode: str = "reserve"):
        if mode not in ("reserve", "optimistic"):
            raise ValueError(f"unknown admission mode {mode!r} "
                             "(want 'reserve' or 'optimistic')")
        self.num_slots = num_slots
        self.kv = kv
        self.mode = mode
        self.waiting: deque[Request] = deque()
        self.running: dict[int, Request] = {}   # slot → request
        # Admission recency: slot → monotone counter, so preemption can pick
        # the *youngest* running request deterministically.
        self.admitted_seq: dict[int, int] = {}
        self._seq = 0

    # -- queue --------------------------------------------------------------

    def submit(self, req: Request) -> None:
        if req.max_tokens > self.kv.max_pages_per_slot * self.kv.page_size:
            raise ValueError(
                f"request {req.uid} needs {req.max_tokens} tokens > slot "
                f"capacity {self.kv.max_pages_per_slot * self.kv.page_size}")
        self.waiting.append(req)

    def requeue_front(self, req: Request) -> None:
        """Put a preempted request back at the head of the line so it is
        re-admitted before anything younger."""
        self.waiting.appendleft(req)

    def remove_waiting(self, uid: int) -> Optional[Request]:
        """Drop a queued request (cancel/timeout).  Returns it, or None if
        no waiting request carries ``uid``."""
        for i, req in enumerate(self.waiting):
            if req.uid == uid:
                del self.waiting[i]
                return req
        return None

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def free_slots(self) -> list[int]:
        return [s for s in range(self.num_slots) if s not in self.running]

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.running

    # -- admission / retirement --------------------------------------------

    def required_pages(self, req: Request) -> int:
        """Pages the current mode reserves at admission: the full worst case
        under ``reserve``; prompt coverage plus one decode page under
        ``optimistic`` (never more than the worst case)."""
        full = pages_needed(req.max_tokens, self.kv.page_size)
        if self.mode == "reserve":
            return full
        return min(full, pages_needed(len(req.prompt),
                                      self.kv.page_size) + 1)

    def admit(self) -> list[tuple[int, Request]]:
        """Admit waiting requests (FIFO, head-of-line blocking) into free
        slots, reserving the current mode's page budget.  Returns the
        (slot, request) pairs admitted this call."""
        admitted = []
        free = self.free_slots
        while self.waiting and free:
            req = self.waiting[0]
            n = self.required_pages(req)
            if n > self.kv.max_pages_per_slot or n > self.kv.free_pages:
                break                     # head blocks the line
            slot = free.pop(0)
            self.kv.allocate_pages(slot, n)
            self.running[slot] = req
            self.admitted_seq[slot] = self._seq
            self._seq += 1
            self.waiting.popleft()
            admitted.append((slot, req))
        return admitted

    def retire(self, slot: int) -> Request:
        """Free a finished request's slot and pages."""
        req = self.running.pop(slot)
        self.admitted_seq.pop(slot, None)
        self.kv.release(slot)
        return req

    def preempt(self, slot: int) -> Request:
        """Release a running request's slot and pages *without* finishing
        it — the engine requeues it for a bit-identical resume later.
        (Same bookkeeping as retire; the distinct name marks intent at call
        sites and in tracebacks.)"""
        return self.retire(slot)

    def youngest_running(self) -> Optional[int]:
        """Slot of the most recently admitted running request — the
        deterministic preemption victim — or None if nothing is running."""
        if not self.running:
            return None
        return max(self.running, key=self.admitted_seq.__getitem__)

    def check_invariants(self) -> None:
        self.kv.check_invariants()
        assert len(self.running) <= self.num_slots
        assert set(self.admitted_seq) == set(self.running), \
            "admission-order tracking out of sync with running set"
        for slot in self.running:
            assert 0 <= slot < self.num_slots
            assert self.kv.slot_pages(slot), \
                f"running slot {slot} holds no pages"
        for slot in self.free_slots:
            assert not self.kv.slot_pages(slot), \
                f"free slot {slot} still holds pages"
