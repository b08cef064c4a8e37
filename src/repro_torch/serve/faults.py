"""A copy of ``repro/serve/faults.py``.

Deterministic fault injection for the serving engine.

A :class:`FaultPlan` is a *seeded, precomputed* schedule of faults the
engine consults at fixed points in ``Engine.step``; the default
:data:`NO_FAULTS` plan is a true no-op (every query returns "no fault" and
the poison sentinel never matches a uid), so production engines pay nothing
for the hooks.  Because the plan is data — not callbacks racing a clock —
a chaos run is exactly reproducible from its seed, which is what lets the
chaos tests assert bit-level properties (unaffected requests match a
fault-free run; a preempted request resumes bit-identically).

Fault classes:

* **allocator exhaustion** (``exhaust_steps``) — for the listed engine
  steps, admission is skipped and page growth is denied, as if the free
  list were empty.  Exercises optimistic admission's preemption path.
* **NaN-poisoned logits** (``poison_uid``/``poison_pos``) — inside the
  prefill/decode, the logits row of ``poison_uid`` is overwritten
  with NaN once its sampling position reaches ``poison_pos`` (``>=`` so a
  preempted victim cannot dodge the fault by resuming past it).  The
  engine's always-on finite-logits guard must quarantine exactly that
  request (→ ``FAILED``) while the batch keeps decoding.
* **forced preemption** (``preempt_steps``) — the youngest running request
  is preempted at the start of the listed steps regardless of memory
  pressure.  Exercises requeue + bit-identical resume.
* **latency spikes** (``delays``) — seconds of virtual clock skew added at
  the listed steps.  The engine folds skew into its notion of "now", so
  deadline expiry (TTFT and total) is testable without real sleeps.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

__all__ = ["FaultPlan", "NO_FAULTS", "POISON_OFF"]

# uint32 sentinel no real uid reaches (Engine.submit caps auto-uids well
# below it); with poison_uid == POISON_OFF the in-kernel poison predicate
# is all-False and `where(hit, nan, logits)` is a bitwise identity.
POISON_OFF = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Precomputed fault schedule.  Step indices refer to the engine's
    monotone ``step()`` counter (first call is step 0)."""
    exhaust_steps: frozenset[int] = frozenset()
    preempt_steps: frozenset[int] = frozenset()
    poison_uid: int = POISON_OFF
    poison_pos: int = 0
    delays: Mapping[int, float] = dataclasses.field(default_factory=dict)

    # -- queries (the engine's only interface) ------------------------------

    def allocator_exhausted(self, step: int) -> bool:
        return step in self.exhaust_steps

    def force_preempt(self, step: int) -> bool:
        return step in self.preempt_steps

    def clock_skew(self, step: int) -> float:
        return self.delays.get(step, 0.0)

    @property
    def active(self) -> bool:
        return bool(self.exhaust_steps or self.preempt_steps or self.delays
                    or self.poison_uid != POISON_OFF)

    # -- construction -------------------------------------------------------

    @staticmethod
    def random(seed: int, num_steps: int, *,
               p_exhaust: float = 0.0,
               p_preempt: float = 0.0,
               p_delay: float = 0.0,
               delay_s: float = 1.0,
               poison: "tuple[int, int] | None" = None) -> "FaultPlan":
        """Seeded random plan over the first ``num_steps`` engine steps
        (later steps are fault-free, so a bounded plan always lets the
        engine drain).  ``poison`` is an explicit ``(uid, position)`` pair —
        choosing a position the request actually samples is the caller's
        job, since the plan cannot know prompt lengths."""
        rng = np.random.default_rng(seed)
        draws = rng.random((num_steps, 3))
        exhaust = frozenset(np.flatnonzero(draws[:, 0] < p_exhaust).tolist())
        preempt = frozenset(np.flatnonzero(draws[:, 1] < p_preempt).tolist())
        delays = {int(s): float(delay_s)
                  for s in np.flatnonzero(draws[:, 2] < p_delay)}
        uid, pos = poison if poison is not None else (POISON_OFF, 0)
        return FaultPlan(exhaust_steps=exhaust, preempt_steps=preempt,
                         poison_uid=uid, poison_pos=pos, delays=delays)


NO_FAULTS = FaultPlan()
