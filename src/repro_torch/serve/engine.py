"""The serving engine: ``submit`` / ``step`` / ``collect``.

Ported from ``repro/serve/engine.py``, with the same public API and the
same host bookkeeping, so one sequence of calls gives the same tokens,
statuses and ``stats`` in both packages.  One ``Engine`` owns the device
state (the paged KV pools and the per-slot ``DecodeState``; params stay
caller-owned, and the engine runs on their device) and the host bookkeeping
(scheduler, page allocator, per-request outputs, statuses, latency
metrics).  A mamba layer keeps its state per slot beside the pools; a
config with no attention layers has no pools, and the page bookkeeping
runs as for any other.  Each ``step()`` is one continuous-batching
iteration:

1. **expire/faults**: deadline-expired requests time out, and the fault
   plan's scheduled faults (forced preemption, allocator exhaustion, clock
   skew) fire;
2. **admit**: waiting requests move into free slots (FIFO, page reservation
   per the admission mode), each running a batch-1 **prefill** at a
   power-of-two shape bucket (``logit_index`` reads the true last token and
   bounds the mamba layers' update, so padding never changes results) from
   zeroed mamba state in the slot's rows, and samples its first token;
3. **grow/preempt**: under optimistic admission, each running slot's pages
   are extended to cover the coming segment's writes; when the pool runs
   dry the youngest-admitted request is preempted and requeued at the head
   with its generated prefix folded into the prompt (sampling keyed on
   (seed, uid, position) makes the resume bit-identical; the re-prefill
   starts from zero mamba state, like any admission);
4. **decode**: all running slots advance together for up to
   ``segment_len`` steps; the segment ends early when a request finishes
   while others wait, so its slot refills next step;
5. **retire**: finished requests release their pages and slot.

Failures are per request: a NaN/Inf logits row quarantines that request as
``FAILED`` while the batch keeps decoding; a request whose reservation can
never fit fails instead of raising; deadlines and ``cancel(uid)`` retire
requests as ``TIMED_OUT``/``CANCELLED``.

Decode runs every slot: empty and retired slots write into the trash page,
advance their own rows of mamba state, and their sampled tokens are
discarded.  Where the reference runs a segment
as one jitted ``lax.while_loop`` over donated buffers, here the pools and
the ``DecodeState`` are updated in place and the segment is a Python loop of
up to ``segment_len`` steps.  Host reads are the reference's bookkeeping
reads: one per prefill (first token, quarantine flag), one per decode step
(the loop's exit test), one per segment (the harvest).  The reference's
``_fresh_slot_state`` and ``_merge_slot_state`` (a zeroed batch-1 copy of
the mamba state, merged back into the slot after the prefill) become
``_fresh_slot_state`` here: the slot's rows are zeroed and handed to the
prefill as views, which it updates in place.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.serve.faults import NO_FAULTS, POISON_OFF, FaultPlan
from repro_torch.serve.kvcache import PagedKvCache, pages_needed
from repro_torch.serve.sampling import sample_tokens
from repro_torch.serve.scheduler import Request, RequestStatus, Scheduler

__all__ = ["EngineConfig", "Engine", "EngineDrainError", "DecodeState"]


class EngineDrainError(RuntimeError):
    """``Engine.run`` hit ``max_steps`` before draining.  ``results`` holds
    ``{uid: tokens}`` for every request that did reach a terminal status."""

    def __init__(self, message: str, results: dict[int, list[int]]):
        super().__init__(message)
        self.results = results


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The reference's ``EngineConfig`` without ``ep_axis`` and
    ``unroll_layers``, which steer JAX sharding and ``lax.scan`` and have
    nothing to act on here."""
    num_slots: int = 8
    page_size: int = 16
    max_seq: int = 2048            # per-request prompt + generation cap
    num_pages: Optional[int] = None  # default: worst case, every slot full
    segment_len: int = 8           # decode steps per segment
    min_bucket: int = 8            # smallest prefill shape bucket
    stop_on_finish: bool = True    # end segments early to refill slots
    eos_token: Optional[int] = None
    seed: int = 0
    admission: str = "reserve"     # "reserve" | "optimistic" page grants
    thrash_preemptions: int = 4    # optimistic→reserve fallback watermark:
    thrash_window: int = 8         #   ≥ N preemptions in the last W steps

    def __post_init__(self):
        if self.admission not in ("reserve", "optimistic"):
            raise ValueError(f"unknown admission mode {self.admission!r} "
                             "(want 'reserve' or 'optimistic')")

    @property
    def max_pages_per_slot(self) -> int:
        return max(1, math.ceil(self.max_seq / self.page_size))

    @property
    def slot_capacity(self) -> int:
        return self.max_pages_per_slot * self.page_size


@dataclasses.dataclass
class DecodeState:
    """Per-slot device state, kept between segments on the engine's device
    and updated in place."""
    tok: torch.Tensor      # (B,) int64  last sampled token (next model input)
    pos: torch.Tensor      # (B,) int64  cache position that token occupies
    gen: torch.Tensor      # (B,) int64  tokens generated so far
    limit: torch.Tensor    # (B,) int64  max_new per request
    active: torch.Tensor   # (B,) bool
    bad: torch.Tensor      # (B,) bool   non-finite logits seen (quarantine)
    uids: torch.Tensor     # (B,) int64  sampler counter key (a uint32 word)
    temp: torch.Tensor     # (B,) fp32
    top_k: torch.Tensor    # (B,) int64
    top_p: torch.Tensor    # (B,) fp32

    @classmethod
    def empty(cls, b: int, device) -> "DecodeState":
        def z(dtype):
            return torch.zeros(b, dtype=dtype, device=device)
        return cls(tok=z(torch.int64), pos=z(torch.int64), gen=z(torch.int64),
                   limit=torch.ones(b, dtype=torch.int64, device=device),
                   active=z(torch.bool), bad=z(torch.bool), uids=z(torch.int64),
                   temp=z(torch.float32), top_k=z(torch.int64),
                   top_p=torch.ones(b, dtype=torch.float32, device=device))

    def to_host(self) -> "DecodeState":
        return DecodeState(**{f.name: getattr(self, f.name).cpu()
                              for f in dataclasses.fields(self)})


def _next_bucket(n: int, lo: int, cap: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return min(b, cap)


class Engine:
    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig, *,
                 faults: Optional[FaultPlan] = None, clock=None,
                 registry=None, tracer=None,
                 flight: Optional[FlightRecorder] = None,
                 flight_capacity: int = 256):
        if cfg.is_encdec:
            raise NotImplementedError(
                "the serving engine does not support encoder-decoder models")
        self.cfg, self.params, self.ecfg = cfg, params, ecfg
        self.device = params["embed"].device
        num_pages = (ecfg.num_pages if ecfg.num_pages is not None
                     else ecfg.num_slots * ecfg.max_pages_per_slot)
        self.kv = PagedKvCache(ecfg.num_slots, num_pages, ecfg.page_size,
                               ecfg.max_pages_per_slot)
        self.sched = Scheduler(ecfg.num_slots, self.kv, mode=ecfg.admission)
        self.caches = lm.init_paged_cache(cfg, ecfg.num_slots, num_pages,
                                          ecfg.page_size, device=self.device)
        self._faults = faults if faults is not None else NO_FAULTS
        self._clock = clock if clock is not None else time.perf_counter
        self._skew = 0.0          # virtual seconds added by fault delays
        self._step_idx = 0
        self.decode_steps = 0     # batched decode steps run (one token per slot)

        b = ecfg.num_slots
        # decode state lives on the device between segments; the host keeps
        # only the bookkeeping it needs to harvest tokens and retire slots
        self._state = DecodeState.empty(b, self.device)
        self._gen = np.zeros(b, np.int64)
        self._done = np.zeros(b, bool)
        self._uids = np.zeros(b, np.int64)
        self._prior = np.zeros(b, np.int64)  # tokens of uid before admission
        self._table_dev = self._to_device(self.kv.table())
        self._table_dirty = False

        self._out: dict[int, list[int]] = {}     # uid → generated tokens
        self._prompts: dict[int, list[int]] = {}  # uid → ORIGINAL prompt
        self._max_new: dict[int, int] = {}        # uid → original budget
        self._terminal: set[int] = set()
        self.metrics: dict[int, dict] = {}       # uid → latency + status
        self._preempt_log: list[int] = []        # step idx of preemptions
        self._fallback_step: Optional[int] = None
        self._next_uid = 0

        # -- observability: each engine owns its registry; the tracer
        # defaults to the process-wide one; the flight recorder is always on
        if registry is not None:
            self.registry = registry
        else:
            self.registry = (obs.metrics.Registry() if obs.enabled()
                             else obs.metrics.NULL_REGISTRY)
        self.tracer = tracer if tracer is not None else obs.get_tracer()
        self.flight = flight if flight is not None \
            else FlightRecorder(flight_capacity)
        reg = self.registry
        self._c_tokens = reg.counter("serve.tokens")
        self._c_preempt = reg.counter("serve.preemptions")
        self._c_grows = reg.counter("serve.page_grows")
        self._c_dumps = reg.counter("serve.flight_dumps")
        self._c_submitted = reg.counter("serve.requests.submitted")
        self._term_counters = {
            RequestStatus.FINISHED: reg.counter("serve.requests.finished"),
            RequestStatus.FAILED: reg.counter("serve.requests.failed"),
            RequestStatus.CANCELLED: reg.counter("serve.requests.cancelled"),
            RequestStatus.TIMED_OUT: reg.counter("serve.requests.timed_out"),
        }
        self._g_queue = reg.gauge("serve.queue_depth")
        self._g_slots = reg.gauge("serve.slots.active")
        self._g_pages_used = reg.gauge("serve.pages.used")
        self._g_pages_total = reg.gauge("serve.pages.total")
        self._g_pages_total.set(num_pages)
        self._h_ttft = reg.histogram("serve.ttft_s")
        self._h_tok = reg.histogram("serve.token_interval_s")
        self._h_step = reg.histogram("serve.step_s")
        self._step_events: list[tuple[str, dict]] = []
        self._tokens_harvested = 0

    # -- public API ---------------------------------------------------------

    def submit(self, prompt, max_new: int, *, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0,
               uid: Optional[int] = None,
               ttft_deadline: Optional[float] = None,
               deadline: Optional[float] = None) -> int:
        """Queue one request; returns its uid (the sampler counter key).

        ``ttft_deadline``/``deadline`` are seconds after submission by which
        the first token / the whole request must land; a request past its
        deadline is retired as ``TIMED_OUT`` at the next step boundary.
        Nothing is registered until every argument validates."""
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        uid = self._next_uid if uid is None else uid
        if uid in self.metrics:
            raise ValueError(
                f"duplicate uid {uid}: already "
                f"{self.metrics[uid]['status'].value}; uids key the "
                "sampler's counter stream and must be unique per engine")
        if not 0 <= uid < POISON_OFF:
            raise ValueError(f"uid {uid} out of range [0, {POISON_OFF})")
        req = Request(uid=uid, prompt=prompt, max_new=max_new,
                      temperature=temperature, top_k=top_k, top_p=top_p)
        if req.max_tokens > self.ecfg.max_seq:
            raise ValueError(
                f"request {uid}: prompt ({len(prompt)}) + max_new "
                f"({max_new}) = {req.max_tokens} exceeds max_seq "
                f"({self.ecfg.max_seq})")
        self.sched.submit(req)
        # -- validated: now (and only now) register the request -------------
        self._next_uid = max(self._next_uid, uid + 1)
        self._prompts[uid] = prompt
        self._max_new[uid] = max_new
        self._out[uid] = []
        self.metrics[uid] = {"submitted": self._now(),
                             "first_token": None, "finished": None,
                             "token_times": [],
                             "status": RequestStatus.WAITING,
                             "preemptions": 0,
                             "ttft_deadline": ttft_deadline,
                             "deadline": deadline}
        self._c_submitted.inc()
        self._g_queue.set(self.sched.num_waiting)
        return uid

    @property
    def stats(self) -> dict:
        """Aggregate counts read from the engine's metrics registry, plus
        the live ``waiting`` (preempted requeues included) and ``in_flight``
        (running slots).  With observability disabled (``REPRO_OBS=0``) the
        counter-backed keys read 0."""
        return {
            "preemptions": int(self._c_preempt.value),
            "page_grows": int(self._c_grows.value),
            "timeouts": int(self._term_counters[
                RequestStatus.TIMED_OUT].value),
            "failures": int(self._term_counters[RequestStatus.FAILED].value),
            "cancellations": int(self._term_counters[
                RequestStatus.CANCELLED].value),
            "fallback_to_reserve_step": self._fallback_step,
            "waiting": self.sched.num_waiting,
            "in_flight": len(self.sched.running),
        }

    @property
    def idle(self) -> bool:
        return self.sched.idle

    @property
    def tokens_generated(self) -> int:
        """Total tokens harvested across all requests so far."""
        return self._tokens_harvested

    def status(self, uid: int) -> RequestStatus:
        return self.metrics[uid]["status"]

    def cancel(self, uid: int) -> bool:
        """Abort a request from the host.  Returns True if it was alive
        (waiting or running) and is now ``CANCELLED``; False if it had
        already reached a terminal status."""
        if uid not in self.metrics:
            raise KeyError(f"unknown uid {uid}")
        if uid in self._terminal:
            return False
        if self.sched.remove_waiting(uid) is None:
            slot = next(s for s, r in self.sched.running.items()
                        if r.uid == uid)
            self._evict(slot)
        self._set_terminal(uid, RequestStatus.CANCELLED)
        return True

    def step(self) -> list[int]:
        """One continuous-batching iteration.  Returns the uids that
        reached a terminal status during this step.  Opens an
        ``engine.step`` span, updates the gauges, and appends one record to
        the flight recorder."""
        idx = self._step_idx
        t0 = self._clock()
        self._step_events = []
        with self.tracer.span("engine.step", step=idx) as sp:
            newly = self._step_inner()
            sp.set(terminal=len(newly))
        self._h_step.observe(self._clock() - t0)
        self._g_queue.set(self.sched.num_waiting)
        self._g_slots.set(len(self.sched.running))
        self._g_pages_used.set(self.kv.num_pages - self.kv.free_pages)
        self.flight.record(
            step=idx, events=self._step_events, terminal=list(newly),
            queue_depth=self.sched.num_waiting,
            running=len(self.sched.running),
            free_pages=self.kv.free_pages,
            tokens_total=self._tokens_harvested)
        return newly

    def _step_inner(self) -> list[int]:
        plan, idx = self._faults, self._step_idx
        self._step_idx += 1
        self._skew += plan.clock_skew(idx)
        newly = self._expire_deadlines()
        if plan.force_preempt(idx) and self.sched.running:
            self.tracer.event("engine.fault", kind="force_preempt", step=idx)
            self._preempt(self.sched.youngest_running())
        if self.sched.idle:
            return newly
        blocked = plan.allocator_exhausted(idx)
        if blocked:
            self.tracer.event("engine.fault", kind="allocator_exhausted",
                              step=idx)
            self._step_events.append(("fault_exhausted", {}))
        if not blocked:
            newly += self._fail_impossible_heads()
            for slot, req in self.sched.admit():
                failed_uid = self._admit(slot, req)
                if failed_uid is not None:
                    newly.append(failed_uid)
        newly += self._retire_done()
        self._ensure_segment_pages(grow_allowed=not blocked)
        if any(not self._done[s] for s in self.sched.running):
            bad = self._run_segment()
            newly += self._quarantine(bad)
            newly += self._retire_done()
        self._maybe_fallback_reserve()
        return newly

    def collect(self, uid: int) -> list[int]:
        """Full token list (original prompt + generated) of a request that
        reached a terminal status (FAILED/TIMED_OUT/CANCELLED requests
        return their partial output)."""
        if uid not in self._terminal:
            raise KeyError(f"request {uid} is not finished")
        return self._prompts[uid] + self._out[uid]

    def run(self, max_steps: int = 100_000) -> dict[int, list[int]]:
        """Drive ``step`` until idle; returns {uid: tokens} for every
        request in a terminal status.  On non-drain raises
        :class:`EngineDrainError` with the partial results attached."""
        for _ in range(max_steps):
            if self.idle:
                break
            self.step()
        results = {uid: self.collect(uid) for uid in sorted(self._terminal)}
        if not self.idle:
            err = EngineDrainError(
                f"engine did not drain within {max_steps} steps "
                f"({self.sched.num_waiting} waiting, "
                f"{len(self.sched.running)} running); partial results for "
                f"{len(results)} finished requests attached", results)
            err.flight = self._flight_dump(
                "engine_drain", max_steps=max_steps,
                waiting=self.sched.num_waiting,
                running=len(self.sched.running))
            raise err
        return results

    def validate(self) -> None:
        """Invariant checker: allocator free list, page tables, scheduler
        slots, ``DecodeState`` and host mirrors all agree.  A failure dumps
        the flight recorder before re-raising."""
        try:
            self._validate_inner()
        except AssertionError as exc:
            self._flight_dump("validate_failure", error=str(exc))
            raise

    def _validate_inner(self) -> None:
        self.sched.check_invariants()
        st = self._state.to_host()
        running = set(self.sched.running)
        for slot in range(self.ecfg.num_slots):
            if slot not in running:
                assert not st.active[slot], \
                    f"slot {slot} active on device but not running"
                assert not self._done[slot], \
                    f"slot {slot} marked done but not running"
        waiting_uids = [r.uid for r in self.sched.waiting]
        assert len(waiting_uids) == len(set(waiting_uids)), \
            "uid queued twice"
        for slot, req in self.sched.running.items():
            uid = req.uid
            assert int(self._uids[slot]) == uid, "host uid mirror stale"
            assert int(st.uids[slot]) == uid, "device uid stale"
            assert uid not in waiting_uids, "uid both running and waiting"
            gen = int(self._gen[slot])
            assert int(st.gen[slot]) == gen, \
                f"slot {slot}: device gen {int(st.gen[slot])} != host {gen}"
            assert len(self._out[uid]) == self._prior[slot] + gen, \
                f"uid {uid}: harvested tokens disagree with gen counter"
            # every KV position written so far sits in an owned page (the
            # last sampled token is not written until the next decode step)
            written = len(req.prompt) + gen - 1
            assert self.kv.capacity(slot) >= written, \
                f"slot {slot}: {written} tokens written but pages cover " \
                f"only {self.kv.capacity(slot)}"
            assert not self.metrics[uid]["status"].terminal, \
                f"uid {uid} running with terminal status"
        for uid, m in self.metrics.items():
            terminal = m["status"].terminal
            assert terminal == (uid in self._terminal), \
                f"uid {uid}: status {m['status']} vs terminal-set mismatch"
            if terminal:
                assert uid not in waiting_uids, \
                    f"terminal uid {uid} still queued"

    # -- internals ----------------------------------------------------------

    def _to_device(self, table: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(table).to(self.device)

    def _now(self) -> float:
        return self._clock() + self._skew

    def _flight_dump(self, reason: str, **context) -> dict:
        # flush the in-progress step's decisions first: faults fire mid-step
        if self._step_events:
            self.flight.record(
                step=self._step_idx - 1, partial=True,
                events=list(self._step_events),
                queue_depth=self.sched.num_waiting,
                running=len(self.sched.running),
                free_pages=self.kv.free_pages,
                tokens_total=self._tokens_harvested)
        self._c_dumps.inc()
        return self.flight.dump_on_fault(reason, **context)

    def _set_terminal(self, uid: int, status: RequestStatus) -> None:
        m = self.metrics[uid]
        m["status"] = status
        m["finished"] = self._now()
        self._terminal.add(uid)
        counter = self._term_counters.get(status)
        if counter is not None:
            counter.inc()
        times = m["token_times"]
        for prev, cur in zip(times, times[1:]):
            self._h_tok.observe(cur - prev)

    def _deactivate_slot(self, slot: int) -> None:
        self._state.active[slot] = False

    def _evict(self, slot: int) -> Request:
        """Release a slot whose request is leaving mid-flight (cancel,
        timeout, quarantine): free pages, silence the device lane."""
        req = self.sched.retire(slot)
        self._done[slot] = False
        self._deactivate_slot(slot)
        self._table_dirty = True
        return req

    def _preempt(self, slot: int) -> None:
        """Evict under memory pressure and requeue at the head of the line
        with the generated prefix folded into the prompt."""
        req = self.sched.preempt(slot)
        self._done[slot] = False
        self._deactivate_slot(slot)
        self._table_dirty = True
        uid = req.uid
        resumed = Request(
            uid=uid, prompt=self._prompts[uid] + self._out[uid],
            max_new=self._max_new[uid] - len(self._out[uid]),
            temperature=req.temperature, top_k=req.top_k, top_p=req.top_p)
        self.sched.requeue_front(resumed)
        m = self.metrics[uid]
        m["status"] = RequestStatus.PREEMPTED
        m["preemptions"] += 1
        self._c_preempt.inc()
        self._preempt_log.append(self._step_idx)
        self.tracer.event("engine.preempt", uid=uid, slot=slot)
        self._step_events.append(("preempt", {"uid": uid, "slot": slot}))

    def _expire_deadlines(self) -> list[int]:
        now = self._now()
        expired = []
        for req in list(self.sched.waiting):
            m = self.metrics[req.uid]
            waited = now - m["submitted"]
            ttft, total = m["ttft_deadline"], m["deadline"]
            if ((ttft is not None and m["first_token"] is None
                 and waited > ttft)
                    or (total is not None and waited > total)):
                self.sched.remove_waiting(req.uid)
                self._set_terminal(req.uid, RequestStatus.TIMED_OUT)
                self._step_events.append(("timeout", {"uid": req.uid}))
                expired.append(req.uid)
        for slot, req in list(self.sched.running.items()):
            m = self.metrics[req.uid]
            total = m["deadline"]
            if total is not None and now - m["submitted"] > total:
                self._evict(slot)
                self._set_terminal(req.uid, RequestStatus.TIMED_OUT)
                self._step_events.append(("timeout", {"uid": req.uid}))
                expired.append(req.uid)
        return expired

    def _fail_impossible_heads(self) -> list[int]:
        """A head-of-line request whose reservation can never be satisfied
        fails (per-request status) instead of wedging the queue."""
        failed = []
        while self.sched.waiting:
            req = self.sched.waiting[0]
            need = self.sched.required_pages(req)
            hopeless = (need > self.kv.max_pages_per_slot
                        or need > self.kv.num_pages)
            if not hopeless and not self.sched.running:
                # nothing running → no page will ever be freed
                hopeless = need > self.kv.free_pages
            if not hopeless:
                break
            self.sched.waiting.popleft()
            self._set_terminal(req.uid, RequestStatus.FAILED)
            self._step_events.append(("fail_head", {"uid": req.uid}))
            failed.append(req.uid)
        return failed

    def _admit(self, slot: int, req: Request) -> Optional[int]:
        """Prefill an admitted request into ``slot``.  Returns the uid if
        the prefill logits were non-finite (request quarantined → FAILED),
        else None."""
        plen = len(req.prompt)
        bucket = _next_bucket(plen, self.ecfg.min_bucket,
                              self.ecfg.slot_capacity)
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :plen] = req.prompt
        table = self.kv.table()
        with self.tracer.span("engine.prefill", uid=req.uid, slot=slot,
                              plen=plen, bucket=bucket):
            first, was_bad = self._prefill_one(
                slot, req, self._to_device(tokens),
                self._to_device(table[slot:slot + 1]))
            self._table_dirty = True
        uid = req.uid
        self._step_events.append(("admit", {"uid": uid, "slot": slot,
                                            "plen": plen}))
        self._uids[slot] = uid
        self._prior[slot] = len(self._out[uid])
        self._gen[slot] = 1
        if was_bad:
            self._evict(slot)
            self._set_terminal(uid, RequestStatus.FAILED)
            self._step_events.append(("prefill_nan", {"uid": uid}))
            return uid
        now = self._now()
        self._out[uid].append(first)
        self._tokens_harvested += 1
        self._c_tokens.inc()
        m = self.metrics[uid]
        if m["first_token"] is None:
            m["first_token"] = now
            self._h_ttft.observe(now - m["submitted"])
        m["token_times"].append(now)
        m["status"] = RequestStatus.RUNNING
        eos_hit = (self.ecfg.eos_token is not None
                   and first == self.ecfg.eos_token)
        self._done[slot] = bool(req.max_new <= 1 or eos_hit)
        return None

    def _ensure_segment_pages(self, grow_allowed: bool = True) -> None:
        """Extend every running slot's pages to cover the coming segment's
        KV writes (oldest request first).  An optimistic slot that cannot
        grow preempts the youngest running request and retries: decoding
        past a slot's owned pages would drop KV into the trash page."""
        seg = self.ecfg.segment_len
        order = sorted(self.sched.running,
                       key=self.sched.admitted_seq.__getitem__)
        for slot in order:
            if slot not in self.sched.running:
                continue                    # preempted by an older slot
            req = self.sched.running[slot]
            plen, gen = len(req.prompt), int(self._gen[slot])
            # next segment writes positions [plen+gen-1, plen+gen+seg-2];
            # the final sampled token is never fed back, so the request
            # never writes past plen + max_new - 2
            need_tokens = min(plen + gen - 1 + seg, req.max_tokens - 1)
            while True:
                need = (pages_needed(need_tokens, self.ecfg.page_size)
                        - self.kv.num_owned(slot))
                if need <= 0:
                    break
                if not grow_allowed:        # injected allocator exhaustion
                    self._preempt(slot)
                    break
                if self.kv.grow(slot, need):
                    self._c_grows.inc(need)
                    self._step_events.append(("grow", {"slot": slot,
                                                       "pages": need}))
                    self._table_dirty = True
                    break
                victim = self.sched.youngest_running()
                if victim == slot:
                    # nothing younger to evict — preempt the grower itself
                    self._preempt(slot)
                    break
                self._preempt(victim)

    def _run_segment(self) -> np.ndarray:
        """One decode segment.  Returns the per-slot quarantine flags
        (non-finite logits seen) for the host to act on."""
        running = np.zeros(self.ecfg.num_slots, bool)
        for s in self.sched.running:
            running[s] = True
        if self._table_dirty:
            self._table_dev = self._to_device(self.kv.table())
            self._table_dirty = False
        refill = self.ecfg.stop_on_finish and self.sched.num_waiting > 0
        with self.tracer.span("engine.decode_segment",
                              slots=len(self.sched.running)) as sp:
            out = self._decode_segment(refill)
            # ONE read per segment: everything the host bookkeeping needs
            st = self._state
            flags = torch.stack([st.gen, st.active.long(), st.bad.long()], 1)
            host = torch.cat([flags, out], 1).cpu().numpy()
        gen_after = host[:, 0]
        still_active, bad = host[:, 1].astype(bool), host[:, 2].astype(bool)
        out = host[:, 3:]
        now = self._now()
        harvested = 0
        for slot in self.sched.running:
            n_new = int(gen_after[slot] - self._gen[slot])
            if n_new:
                uid = int(self._uids[slot])
                toks = [int(t) for t in out[slot, :n_new]]
                self._out[uid].extend(toks)
                self.metrics[uid]["token_times"].extend([now] * n_new)
                harvested += n_new
        sp.set(tokens=harvested)
        self._tokens_harvested += harvested
        self._c_tokens.inc(harvested)
        self._gen = gen_after.copy()
        self._done |= running & ~still_active & ~bad
        return running & bad

    def _quarantine(self, bad: np.ndarray) -> list[int]:
        """Retire slots whose logits went non-finite as FAILED."""
        failed = []
        for slot in list(self.sched.running):
            if bad[slot]:
                req = self._evict(slot)
                self._set_terminal(req.uid, RequestStatus.FAILED)
                self.tracer.event("engine.quarantine", uid=req.uid, slot=slot)
                self._step_events.append(("quarantine", {"uid": req.uid,
                                                         "slot": slot}))
                failed.append(req.uid)
        if failed:
            self._flight_dump("nan_quarantine", uids=failed,
                              step=self._step_idx)
        return failed

    def _retire_done(self) -> list[int]:
        finished = []
        for slot in list(self.sched.running):
            if self._done[slot]:
                req = self.sched.retire(slot)
                self._done[slot] = False
                self._table_dirty = True
                self._set_terminal(req.uid, RequestStatus.FINISHED)
                self._step_events.append(("retire", {"uid": req.uid,
                                                     "slot": slot}))
                finished.append(req.uid)
        return finished

    def _maybe_fallback_reserve(self) -> None:
        """Thrash watermark: when preemption churns (≥ thrash_preemptions
        in the last thrash_window steps), fall back to full reservation for
        all future admissions."""
        if self.sched.mode != "optimistic":
            return
        floor = self._step_idx - self.ecfg.thrash_window
        self._preempt_log = [s for s in self._preempt_log if s > floor]
        if len(self._preempt_log) >= self.ecfg.thrash_preemptions:
            self.sched.mode = "reserve"
            self._fallback_step = self._step_idx
            self.tracer.event("engine.fallback_reserve", step=self._step_idx)
            self._step_events.append(("fallback_reserve",
                                      {"step": self._step_idx}))

    # -- device bodies (the reference's jitted _prefill_one/_decode_segment) --

    def _poisoned(self, uids, positions):
        """The fault plan's NaN injection: rows of ``poison_uid`` once their
        sampling position reaches ``poison_pos`` (never with NO_FAULTS)."""
        plan = self._faults
        return (uids == plan.poison_uid) & (positions >= plan.poison_pos)

    def _fresh_slot_state(self, slot: int):
        """The caches of a batch-1 prefill into ``slot``: the shared pools,
        and each mamba layer's rows of the slot, zeroed (a new request
        starts from zero state), as views the prefill writes in place."""
        caches = []
        for cache in self.caches:
            if "h" in cache:        # a mamba layer's per-slot {conv, h}
                cache = {k: v[slot:slot + 1] for k, v in cache.items()}
                for v in cache.values():
                    v.zero_()
            caches.append(cache)
        return caches

    def _prefill_one(self, slot: int, req: Request, tokens, table_row):
        """Batch-1 prefill of one admitted request and its first sampled
        token, written into the slot's ``DecodeState``; → (first token,
        quarantine flag), read to the host in one copy."""
        plen, dev = len(req.prompt), self.device
        logit_index = torch.full((1,), plen - 1, dtype=torch.int64, device=dev)
        logits, _ = lm.prefill(self.cfg, self.params, self._fresh_slot_state(slot),
                               {"tokens": tokens}, page_table=table_row,
                               page_size=self.ecfg.page_size,
                               logit_index=logit_index)
        uid = torch.full((1,), req.uid, dtype=torch.int64, device=dev)
        hit = self._poisoned(uid, logit_index + 1)
        logits = torch.where(hit[:, None], float("nan"), logits)
        bad = ~lm.finite_logits(logits)[0]
        temp = torch.full((1,), req.temperature, dtype=torch.float32, device=dev)
        top_k = torch.full((1,), req.top_k, dtype=torch.int64, device=dev)
        top_p = torch.full((1,), req.top_p, dtype=torch.float32, device=dev)
        tok = sample_tokens(logits, uids=uid, positions=logit_index + 1,
                            seed=self.ecfg.seed, temperature=temp,
                            top_k=top_k, top_p=top_p)[0]
        eos = (tok == self.ecfg.eos_token) if self.ecfg.eos_token is not None \
            else torch.zeros((), dtype=torch.bool, device=dev)
        st = self._state
        st.tok[slot] = tok
        st.pos[slot] = plen
        st.gen[slot] = 1
        st.limit[slot] = req.max_new
        st.active[slot] = (req.max_new > 1) & ~eos & ~bad
        st.bad[slot] = bad
        st.uids[slot] = req.uid
        st.temp[slot] = req.temperature
        st.top_k[slot] = req.top_k
        st.top_p[slot] = req.top_p
        first, was_bad = torch.stack([tok, bad.long()]).tolist()
        return first, bool(was_bad)

    def _decode_segment(self, refill: bool) -> torch.Tensor:
        """Up to ``segment_len`` decode steps for every slot; → (B, seg)
        sampled tokens, -1 where a slot produced none.  Finished slots go
        inactive (their writes land in their own pages or the trash page and
        are discarded).  With ``refill`` (requests are waiting) the segment
        ends as soon as any slot finishes or is quarantined.  A slot whose
        logits go non-finite is flagged ``bad``, contributes no token and
        stops advancing; the other slots keep decoding."""
        seg, st = self.ecfg.segment_len, self._state
        b, dev = st.tok.shape[0], self.device
        out = torch.full((b, seg), -1, dtype=torch.int64, device=dev)
        finished_any = torch.zeros((), dtype=torch.bool, device=dev)
        for t in range(seg):
            go = st.active.any()
            if refill:
                go = go & ~finished_any
            if not bool(go):             # the loop's exit test: one host read
                break
            tok_in = torch.where(st.active, st.tok, 0)
            logits, _ = lm.decode_step(self.cfg, self.params, self.caches,
                                       tok_in, st.pos,
                                       page_table=self._table_dev,
                                       page_size=self.ecfg.page_size)
            self.decode_steps += 1
            hit = st.active & self._poisoned(st.uids, st.pos + 1)
            logits = torch.where(hit[:, None], float("nan"), logits)
            bad_now = st.active & ~lm.finite_logits(logits)
            alive = st.active & ~bad_now
            nxt = sample_tokens(logits, uids=st.uids, positions=st.pos + 1,
                                seed=self.ecfg.seed, temperature=st.temp,
                                top_k=st.top_k, top_p=st.top_p)
            out[:, t] = torch.where(alive, nxt, -1)
            gen = st.gen + alive.long()
            eos = (nxt == self.ecfg.eos_token) if self.ecfg.eos_token is not None \
                else torch.zeros_like(st.active)
            done = alive & ((gen >= st.limit) | eos)
            st.tok = torch.where(alive, nxt, st.tok)
            st.pos = st.pos + alive.long()
            st.gen = gen
            st.active = alive & ~done
            st.bad = st.bad | bad_now
            finished_any = finished_any | done.any() | bad_now.any()
        return out
