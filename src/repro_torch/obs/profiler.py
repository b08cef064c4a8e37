"""Kernel profiler: timing of compiled TppGraphs, recorded side by side with
``perf_model`` predictions.  A port of ``repro/obs/profiler.py``.

The paper's cost model ranks schedules analytically; an analytic model plus
a little real measurement beats either alone.  This module is the
measurement half:

* :func:`time_callable` — the timing discipline every number here goes
  through: ``warmup`` untimed calls, then the **median** of ``iters`` timed
  calls.  On the card the timed calls queue back to back behind a kernel
  that sleeps longer than the host takes to enqueue them, a CUDA event
  between each two, so a sample is the card's time for one call and not
  the host's launch cost; one synchronize follows the last, before any
  time is read.  On the CPU each call is timed on the host clock
  (``time.perf_counter``, or an injected ``clock``: the drift-table golden
  test scripts it).
* :func:`profile_graph` — compile a graph for a device (K5 on CUDA, its
  plain version on the CPU, both through ``lowering.compile_for_device``),
  time it, and pair the measurement with ``fusion.graph_cost``'s prediction
  for the same schedule: a :class:`ProfileRecord` with the drift ratio and
  roofline bound class.
* :func:`make_measure_fn` — the profiler as ``autotune``'s
  ``measure_fn(candidate) -> seconds``: the graph compiled under the
  candidate's schedule.  On the card that is K5 rasterised in the
  candidate's visit order, so the measurement ranks schedules.

Operands are drawn in numpy from the seed and moved to the device.  A
device that is not there raises; nothing falls back to the CPU.

Drift = measured / predicted.  :func:`attribution_table` flags records whose
drift strays from the set's median by more than ``threshold``×: the
relative drift across graphs and schedules is the signal.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "time_callable", "synth_operands", "profile_graph", "make_measure_fn",
    "ProfileRecord", "attribution_table", "drift_flags",
]


# Cycles the card sleeps, for each timed call, before the first: at least
# 1e6 (about 0.5 ms at the H100's 1.98 GHz boost clock), and four times the
# host's time for the last warmup call at 2e9 cycles a second, that time
# taken as 10 ms at most (a first call that builds a kernel takes minutes).
_SLEEP_CYCLES_A_CALL = 1_000_000
_SLEEP_CYCLES_A_SECOND = 4 * 2e9
_SLEEP_HOST_S_MAX = 0.01


def time_callable(fn: Callable[[], object], *, iters: int = 5, warmup: int = 2,
                  clock=None, device="cuda") -> tuple[float, list[float]]:
    """(median seconds, all samples) of ``fn()`` after ``warmup`` untimed
    calls.  ``device`` "cuda": the card's time for each call, the calls
    queued behind a sleeping kernel with a CUDA event between each two, read
    after one synchronize (``clock`` must be None: the host clock does not
    see the card's time).  ``device`` "cpu": the host clock around each
    call."""
    if iters < 1:
        raise ValueError("need iters >= 1")
    dev = torch.device(device)
    if dev.type == "cuda":
        if clock is not None:
            raise ValueError("a CUDA device is timed by CUDA events, not by a host clock")
        host_s = 0.0
        with torch.cuda.device(dev):
            for _ in range(warmup):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                host_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
            host_s = min(host_s, _SLEEP_HOST_S_MAX)
            torch.cuda._sleep(int(iters * max(_SLEEP_CYCLES_A_CALL,
                                              host_s * _SLEEP_CYCLES_A_SECOND)))
            events[0].record()
            for end in events[1:]:
                fn()
                end.record()
            torch.cuda.synchronize()
        samples = [start.elapsed_time(end) / 1e3 for start, end in zip(events, events[1:])]
    else:
        clock = clock if clock is not None else time.perf_counter
        for _ in range(warmup):
            fn()
        samples = []
        for _ in range(iters):
            t0 = clock()
            fn()
            samples.append(clock() - t0)
    return float(statistics.median(samples)), samples


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    from repro_torch.core.perf_model import dtype_name
    return getattr(torch, dtype_name(dtype))


def synth_operands(graph, m: int, k: int, n: int, *, dtype=torch.float32,
                   seed: int = 0, device="cuda") -> dict:
    """Deterministic random operands matching ``graph``'s operand specs
    (post-simplification), drawn as the reference draws them: lhs/rhs honor
    ``trans`` layouts, masks draw bools, scalars an integer seed, rowvecs
    are (n,).  Floating operands are ``dtype`` on ``device``."""
    from repro_torch.fusion.graph import simplify_graph

    dt = _torch_dtype(dtype)
    rng = np.random.default_rng(seed)
    ops = {}
    for spec in simplify_graph(graph).operands:
        if spec.kind == "lhs":
            shape = (k, m) if spec.trans else (m, k)
        elif spec.kind == "rhs":
            shape = (n, k) if spec.trans else (k, n)
        elif spec.kind == "tile":
            shape = (m, n)
        elif spec.kind == "mask":
            ops[spec.name] = torch.from_numpy(rng.random((m, n)) < 0.9).to(device)
            continue
        elif spec.kind == "scalar":
            ops[spec.name] = int(rng.integers(0, 2**31))
            continue
        elif spec.kind == "rowvec":
            shape = (n,)
        else:
            raise ValueError(f"unknown operand kind {spec.kind!r}")
        ops[spec.name] = torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).to(device=device, dtype=dt)
    return ops


@dataclasses.dataclass
class ProfileRecord:
    """One graph × shape × schedule × device measurement next to its
    prediction.  ``drift`` > 1 means slower than predicted."""
    name: str
    shape: tuple[int, int, int]
    device: str
    spec: str
    predicted_s: float
    measured_s: float
    bound: str                    # roofline class: compute|memory|collective
    iters: int
    warmup: int
    samples: tuple[float, ...] = ()

    @property
    def drift(self) -> float:
        return self.measured_s / self.predicted_s

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["shape"] = list(self.shape)
        d["samples"] = list(self.samples)
        d["drift"] = self.drift
        return d


def _build_fn(graph, *, tiles, spec_string, block_steps):
    """The graph under one schedule: K5 for CUDA operands, its plain
    version for CPU operands (``lowering.compile_for_device``)."""
    from repro_torch.fusion import lowering

    return lowering.compile_for_device(graph, spec_string=spec_string, tiles=tiles,
                                       block_steps=block_steps or None)


def profile_graph(graph, m: int, k: int, n: int, *, dtype=torch.float32,
                  device="cuda", tiles=None,
                  spec_string: Optional[str] = None, block_steps=None,
                  operands: Optional[dict] = None, seed: int = 0,
                  iters: int = 5, warmup: int = 2, clock=None,
                  target=None) -> ProfileRecord:
    """Measure ``graph`` at (M, K, N) on ``device`` and pair the time with
    the perf model's prediction for the same tiles and schedule (default
    target: the card's, read from it on CUDA)."""
    from repro_torch.core import perf_model
    from repro_torch.fusion import cost, lowering

    spec_string = spec_string or lowering.DEFAULT_SPEC
    tiles = tiles or cost._default_tiles(m, k, n, dtype)
    if target is None:
        target = (perf_model.H100Target.from_device(device)
                  if torch.device(device).type == "cuda" else perf_model.H100Target())
    rep = cost.graph_cost(graph, m, k, n, tiles=tiles, dtype=dtype,
                          spec_string=spec_string, block_steps=block_steps,
                          target=target)
    ops = operands if operands is not None else synth_operands(
        graph, m, k, n, dtype=dtype, seed=seed, device=device)
    fn = _build_fn(graph, tiles=tiles, spec_string=spec_string, block_steps=block_steps)
    measured, samples = time_callable(lambda: fn(**ops), iters=iters, warmup=warmup,
                                      clock=clock, device=device)
    return ProfileRecord(
        name=graph.name, shape=(m, k, n), device=str(torch.device(device)), spec=rep.spec,
        predicted_s=rep.total_time, measured_s=measured, bound=rep.bound,
        iters=iters, warmup=warmup, samples=tuple(samples))


def make_measure_fn(graph, m: int, k: int, n: int, *, dtype=torch.float32,
                    device="cuda", tiles=None, operands: Optional[dict] = None,
                    seed: int = 0, iters: int = 3, warmup: int = 1, clock=None):
    """An ``autotune``/``autotune_graph`` ``measure_fn``: candidate → median
    seconds of the graph compiled under that candidate's schedule on
    ``device``.  Pass it straight in::

        fusion.autotune_graph(g, m, k, n,
                              measure_fn=obs.profiler.make_measure_fn(g, m, k, n))

    A candidate that fails to plan, build or launch raises."""
    from repro_torch.fusion import cost

    ops = operands if operands is not None else synth_operands(
        graph, m, k, n, dtype=dtype, seed=seed, device=device)

    def measure(candidate) -> float:
        kw = cost.schedule_kwargs(candidate)
        fn = _build_fn(graph, tiles=tiles, spec_string=kw["spec_string"],
                       block_steps=kw["block_steps"])
        measured, _ = time_callable(lambda: fn(**ops), iters=iters, warmup=warmup,
                                    clock=clock, device=device)
        return measured

    return measure


def drift_flags(records: Sequence[ProfileRecord],
                threshold: float = 3.0) -> list[bool]:
    """Flag records whose drift strays more than ``threshold``× from the
    set's median drift.  Comparing to the median (not to 1.0) factors out a
    constant offset between the model and the device; the outliers —
    schedules the model mispriced *relative to their peers* — are what the
    table must surface."""
    if not records:
        return []
    med = statistics.median(r.drift for r in records)
    flags = []
    for r in records:
        rel = r.drift / med if med > 0 else float("inf")
        flags.append(rel > threshold or rel < 1.0 / threshold)
    return flags


def attribution_table(records: Sequence[ProfileRecord],
                      threshold: float = 3.0) -> str:
    """The model-vs-measured table ``python -m repro_torch.obs.report``
    prints: one row per record — predicted s, measured s, drift ratio,
    roofline bound class — with a ``DRIFT`` marker on flagged rows."""
    flags = drift_flags(records, threshold)
    header = (f"{'graph':<28} {'shape':<16} {'device':<16} {'spec':<8} "
              f"{'predicted_s':>12} {'measured_s':>12} {'drift':>9} "
              f"{'bound':<8} flag")
    lines = [header, "-" * len(header)]
    for r, flagged in zip(records, flags):
        shape = "x".join(str(d) for d in r.shape)
        lines.append(
            f"{r.name:<28} {shape:<16} {r.device:<16} {r.spec:<8} "
            f"{r.predicted_s:>12.3e} {r.measured_s:>12.3e} "
            f"{r.drift:>9.2f} {r.bound:<8} "
            f"{'DRIFT' if flagged else 'ok'}")
    return "\n".join(lines)
