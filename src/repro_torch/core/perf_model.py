"""Performance model for PARLOOPER schedules (paper §II-E), with a target
for the card the port runs on.

The paper walks each thread's chronological tensor-slice accesses through
a multi-level LRU cache with per-level bandwidths.  ``predict`` scores one
planned nest against a target and dispatches on its type:

  * :class:`H100Target`, the port's default: the rule of the port's own
    launch.  One CTA owns each output block of the plan and walks the
    nest's reduction levels inside it; the CTAs start in the plan's visit
    order (``cuda_lowering.plan_cuda``, ``brgemm.cta_order``,
    ``fused_gemm.order_table``) in waves of as many output blocks as the
    card holds at once (SMs × CTAs an SM × the kernel's CTA tile).  An
    operand block is read from HBM unless the blocks touched within the
    last L2-sized stretch of that walk hold it: the reference's ``trace``
    LRU, with the L2 as its budget, walked a wave at a time over each
    CTA's panel of an operand (the blocks it reads along the reduction).
    It is the target's one rule: ``mode`` and ``trace_limit`` choose
    between a ``TpuTarget``'s two walks and are ignored here.  The output
    is written once a block.  Compute runs at the tensor-core peak, scaled
    by wgmma's granularity (64 rows, N in 8s, K in 16s) and by the wave
    quantisation of the kernel's CTAs over the SMs; a fused epilogue runs
    at the fp32 CUDA-core rate.  A reduction level outside an output level is a plan
    no CTA can own (``TPP102``) and is penalised as the reference
    penalises an infeasible one.
  * :class:`TpuTarget`: the reference's model with the reference's
    arithmetic (``repro/core/perf_model.py``), kept so that the port's
    tuner can be held to the reference's reports and rankings.  Its
    constants are a TPU v5e's, the reference's; nothing measured on the
    card is scored with them.

``predict_batch`` is the reference's vectorised analytic path for a
``TpuTarget``; the tuner scores ``H100Target`` candidates with
:func:`predict_levels`, the same arithmetic as ``predict`` on the
candidate's levels without a planned nest.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.cuda_lowering import TensorMap
from repro_torch.core.loops import LoopNest

__all__ = ["TpuTarget", "H100Target", "PerfReport", "predict", "predict_batch",
           "predict_levels", "mxu_efficiency", "wgmma_efficiency", "traffic_bounds",
           "h100_compute_time", "nest_levels", "dtype_bytes", "dtype_name"]


@dataclasses.dataclass(frozen=True)
class TpuTarget:
    """The reference's hardware constants (a TPU v5e), for parity only."""

    name: str = "tpu_v5e"
    peak_flops_bf16: float = 197e12
    peak_flops_fp32: float = 49.25e12   # MXU native bf16; fp32 at 1/4
    hbm_bw: float = 819e9               # B/s
    vmem_bytes: int = 128 * 2 ** 20
    vpu_flops: float = 3.2e12           # vector unit (fused-epilogue TPPs)
    ici_bw: float = 50e9                # B/s per link
    dma_latency: float = 1.0e-6         # per block-change overhead (s)
    num_cores: int = 1                  # v5e has one TensorCore (no megacore)

    def peak_flops(self, dtype_bytes: int) -> float:
        return self.peak_flops_bf16 if dtype_bytes <= 2 else self.peak_flops_fp32


@dataclasses.dataclass(frozen=True)
class H100Target:
    """One NVIDIA H100.  The defaults are the SXM part's figures;
    :meth:`from_device` reads the SM count, the L2 and the shared memory of
    the card in hand."""

    name: str = "h100_sxm"
    sms: int = 132                      # H100 SXM5: 132 SMs (NVIDIA H100 whitepaper)
    l2_bytes: int = 50 * 2 ** 20        # 50 MB L2 (whitepaper)
    smem_per_sm: int = 228 * 1024       # 228 KB shared memory an SM (Hopper tuning guide)
    hbm_bw: float = 3.35e12             # B/s, HBM3 (H100 SXM data sheet)
    peak_flops_bf16: float = 989e12     # dense bf16 tensor cores (data sheet)
    peak_flops_fp32: float = 67e12      # fp32 on the CUDA cores (data sheet)
    link_bw: float = 450e9              # B/s a direction: NVLink 4's 900 GB/s (data sheet)
    # The port's wgmma GEMM kernels: a CTA computes 128 x 128 of the output
    # (brgemm.WGMMA_TILE; K5's one-root tile, two 128 x 64 tiles for two
    # roots), streams K in 64-deep steps through a ring of ring_stages
    # (csrc/gemm.cu K1_STAGES) and is built for two CTAs an SM (K1_CTAS).
    cta_tile: tuple[int, int] = (128, 128)
    ring_stages: int = 3
    ctas_per_sm: int = 2
    k_step: int = 64
    # Their decode variants (M <= 16, brgemm.DECODE_ROWS): the operands
    # swap, the M rows ride wgmma's n of 16 and K is split until the CTAs
    # fill the SMs (brgemm.decode_splits), so no wave is left part empty.
    decode_rows: int = 16

    def peak_flops(self, dtype_bytes: int) -> float:
        return self.peak_flops_bf16 if dtype_bytes <= 2 else self.peak_flops_fp32

    @classmethod
    def from_device(cls, device=None) -> "H100Target":
        """The target with the SM count, L2 and shared memory an SM that
        ``torch.cuda.get_device_properties`` reports for ``device``; the
        rates stay the data sheet's (no property reports them)."""
        props = torch.cuda.get_device_properties(device)
        return cls(name=props.name, sms=props.multi_processor_count,
                   l2_bytes=int(props.L2_cache_size),
                   smem_per_sm=int(getattr(props, "shared_memory_per_multiprocessor",
                                           cls.smem_per_sm)))

    def ctas_at_once(self, dtype_bytes: int) -> int:
        """CTAs an SM holds: ``ctas_per_sm``, fewer where the K ring of
        one CTA tile does not fit that many times in shared memory."""
        ring = self.ring_stages * (self.cta_tile[0] + self.cta_tile[1]) * self.k_step * dtype_bytes
        return max(1, min(self.ctas_per_sm, self.smem_per_sm // ring))


def mxu_efficiency(bm: int, bn: int, bk: int) -> float:
    """MXU utilization of a (bm×bk)·(bk×bn) tile: padding waste to the 128-wide
    systolic array on M/N plus accumulation-depth pipeline efficiency on K
    (the reference's, for ``TpuTarget``)."""
    def pad_eff(d):
        return d / (math.ceil(d / 128) * 128)

    eff_k = bk / (bk + 8.0)  # systolic fill/drain amortization
    return pad_eff(bm) * pad_eff(bn) * eff_k


def wgmma_efficiency(bm: int, bn: int, bk: int) -> float:
    """The share of wgmma's work that is the tile's: M padded to wgmma's 64
    rows, N to a multiple of 8, K to a multiple of 16 (bf16 m64nNk16)."""
    def pad_eff(d, g):
        return d / (math.ceil(d / g) * g)

    return pad_eff(bm, 64) * pad_eff(bn, 8) * pad_eff(bk, 16)


@dataclasses.dataclass
class PerfReport:
    spec: str
    total_steps: int
    flops: float
    hbm_bytes: float
    compute_time: float
    memory_time: float
    collective_time: float
    total_time: float
    gflops: float
    fetches: dict
    notes: tuple[str, ...] = ()

    @property
    def bound(self) -> str:
        t = {"compute": self.compute_time, "memory": self.memory_time,
             "collective": self.collective_time}
        return max(t, key=t.get)


def dtype_bytes(dtype) -> int:
    """Item size of a torch or numpy dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    if isinstance(dtype, str) and hasattr(torch, dtype.removeprefix("torch.")):
        return getattr(torch, dtype.removeprefix("torch.")).itemsize
    return np.dtype(dtype).itemsize


def dtype_name(dtype) -> str:
    """One name for a dtype however it is given: ``torch.float32``,
    ``np.float32`` and ``"float32"`` all give ``"float32"``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return dtype.removeprefix("torch.")
    return str(np.dtype(dtype))



def _operand_block_bytes(nest: LoopNest, tm: TensorMap, dtype_bytes: int) -> int:
    n = 1
    for letter, t in zip(tm.letters, tm.tile):
        nblocks = 1 if letter is None else nest.innermost_step(letter)
        n *= nblocks * t
    return n * dtype_bytes


def _p_max(nest: LoopNest, tm: TensorMap) -> int:
    letters = {l for l in tm.letters if l is not None}
    pmax = -1
    for pos, lvl in enumerate(nest.levels):
        if lvl.letter in letters:
            pmax = pos
    return pmax


def _local_trips(nest: LoopNest) -> list[int]:
    return [
        (l.trip_count // l.ways) if l.mesh_axis is not None else l.trip_count
        for l in nest.levels
    ]


def predict_batch(
    trips,
    pmax,
    block_bytes,
    *,
    dtype,
    flops_per_body: float,
    tile_mnk: Optional[tuple[int, int, int]] = None,
    target: TpuTarget = TpuTarget(),
    epilogue_flops: float = 0.0,
    scratch_bytes: float = 0.0,
    collective_time: float = 0.0,
):
    """Vectorized analytic path of :func:`predict` under a ``TpuTarget``
    over a batch of candidate schedules: the reference's scoring hot loop.

    Args:
      trips: ``(C, L)`` int array — per-candidate *local* level trip counts,
        outer→inner, right-padded with 1 (shorter nests).
      pmax: ``(C, O)`` int array — per candidate and operand, the deepest
        level position whose letter indexes the operand (``-1`` = none; the
        operand is fetched once).  The last operand column is the output.
      block_bytes: ``(O,)`` — per-operand VMEM block bytes (schedule-invariant
        for a fixed declared nest: the innermost step of every letter is the
        loop's base step).
      collective_time: mesh split-K all-reduce seconds, identical for every
        candidate in the batch (ways are fixed by the decomposition request).

    Returns a dict of ``(C,)`` arrays: ``gflops``, ``total_time``,
    ``compute_time``, ``memory_time``, ``hbm_bytes``, ``total_steps`` and the
    ``(C, O)`` ``fetches`` — numerically identical to calling ``predict`` per
    candidate in ``analytic`` mode under the same ``TpuTarget``.
    """
    if not isinstance(target, TpuTarget):
        raise TypeError("predict_batch scores a TpuTarget; an H100Target's candidates go "
                        "through predict_levels")
    db = dtype_bytes(dtype)
    trips = np.asarray(trips, dtype=np.float64)
    pmax = np.asarray(pmax, dtype=np.int64)
    bb = np.asarray(block_bytes, dtype=np.float64)
    cum = np.cumprod(trips, axis=1)                      # (C, L)
    total_steps = cum[:, -1]
    nlev = cum.shape[1]
    gathered = np.take_along_axis(cum, np.clip(pmax, 0, nlev - 1), axis=1)
    fetches = np.where(pmax >= 0, gathered, 1.0)         # (C, O)

    hbm_bytes = fetches @ bb + fetches[:, -1] * bb[-1]   # + output write-back

    flops = flops_per_body * total_steps
    eff = mxu_efficiency(*tile_mnk) if tile_mnk else 1.0
    peak = target.peak_flops(db) * eff
    compute_time = flops / peak
    if epilogue_flops:
        compute_time = compute_time + epilogue_flops / target.vpu_flops
        flops = flops + epilogue_flops
    ws = 2 * bb.sum() + scratch_bytes
    if ws > target.vmem_bytes:
        compute_time = compute_time * 1e3  # same hard penalty as predict()

    memory_time = hbm_bytes / target.hbm_bw
    dma_overhead = fetches.sum(axis=1) * target.dma_latency
    total_time = (np.maximum(compute_time, memory_time) + dma_overhead
                  + collective_time)
    return {
        "gflops": flops / total_time / 1e9,
        "total_time": total_time,
        "compute_time": compute_time,
        "memory_time": memory_time,
        "hbm_bytes": hbm_bytes,
        "total_steps": total_steps,
        "fetches": fetches,
    }


# ---------------------------------------------------------------------------
# The H100 rule
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Walk:
    """A nest as the H100 rule reads it: ``levels`` (letter, local trip,
    multiplier in units of the letter's innermost step) outer→inner, the
    output blocks' coordinates in visit order, the wave size in blocks."""

    levels: list
    maps: list            # letter tuples, inputs then the output
    block_bytes: list
    out_letters: frozenset
    coords: dict          # out letter -> (n_ctas,) block coordinate, visit order
    n_ctas: int
    letter_blocks: dict   # letter -> blocks it spans (product of its trips)
    legal: bool


def _walk(levels, maps, block_bytes) -> _Walk:
    out_letters = frozenset(l for l in maps[-1] if l is not None)
    out_pos = [p for p, (l, _t, _m) in enumerate(levels) if l in out_letters]
    red_pos = [p for p, (l, _t, _m) in enumerate(levels) if l not in out_letters]
    legal = not (out_pos and red_pos and min(red_pos) < max(out_pos))
    sub = (np.indices(tuple(levels[p][1] for p in out_pos)).reshape(len(out_pos), -1)
           if out_pos else np.zeros((0, 1), dtype=np.int64))
    coords = {l: np.zeros(sub.shape[1], dtype=np.int64) for l in out_letters}
    for i, p in enumerate(out_pos):
        letter, _trip, mult = levels[p]
        coords[letter] += sub[i] * mult
    letter_blocks: dict = {}
    for letter, trip, _mult in levels:
        letter_blocks[letter] = letter_blocks.get(letter, 1) * trip
    return _Walk(list(levels), list(maps), list(block_bytes), out_letters, coords,
                 sub.shape[1], letter_blocks, legal)


def _keys(w: _Walk, letters) -> list:
    return list(dict.fromkeys(l for l in letters if l in w.out_letters))


def _panel_ids(w: _Walk, letters) -> np.ndarray:
    """Each CTA's panel of an operand with ``letters``, as one integer: its
    coordinates on the output letters that index the operand."""
    ids = np.zeros(w.n_ctas, dtype=np.int64)
    for l in _keys(w, letters):
        ids = ids * w.letter_blocks[l] + w.coords[l]
    return ids


def _panel_blocks(w: _Walk, letters) -> int:
    """Blocks of an operand one CTA reads: its reduction letters' spans."""
    return math.prod(w.letter_blocks[l] for l in set(letters)
                     if l is not None and l not in w.out_letters)


def _wave_blocks(w: _Walk, target: H100Target, db: int) -> int:
    """Output blocks of the plan that the card computes at once."""
    out_elems = max(1, w.block_bytes[-1] // db)
    cta_elems = target.cta_tile[0] * target.cta_tile[1]
    return max(1, target.sms * target.ctas_at_once(db) * cta_elems // out_elems)


def _misses(w: _Walk, wave: int, l2_bytes: float) -> list[int]:
    """Blocks each input operand reads from HBM: a wave at a time, a panel
    is a miss unless a wave within the last ``l2_bytes`` of footprint
    (panels and output blocks) read it."""
    ins = w.maps[:-1]
    n_waves = -(-w.n_ctas // wave)
    wave_of = np.arange(w.n_ctas) // wave
    footprint = np.bincount(wave_of, minlength=n_waves) * float(w.block_bytes[-1])
    seen = []
    for o, m in enumerate(ins):
        pairs = np.unique(_panel_ids(w, m) * n_waves + wave_of)   # by panel, then wave
        panel, at = pairs // n_waves, pairs % n_waves
        footprint += np.bincount(at, minlength=n_waves) * float(
            w.block_bytes[o] * _panel_blocks(w, m))
        seen.append((panel, at))
    # a wave's window: the earlier waves whose footprints, summed back from
    # it, fit in the L2
    before = np.concatenate([[0.0], np.cumsum(footprint)])
    window = np.searchsorted(before, before[:-1] - l2_bytes, side="left")
    misses = []
    for (panel, at), m in zip(seen, ins):
        last = np.full(len(panel), -1)
        again = panel[1:] == panel[:-1]
        last[1:][again] = at[:-1][again]      # the panel's previous wave
        hit = (last >= 0) & (last >= window[at])
        misses.append(int((~hit).sum()) * _panel_blocks(w, m))
    return misses


def h100_compute_time(flops, epilogue_flops, n_ctas, out_block_bytes, db, tile_mnk,
                      target: H100Target) -> float:
    """Seconds of tensor-core work at the peak scaled by wgmma's
    granularity and by the wave quantisation of the kernel's CTAs (the
    busiest SM runs ceil(CTAs / SMs) of them), or for a decode tile (M rows
    at most ``decode_rows``) by the rows' share of wgmma's n of 16 with the
    SMs all busy; plus the epilogue at the fp32 CUDA-core rate.  Depends on
    the schedule's blocks, not its order."""
    if tile_mnk and tile_mnk[0] <= target.decode_rows:
        bm, bn, bk = tile_mnk
        eff, quant = wgmma_efficiency(bn, bm, bk) * bm / target.decode_rows, 1.0
    else:
        eff = wgmma_efficiency(*tile_mnk) if tile_mnk else 1.0
        out_elems = max(1, out_block_bytes // db)
        kernel_ctas = max(1, -(-n_ctas * out_elems // (target.cta_tile[0] * target.cta_tile[1])))
        quant = -(-kernel_ctas // target.sms) * target.sms / kernel_ctas
    t = flops / (target.peak_flops(db) * eff) * quant
    if epilogue_flops:
        t += epilogue_flops / target.peak_flops_fp32
    return t


def traffic_bounds(levels, maps, block_bytes) -> tuple[float, float]:
    """(compulsory, no-reuse) HBM bytes of a nest under the H100 rule:
    every block of every operand read once, or every CTA reading its own
    panels; the output written once either way."""
    w = _walk(levels, maps, block_bytes)
    out = w.n_ctas * w.block_bytes[-1]
    comp = reuse = 0.0
    for o, m in enumerate(w.maps[:-1]):
        panel = w.block_bytes[o] * _panel_blocks(w, m)
        comp += len(np.unique(_panel_ids(w, m))) * panel
        reuse += w.n_ctas * panel
    return comp + out, reuse + out


def nest_levels(nest: LoopNest) -> list:
    """(letter, local trip, multiplier) of each level of a planned nest."""
    return [(l.letter, t, l.step // nest.innermost_step(l.letter))
            for l, t in zip(nest.levels, _local_trips(nest))]


def predict_levels(
    levels,
    maps,
    block_bytes,
    *,
    dtype,
    flops_per_body: float,
    tile_mnk: Optional[tuple[int, int, int]] = None,
    target: H100Target = H100Target(),
    epilogue_flops: float = 0.0,
    collective_time: float = 0.0,
    spec: str = "",
    mesh_notes: tuple = (),
) -> PerfReport:
    """The H100 rule on one nest given by its levels ((letter, local trip,
    multiplier) outer→inner), the operands' letter tuples (the output last)
    and their block bytes: what ``predict`` computes for an
    ``H100Target``, without a planned nest."""
    db = dtype_bytes(dtype)
    w = _walk(levels, maps, block_bytes)
    notes = list(mesh_notes)
    total_steps = math.prod(t for _l, t, _m in w.levels)
    wave = _wave_blocks(w, target, db)
    misses = _misses(w, wave, target.l2_bytes)
    fetches = {o: int(m) for o, m in enumerate(misses)}
    fetches[len(w.maps) - 1] = w.n_ctas
    hbm_bytes = float(sum(fetches[o] * w.block_bytes[o] for o in fetches))

    flops = flops_per_body * total_steps
    compute_time = h100_compute_time(flops, epilogue_flops, w.n_ctas, w.block_bytes[-1], db,
                                     tile_mnk, target)
    flops += epilogue_flops
    if not w.legal:
        notes.append("a reduction level outside an output level: no CTA owns its output "
                     "block (TPP102), the port launches no such plan")
        compute_time *= 1e3
    memory_time = hbm_bytes / target.hbm_bw
    total_time = max(compute_time, memory_time) + collective_time
    return PerfReport(
        spec=spec, total_steps=total_steps, flops=flops, hbm_bytes=hbm_bytes,
        compute_time=compute_time, memory_time=memory_time,
        collective_time=collective_time, total_time=total_time,
        gflops=flops / total_time / 1e9, fetches=fetches, notes=tuple(notes))


def _collective(nest, out_map, db, reduction_letters, bw) -> float:
    t = 0.0
    for lvl in nest.mesh_levels:
        if lvl.letter in reduction_letters:
            # ring all-reduce of the output tile: 2·(W-1)/W · bytes / bw
            full_out = _operand_block_bytes(nest, out_map, db)
            w = lvl.ways or 1
            t += 2 * (w - 1) / w * full_out / bw
    return t


def _mesh_notes(nest) -> list[str]:
    # concurrency sanity (paper: flag poor parallel schedules)
    return [f"level {lvl.letter!r}: {lvl.ways} ways > trip {lvl.trip_count} — idle devices"
            for lvl in nest.mesh_levels if (lvl.ways or 1) > lvl.trip_count]


def predict(
    nest: LoopNest,
    in_maps: Sequence[TensorMap],
    out_map: TensorMap,
    *,
    dtype,
    flops_per_body: float,
    tile_mnk: Optional[tuple[int, int, int]] = None,
    target=H100Target(),
    reduction_letters: Sequence[str] = (),
    epilogue_flops: float = 0.0,
    scratch_bytes: float = 0.0,
    mode: str = "analytic",
    trace_limit: int = 2_000_000,
) -> PerfReport:
    """Predict the execution profile of one device's share of the nest
    under ``target`` (module docstring).

    ``epilogue_flops`` is the total elementwise work of TPPs fused onto the
    contraction's output tiles (``fusion``); its operands' traffic is
    captured by passing their TensorMaps in ``in_maps``.  ``scratch_bytes``
    is the kernel's on-chip scratch, counted against a ``TpuTarget``'s VMEM
    (the H100 kernels keep their accumulators in registers and pick their
    own tiles).  ``mode`` ("analytic" or "trace") and ``trace_limit``
    choose a ``TpuTarget``'s walk; an ``H100Target`` has one rule."""
    db = dtype_bytes(dtype)
    all_maps = list(in_maps) + [out_map]
    block_bytes = [_operand_block_bytes(nest, tm, db) for tm in all_maps]
    if isinstance(target, H100Target):
        return predict_levels(
            nest_levels(nest), [tm.letters for tm in all_maps], block_bytes, dtype=dtype,
            flops_per_body=flops_per_body, tile_mnk=tile_mnk, target=target,
            epilogue_flops=epilogue_flops,
            collective_time=_collective(nest, out_map, db, reduction_letters, target.link_bw),
            spec=nest.spec.raw,
            mesh_notes=tuple(_mesh_notes(nest)))
    if not isinstance(target, TpuTarget):
        raise TypeError(f"unknown target {type(target).__name__}")
    trips = _local_trips(nest)
    total_steps = math.prod(trips)
    notes: list[str] = []

    # ---- HBM traffic ----------------------------------------------------
    fetches: dict[int, int] = {}
    if mode == "trace" and total_steps <= trace_limit:
        # Paper-faithful LRU walk.  Budget: VMEM minus double buffers.
        resident_budget = max(
            0, target.vmem_bytes - 2 * sum(block_bytes) - int(scratch_bytes)
        )
        lru: OrderedDict = OrderedDict()
        lru_bytes = 0
        idx = [0] * len(trips)
        maps_terms = []
        for tm in all_maps:
            terms = []
            for letter in tm.letters:
                if letter is None:
                    terms.append(())
                else:
                    inner = nest.innermost_step(letter)
                    terms.append(tuple(
                        (pos, lvl.step // inner)
                        for pos, lvl in enumerate(nest.levels)
                        if lvl.letter == letter
                    ))
            maps_terms.append(terms)
        counts = [0] * len(all_maps)
        last_bid = [None] * len(all_maps)
        for _ in range(total_steps):
            for oi, terms in enumerate(maps_terms):
                bid = (oi,) + tuple(
                    sum(idx[pos] * mult for pos, mult in term) for term in terms
                )
                if bid == last_bid[oi]:
                    continue  # pipeline keeps the current block resident
                last_bid[oi] = bid
                if bid in lru:
                    lru.move_to_end(bid)
                    continue
                counts[oi] += 1
                lru[bid] = block_bytes[oi]
                lru_bytes += block_bytes[oi]
                while lru_bytes > resident_budget and lru:
                    _, b = lru.popitem(last=False)
                    lru_bytes -= b
            # mixed-radix increment (last dim fastest)
            for d in range(len(trips) - 1, -1, -1):
                idx[d] += 1
                if idx[d] < trips[d]:
                    break
                idx[d] = 0
        fetches = {i: c for i, c in enumerate(counts)}
    else:
        if mode == "trace":
            notes.append(f"grid too large for trace ({total_steps} steps); analytic")
        for oi, tm in enumerate(all_maps):
            pmax = _p_max(nest, tm)
            f = math.prod(trips[: pmax + 1]) if pmax >= 0 else 1
            fetches[oi] = f

    hbm_bytes = float(sum(fetches[i] * block_bytes[i] for i in fetches))
    # Output write-back traffic: one store per distinct output visit epoch.
    hbm_bytes += fetches[len(all_maps) - 1] * block_bytes[-1]

    # ---- compute ---------------------------------------------------------
    flops = flops_per_body * total_steps
    eff = mxu_efficiency(*tile_mnk) if tile_mnk else 1.0
    peak = target.peak_flops(db) * eff
    compute_time = flops / peak
    if epilogue_flops:
        compute_time += epilogue_flops / target.vpu_flops
        flops += epilogue_flops

    # ---- VMEM feasibility -------------------------------------------------
    ws = 2 * sum(block_bytes) + scratch_bytes
    if ws > target.vmem_bytes:
        notes.append(
            f"working set {ws/2**20:.1f}MiB exceeds VMEM "
            f"{target.vmem_bytes/2**20:.0f}MiB — schedule infeasible"
        )
        compute_time *= 1e3  # hard penalty, the paper assigns a low score

    memory_time = hbm_bytes / target.hbm_bw
    dma_overhead = sum(fetches.values()) * target.dma_latency

    # ---- collectives (mesh split-K) ---------------------------------------
    collective_time = _collective(nest, out_map, db, reduction_letters, target.ici_bw)
    notes += _mesh_notes(nest)

    total_time = max(compute_time, memory_time) + dma_overhead + collective_time
    return PerfReport(
        spec=nest.spec.raw,
        total_steps=total_steps,
        flops=flops,
        hbm_bytes=hbm_bytes,
        compute_time=compute_time,
        memory_time=memory_time,
        collective_time=collective_time,
        total_time=total_time,
        gflops=flops / total_time / 1e9,
        fetches=fetches,
        notes=tuple(notes),
    )
