"""Auto-tuning of loop_spec_strings (paper §II-D), a port of
``repro/core/autotune.py`` that scores against the card the port runs on
(``perf_model.H100Target``, the default) or, for parity with the
reference, its ``TpuTarget``.

Candidate generation follows the paper's constraint grammar exactly:

  1. per-loop blocking-level caps (multi-level memory hierarchy);
  2. blocking factors = prefix products of the prime factorization of the
     loop trip count, times the base step;
  3. only race-free loops are parallelizable (any blocked occurrence);
  4. all permutations of the resulting occurrence multiset.

The paper's headline tuning claim (§V-A2: ~1000 configs in seconds, 2.3–500×
faster than TVM) holds only if generation and scoring are themselves cheap,
so the search pipeline streams (see docs/autotuning.md):

  * **streaming generation** — blocking chains are legality-filtered *before*
    permutation expansion and candidates are emitted lazily, so
    ``max_candidates`` bounds work done, not just work kept;
  * **bound-based pruning** — each blocking combo (a *family* of loop-order
    permutations) gets a roofline score upper bound computed without planning
    a single nest; families that cannot beat the current top-k are skipped
    wholesale (the bound is provably ≥ every member's analytic score, so the
    model argmax is never dropped — property-tested);
  * **batched scoring** — surviving candidates are scored in batches:
    under a ``TpuTarget`` with ``perf_model.predict_batch`` (numpy over
    trips/p_max/block-bytes arrays), under an ``H100Target`` with
    ``perf_model.predict_levels`` on each candidate's levels (the L2 walk
    of its visit order); under a ``TpuTarget`` the ``trace`` mode of
    ``predict`` remains the validation oracle.  An H100 family's bound is
    its compulsory traffic (every operand block read once) against its
    compute time, which no member's prediction undercuts; H100 candidates
    of one score rank by their predicted HBM bytes (``_rank_key``);
  * **persistent schedule cache** — results are stored on disk
    (``core.tunecache``, the port's own directory) keyed on the full search
    identity, the target among it, so a second process re-tuning the same
    nest returns without generating a candidate.

``strategy="exhaustive"`` keeps the materialize-then-score pipeline as the
equivalence baseline (same candidate set, same tie-broken ranking).

Mesh decompositions (``{axis:N}``) are generated and scored as in the
reference; nothing launches one on the card yet (``LegalityError``).
A ``measure_fn`` that fails raises out of the search: nothing re-ranks
around a measurement that did not happen.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import random
import time
from typing import Callable, Optional, Sequence

from repro_torch.core import perf_model, tunecache
from repro_torch.core.cuda_lowering import TensorMap
from repro_torch.core.loops import LegalityError, LoopSpec, ThreadedLoop, loop_signature
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = [
    "prime_factors", "prefix_product_blockings", "generate_candidates",
    "iter_candidates", "Candidate", "TuneResult", "SearchStats",
    "autotune", "autotune_with_stats", "cached_threaded_loop",
    "reduction_inside_outputs",
]


def prime_factors(n: int) -> list[int]:
    out, d = [], 2
    while d * d <= n:
        while n % d == 0:
            out.append(d)
            n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def prefix_product_blockings(trip: int, step: int) -> list[int]:
    """Blocking factors = step × prefix products of the prime factorization of
    the trip count (paper §II-D constraint 2).  Excludes the trivial full-trip
    prefix (no blocking)."""
    pf = prime_factors(trip)
    out, acc = [], 1
    for p in pf[:-1]:
        acc *= p
        out.append(step * acc)
    return sorted(set(out))


@dataclasses.dataclass(frozen=True)
class Candidate:
    spec_string: str
    loops: tuple[LoopSpec, ...]


@dataclasses.dataclass
class TuneResult:
    candidate: Candidate
    report: perf_model.PerfReport
    measured_s: Optional[float] = None

    @property
    def score(self) -> float:
        return self.report.gflops


@dataclasses.dataclass
class SearchStats:
    """Throughput accounting for one search (see docs/autotuning.md)."""

    strategy: str = "streaming"
    families_total: int = 0
    families_pruned: int = 0      # whole permutation families skipped by bound
    families_illegal: int = 0     # mesh-ways/extent conflicts at generation
    candidates_generated: int = 0  # spec strings actually materialized
    candidates_scored: int = 0
    # Distinct base loop orders inside bound-pruned classes.  A conservative
    # UNDERcount of skipped spec strings (each base order would also have
    # fanned out into parallelization variants), so `considered`-based
    # throughput figures understate the pruning win, never overstate it.
    candidates_pruned: int = 0
    candidates_filtered: int = 0  # rejected by the caller's spec_filter
    cache_hit: bool = False
    search_time_s: float = 0.0

    @property
    def considered(self) -> int:
        """Configurations the search disposed of — scored, filter-rejected,
        or proven unable to win via the family bound."""
        return (self.candidates_scored + self.candidates_filtered
                + self.candidates_pruned)


def _chain_is_legal(chain: tuple[int, ...], extent: int, step: int) -> bool:
    """Outer→inner block steps admissible for a loop of (extent, step): the
    outermost step divides the extent, each step divides the next outer one,
    and the innermost blocking is a multiple of the base step — checked at
    generation time instead of via ``LegalityError`` after permutation
    expansion."""
    if not chain:
        return True
    if extent % chain[0]:
        return False
    for outer, inner in zip(chain, chain[1:]):
        if outer % inner:
            return False
    return chain[-1] % step == 0


def _blocking_choices(loop: LoopSpec, max_levels: int) -> list[tuple[int, ...]]:
    """All legal (outer→inner) block-step tuples with 0..max_levels-1
    blockings.  Illegal chains are pruned here, before they can fan out into
    permutation families."""
    trip = loop.extent // loop.step
    opts = prefix_product_blockings(trip, loop.step)
    choices: list[tuple[int, ...]] = [()]
    for k in range(1, max_levels):
        for combo in itertools.combinations(opts, k):
            chain = tuple(sorted(combo, reverse=True))  # outer→inner
            if _chain_is_legal(chain, loop.extent, loop.step):
                choices.append(chain)
    return choices


def _multiset_permutations(items: Sequence[str]):
    """Distinct permutations of a multiset, lexicographic, O(n) memory —
    replaces ``set(itertools.permutations(...))`` which materializes n!
    tuples before deduplicating."""
    seq = sorted(items)
    n = len(seq)
    if n == 0:
        return
    while True:
        yield tuple(seq)
        i = n - 2
        while i >= 0 and seq[i] >= seq[i + 1]:
            i -= 1
        if i < 0:
            return
        j = n - 1
        while seq[j] <= seq[i]:
            j -= 1
        seq[i], seq[j] = seq[j], seq[i]
        seq[i + 1:] = reversed(seq[i + 1:])


def _multiset_perm_count(counts: Sequence[int]) -> int:
    n = math.factorial(sum(counts))
    for c in counts:
        n //= math.factorial(c)
    return n


@dataclasses.dataclass
class _Family:
    """One blocking combo = one family of loop-order permutations.  Everything
    score-relevant that is shared by the whole family lives here, so the
    pruning bound needs no per-permutation work."""

    loops: tuple[LoopSpec, ...]         # block_steps applied
    multiset: tuple[str, ...]           # letters with occurrence repetition
    trips: dict                         # letter -> per-depth local trip counts
    perm_count: int


def _iter_families(
    loops: Sequence[LoopSpec],
    letters: Sequence[str],
    max_blockings: Sequence[int],
    mesh_decomp: Sequence[tuple[str, str, int]],
    seed: int,
):
    """Yield (family, illegal: bool) per blocking combo, combos visited in the
    seeded shuffle order (diverse sampling under ``max_candidates``)."""
    rng = random.Random(seed)
    per_loop = [_blocking_choices(loop, cap)
                for loop, cap in zip(loops, max_blockings)]
    combos = list(itertools.product(*per_loop))
    rng.shuffle(combos)
    for combo in combos:
        new_loops = tuple(
            dataclasses.replace(loop, block_steps=bs)
            for loop, bs in zip(loops, combo)
        )
        multiset: list[str] = []
        trips: dict[str, list[int]] = {}
        for letter, loop, bs in zip(letters, loops, combo):
            occ = len(bs) + 1
            multiset.extend([letter] * occ)
            steps = bs + (loop.step,)
            t = [loop.extent // steps[0]]
            for outer, inner in zip(steps, steps[1:]):
                t.append(outer // inner)
            trips[letter] = t
        illegal = False
        for (letter, _axis, ways) in mesh_decomp:
            # decomposition lands on the outermost occurrence of `letter`
            if trips[letter][0] % ways:
                illegal = True
                break
            trips[letter] = [trips[letter][0] // ways] + trips[letter][1:]
        counts = [len(bs) + 1 for bs in combo]
        yield _Family(new_loops, tuple(multiset), trips,
                      _multiset_perm_count(counts)), illegal


def _decorate_mesh(s: str, mesh_decomp) -> str:
    """Attach ``{axis:N}`` to the outermost occurrence of each decomposed
    letter (uppercasing it — an explicit decomposition implies
    parallelization, mirroring the parser)."""
    for (letter, axis, ways) in mesh_decomp:
        i = s.lower().find(letter)
        if i >= 0:
            s = s[:i] + s[i].upper() + f"{{{axis}:{ways}}}" + s[i + 1:]
    return s


def _variants(base: str, parallel_letters: Sequence[str]):
    """All parallelization variants of one base permutation, paper rule 3:
    the base itself, any single blocked occurrence of a parallelizable letter
    uppercased, and collapse-style pairs of adjacent distinct parallel
    letters.  Yields (spec_sans_mesh, parallel_positions)."""
    yield base, ()
    for pl1 in parallel_letters:
        for i, ch in enumerate(base):
            if ch == pl1:
                yield base[:i] + ch.upper() + base[i + 1:], (i,)
    for i in range(len(base) - 1):
        a, b = base[i], base[i + 1]
        if a in parallel_letters and b in parallel_letters and a != b:
            yield (base[:i] + a.upper() + b.upper() + base[i + 2:], (i, i + 1))


def iter_candidates(
    loops: Sequence[LoopSpec],
    *,
    max_blockings: Sequence[int],
    parallel_letters: Sequence[str] = (),
    mesh_decomp: Sequence[tuple[str, str, int]] = (),
    max_candidates: Optional[int] = None,
    seed: int = 0,
    reduction_letters: Sequence[str] = (),
):
    """Stream spec-string candidates under the paper's constraints 1–4.

    Lazy counterpart of :func:`generate_candidates`: blocking chains are
    legality-filtered before permutation expansion and candidates are emitted
    incrementally, so a ``max_candidates`` bound limits the work *done*.  With
    ``reduction_letters`` given, variants that would parallelize a reduction
    occurrence (a guaranteed ``LegalityError`` downstream) are skipped at
    generation time."""
    letters = [chr(ord("a") + i) for i in range(len(loops))]
    par = tuple(l for l in parallel_letters if l not in reduction_letters)
    emitted = 0
    for family, illegal in _iter_families(
            loops, letters, max_blockings, mesh_decomp, seed):
        if illegal:
            continue
        for perm in _multiset_permutations(family.multiset):
            base = "".join(perm)
            seen = set() if mesh_decomp else None
            for spec, _ppos in _variants(base, par):
                if mesh_decomp:
                    spec = _decorate_mesh(spec, mesh_decomp)
                    if spec in seen:
                        continue
                    seen.add(spec)
                yield Candidate(spec, family.loops)
                emitted += 1
                if max_candidates is not None and emitted >= max_candidates:
                    return


def generate_candidates(
    loops: Sequence[LoopSpec],
    *,
    max_blockings: Sequence[int],
    parallel_letters: Sequence[str] = (),
    mesh_decomp: Sequence[tuple[str, str, int]] = (),
    max_candidates: int = 2000,
    seed: int = 0,
    reduction_letters: Sequence[str] = (),
) -> list[Candidate]:
    """Enumerate spec strings under the paper's constraints 1–4 (materialized
    view of :func:`iter_candidates`)."""
    return list(iter_candidates(
        loops, max_blockings=max_blockings, parallel_letters=parallel_letters,
        mesh_decomp=mesh_decomp, max_candidates=max_candidates, seed=seed,
        reduction_letters=reduction_letters))


def _generate_candidates_exhaustive(
    loops: Sequence[LoopSpec],
    *,
    max_blockings: Sequence[int],
    parallel_letters: Sequence[str] = (),
    mesh_decomp: Sequence[tuple[str, str, int]] = (),
    max_candidates: Optional[int] = None,
    seed: int = 0,
) -> list[Candidate]:
    """The pre-streaming pipeline, kept as the equivalence/throughput
    baseline: materialize every permutation, legality-check each candidate by
    planning a full ``ThreadedLoop``, shuffle for sampling diversity.  (One
    fix over the original: the dedup set is per-family — identical spec
    strings from *different* blocking combos are distinct schedules.)"""
    letters = [chr(ord("a") + i) for i in range(len(loops))]
    rng = random.Random(seed)

    per_loop: list[list[tuple[int, ...]]] = [
        _blocking_choices(loop, cap)
        for loop, cap in zip(loops, max_blockings)
    ]
    candidates: list[Candidate] = []
    combos = list(itertools.product(*per_loop))
    rng.shuffle(combos)
    for combo in combos:
        new_loops = tuple(
            dataclasses.replace(loop, block_steps=bs)
            for loop, bs in zip(loops, combo)
        )
        multiset = []
        for letter, bs in zip(letters, combo):
            multiset.extend([letter] * (len(bs) + 1))
        perms = set(itertools.permutations(multiset))
        perms = sorted("".join(p) for p in perms)
        rng.shuffle(perms)
        seen: set[str] = set()
        for base in perms:
            for v, _ppos in _variants(base, parallel_letters):
                s = _decorate_mesh(v, mesh_decomp)
                if s in seen:
                    continue
                seen.add(s)
                try:
                    ThreadedLoop(new_loops, s)  # legality check
                except (LegalityError, ValueError):
                    continue
                candidates.append(Candidate(s, new_loops))
                if max_candidates is not None and \
                        len(candidates) >= max_candidates:
                    return candidates
    return candidates


# --------------------------------------------------------------------------
# Plan cache — the paper's "cache the JITed target loops" (§II-B).
# --------------------------------------------------------------------------
_PLAN_CACHE: dict = {}


def _freeze(v):
    """Normalize kwarg values into hashable keys (lists/sets of letters are a
    natural way to pass ``reduction_letters`` and must not crash the cache;
    ``fusion.lowering.compile_for_device`` keys its schedules with it)."""
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, (set, frozenset)):
        return tuple(sorted(_freeze(x) for x in v))
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    return v


def cached_threaded_loop(loops: Sequence[LoopSpec], spec: str, **kw) -> ThreadedLoop:
    key = (loop_signature(loops), spec,
           tuple(sorted((k, _freeze(v)) for k, v in kw.items())))
    tl = _PLAN_CACHE.get(key)
    if tl is None:
        tl = ThreadedLoop(loops, spec, **kw)
        _PLAN_CACHE[key] = tl
    return tl


# --------------------------------------------------------------------------
# Streaming search internals
# --------------------------------------------------------------------------

class _RevStr(str):
    """String with reversed ordering, so a min-heap keyed on (score, tie,
    spec) evicts the lexicographically *largest* spec among equal scores —
    matching the final (-score, tie, spec) ranking used for deterministic
    tie-breaks."""
    __slots__ = ()

    def __lt__(self, other):
        return str.__gt__(self, other)

    def __gt__(self, other):
        return str.__lt__(self, other)

    def __le__(self, other):
        return str.__ge__(self, other)

    def __ge__(self, other):
        return str.__le__(self, other)


def reduction_inside_outputs(perm, mesh_pos, out_letters=("b", "c"),
                             reduction=("a",)) -> bool:
    """Whether a candidate's occurrence sequence keeps every reduction
    level inside every output level (mesh levels aside): the
    generation-time form of ``validate_reduction_innermost``, the rule by
    which one CTA owns each output block of a port kernel's plan."""
    mesh = set(mesh_pos)
    out_pos = [i for i, ch in enumerate(perm) if ch in out_letters and i not in mesh]
    red_pos = [i for i, ch in enumerate(perm) if ch in reduction and i not in mesh]
    return not (out_pos and red_pos and min(red_pos) < max(out_pos))


def _static_block_bytes(loops, tm: TensorMap, db: int) -> int:
    """``perf_model._operand_block_bytes`` without a planned nest: the
    innermost occurrence of every letter always advances by the loop's base
    step, so block bytes are schedule-invariant for a declared nest."""
    n = 1
    for letter, t in zip(tm.letters, tm.tile):
        nblocks = 1 if letter is None else loops[ord(letter) - ord("a")].step
        n *= nblocks * t
    return n * db


def _class_score_bounds(
    family: _Family,
    op_letter_sets: Sequence[frozenset],
    block_bytes: Sequence[int],
    *,
    compute_time: float,
    flops_total: float,
    target: perf_model.TpuTarget,
    collective_time: float,
) -> dict:
    """Per innermost-letter class, an upper bound on the analytic score of
    any permutation in the family whose deepest level carries that letter.

    Two facts make the bound cheap and sound without planning a nest:

      * an operand's fetches are ≥ the product of the trips of the levels
        whose letters index it (those levels are ≤ p_max in every order, and
        dropping the remaining trips only shrinks the product) — and that
        product is just the operand's index-space extent;
      * every operand indexed by the *innermost* level's letter has
        p_max = L-1, i.e. fetches exactly ``total_steps`` — which is what
        separates output-stationary orders from operand-thrashing ones.

    HBM traffic, DMA overhead — and hence total time — are bounded below per
    class; compute time, the VMEM penalty, and the mesh collective are
    permutation-invariant exactly.  Families/classes whose bound cannot beat
    the running top-k are skipped wholesale, so the model argmax is never
    dropped (property-tested)."""
    letter_prod = {l: math.prod(t) for l, t in family.trips.items()}
    total_steps = math.prod(letter_prod.values())
    min_fetch = [
        math.prod(letter_prod[l] for l in ls) if ls else 1.0
        for ls in op_letter_sets
    ]
    bounds = {}
    for x in sorted(set(family.multiset)):
        fetch_lb = [
            total_steps if x in ls else f
            for ls, f in zip(op_letter_sets, min_fetch)
        ]
        hbm_lb = sum(f * b for f, b in zip(fetch_lb, block_bytes))
        hbm_lb += fetch_lb[-1] * block_bytes[-1]     # output write-back
        dma_lb = sum(fetch_lb) * target.dma_latency
        time_lb = (max(compute_time, hbm_lb / target.hbm_bw)
                   + dma_lb + collective_time)
        bounds[x] = flops_total / time_lb / 1e9
    return bounds


def _family_bound_h100(
    family: _Family,
    op_letter_sets: Sequence[frozenset],
    block_bytes: Sequence[int],
    *,
    db: int,
    flops_per_body: float,
    tile_mnk,
    epilogue_flops: float,
    target: perf_model.H100Target,
    collective_time: float,
) -> float:
    """An upper bound on the H100 score of every member of a family: its
    compute time (fixed by its blocks) against its compulsory traffic,
    every operand block read once and every output block written once,
    which no walk of the family reads less than."""
    letter_prod = {l: math.prod(t) for l, t in family.trips.items()}
    total_steps = math.prod(letter_prod.values())
    n_ctas = math.prod(letter_prod[l] for l in op_letter_sets[-1])
    compulsory = sum(math.prod(letter_prod[l] for l in ls) * b
                     for ls, b in zip(op_letter_sets[:-1], block_bytes[:-1]))
    compulsory += n_ctas * block_bytes[-1]
    flops = flops_per_body * total_steps
    compute = perf_model.h100_compute_time(flops, epilogue_flops, n_ctas, block_bytes[-1], db,
                                           tile_mnk, target)
    time_lb = max(compute, compulsory / target.hbm_bw) + collective_time
    return (flops + epilogue_flops) / time_lb / 1e9


def _levels_row(perm, family: _Family) -> list:
    """(letter, local trip, multiplier) of each level of one permutation of
    a family, as ``perf_model.nest_levels`` reads a planned nest."""
    row, depth = [], {}
    for ch in perm:
        d = depth.get(ch, 0)
        depth[ch] = d + 1
        row.append((ch, family.trips[ch][d], math.prod(family.trips[ch][d + 1:])))
    return row


def _rank_key(target):
    """Best first: the higher score; under an ``H100Target`` then the
    fewer predicted HBM bytes (the roofline ties every compute-bound
    schedule of a nest, the L2 walk does not); then the spec string."""
    h100 = isinstance(target, perf_model.H100Target)
    return lambda r: (-r.score, r.report.hbm_bytes if h100 else 0.0, r.candidate.spec_string)


def _search_streaming(
    loops, in_maps, out_map, *, dtype, flops_per_body, tile_mnk,
    reduction_letters, epilogue_flops, scratch_bytes, max_blockings,
    parallel_letters, mesh_decomp, target, max_candidates, seed,
    top_k, batch_size, spec_filter, validate_fn, stats: SearchStats,
):
    import numpy as np

    letters = [chr(ord("a") + i) for i in range(len(loops))]
    par = tuple(l for l in parallel_letters if l not in reduction_letters)
    all_maps = list(in_maps) + [out_map]
    map_letters = [tm.letters for tm in all_maps]
    db = perf_model.dtype_bytes(dtype)
    block_bytes = [_static_block_bytes(loops, tm, db) for tm in all_maps]
    op_letter_sets = [
        frozenset(l for l in tm.letters if l is not None) for tm in all_maps
    ]
    h100 = isinstance(target, perf_model.H100Target)

    # Permutation-invariant terms, computed once.
    link_bw = target.link_bw if h100 else target.ici_bw
    if not h100:
        eff = perf_model.mxu_efficiency(*tile_mnk) if tile_mnk else 1.0
        compute_per_step = flops_per_body / (target.peak_flops(db) * eff)
        ws = 2 * sum(block_bytes) + scratch_bytes
        vmem_penalty = 1e3 if ws > target.vmem_bytes else 1.0
    collective_time = 0.0
    allow_races = False
    for (letter, _axis, ways) in mesh_decomp:
        if letter in reduction_letters:
            allow_races = True  # mesh split-K: combined via psum at lowering
            collective_time += (2 * (ways - 1) / ways
                                * block_bytes[-1] / link_bw)

    # A validator with no generation-time filter rejects candidates only
    # after they have crowded the heap and raised the pruning threshold —
    # so in that configuration keep a much deeper heap and disable bound
    # pruning (scores of invalid candidates must not prune valid families).
    # Callers wanting pruned searches pair validate_fn with a spec_filter
    # that rejects the same schedules up front (as autotune_graph does).
    unfiltered_validator = validate_fn is not None and spec_filter is None
    if validate_fn is None:
        heap_cap = top_k
    elif unfiltered_validator:
        heap_cap = max(4 * top_k, top_k + 32)
    else:
        heap_cap = top_k + 8
    pruning_enabled = not unfiltered_validator
    heap: list = []   # (score, tie, _RevStr(spec), seq, spec, loops)
    seq = itertools.count()
    pending_rows: list = []   # (spec, loops, trips_row, pmax_row, levels_row)

    def flush():
        if not pending_rows:
            return
        if h100:
            reps = [perf_model.predict_levels(
                lrow, map_letters, block_bytes, dtype=dtype,
                flops_per_body=flops_per_body, tile_mnk=tile_mnk, target=target,
                epilogue_flops=epilogue_flops, collective_time=collective_time)
                for _s, _l, _t, _p, lrow in pending_rows]
            scores = [r.gflops for r in reps]
            ties = [-r.hbm_bytes for r in reps]
        else:
            L = max(len(r[2]) for r in pending_rows)
            trips = np.ones((len(pending_rows), L), dtype=np.int64)
            pmax = np.empty((len(pending_rows), len(all_maps)), dtype=np.int64)
            for i, (_s, _l, trow, prow, _lv) in enumerate(pending_rows):
                trips[i, :len(trow)] = trow
                pmax[i] = prow
            scores = perf_model.predict_batch(
                trips, pmax, block_bytes, dtype=dtype,
                flops_per_body=flops_per_body, tile_mnk=tile_mnk, target=target,
                epilogue_flops=epilogue_flops, scratch_bytes=scratch_bytes,
                collective_time=collective_time)["gflops"]
            ties = [0.0] * len(pending_rows)
        for i, (spec, floops, _t, _p, _lv) in enumerate(pending_rows):
            item = (float(scores[i]), ties[i], _RevStr(spec), next(seq), spec, floops)
            if len(heap) < heap_cap:
                heapq.heappush(heap, item)
            elif item[:3] > heap[0][:3]:
                heapq.heappushpop(heap, item)
        stats.candidates_scored += len(pending_rows)
        pending_rows.clear()

    emitted = 0
    done = False
    for family, illegal in _iter_families(
            loops, letters, max_blockings, mesh_decomp, seed):
        if done:
            break
        stats.families_total += 1
        if illegal:
            stats.families_illegal += 1
            continue
        bounds = None
        if pruning_enabled and len(heap) == heap_cap and h100:
            bound = _family_bound_h100(
                family, op_letter_sets, block_bytes, db=db,
                flops_per_body=flops_per_body, tile_mnk=tile_mnk,
                epilogue_flops=epilogue_flops, target=target,
                collective_time=collective_time)
            bounds = dict.fromkeys(family.multiset, bound)
        elif pruning_enabled and len(heap) == heap_cap:
            # Permutation-invariant terms of this family.  The VMEM penalty
            # multiplies compute *including* the VPU epilogue time, mirroring
            # predict().
            total_steps = math.prod(
                math.prod(t) for t in family.trips.values())
            compute_time = (compute_per_step * total_steps
                            + epilogue_flops / target.vpu_flops) * vmem_penalty
            flops_total = flops_per_body * total_steps + epilogue_flops
            bounds = _class_score_bounds(
                family, op_letter_sets, block_bytes,
                compute_time=compute_time, flops_total=flops_total,
                target=target, collective_time=collective_time)
        counts = {l: family.multiset.count(l) for l in set(family.multiset)}
        any_class_ran = False
        for x in sorted(counts):
            class_count = _multiset_perm_count(
                [c - (l == x) for l, c in sorted(counts.items())])
            if bounds is not None and bounds[x] < heap[0][0]:
                stats.candidates_pruned += class_count
                continue
            any_class_ran = True
            rest = list(family.multiset)
            rest.remove(x)
            for perm in (p + (x,) for p in _multiset_permutations(rest)):
                base = "".join(perm)
                trow = []
                depth: dict[str, int] = {}
                for ch in perm:
                    d = depth.get(ch, 0)
                    depth[ch] = d + 1
                    trow.append(family.trips[ch][d])
                prow = []
                for ls in op_letter_sets:
                    p = -1
                    for pos in range(len(perm) - 1, -1, -1):
                        if perm[pos] in ls:
                            p = pos
                            break
                    prow.append(p)
                lrow = _levels_row(perm, family) if h100 else None
                mesh_first = {}
                if mesh_decomp:
                    for (letter, _axis, _ways) in mesh_decomp:
                        mesh_first[letter] = base.find(letter)
                seen = set() if mesh_decomp else None
                for spec, ppos in _variants(base, par):
                    if mesh_decomp:
                        spec = _decorate_mesh(spec, mesh_decomp)
                        if spec in seen:
                            continue
                        seen.add(spec)
                    stats.candidates_generated += 1
                    if spec_filter is not None:
                        mesh_pos = tuple(mesh_first.values())
                        par_pos = tuple(ppos) + mesh_pos
                        if not spec_filter(perm, par_pos, mesh_pos):
                            stats.candidates_filtered += 1
                            continue
                    pending_rows.append((spec, family.loops, trow, prow, lrow))
                    if len(pending_rows) >= batch_size:
                        flush()
                    emitted += 1
                    if max_candidates is not None and emitted >= max_candidates:
                        done = True
                        break
                if done:
                    break
            if done:
                break
        if not any_class_ran:
            stats.families_pruned += 1
    flush()

    # Plan + fully re-predict only the survivors: exact PerfReports (notes,
    # fetch dicts) and a cross-check of the batched scores.
    ranked = sorted(heap, key=lambda it: (-it[0], -it[1], it[4]))
    results: list[TuneResult] = []
    for _score, _tie, _rev, _seq, spec, floops in ranked:
        try:
            tl = cached_threaded_loop(
                floops, spec, reduction_letters=reduction_letters,
                allow_races=allow_races)
            if validate_fn is not None:
                validate_fn(tl)
        except (LegalityError, ValueError):
            continue
        rep = perf_model.predict(
            tl.nest, in_maps, out_map, dtype=dtype,
            flops_per_body=flops_per_body, tile_mnk=tile_mnk, target=target,
            reduction_letters=reduction_letters,
            epilogue_flops=epilogue_flops, scratch_bytes=scratch_bytes)
        results.append(TuneResult(Candidate(spec, floops), rep))
        if len(results) >= top_k:
            break
    results.sort(key=_rank_key(target))
    return results


def _search_exhaustive(
    loops, in_maps, out_map, *, dtype, flops_per_body, tile_mnk,
    reduction_letters, epilogue_flops, scratch_bytes, max_blockings,
    parallel_letters, mesh_decomp, target, max_candidates, seed,
    top_k, validate_fn, stats: SearchStats,
):
    allow_races = any(l in reduction_letters for (l, _a, _w) in mesh_decomp)
    cands = _generate_candidates_exhaustive(
        loops, max_blockings=max_blockings, parallel_letters=parallel_letters,
        mesh_decomp=mesh_decomp, max_candidates=max_candidates, seed=seed)
    stats.candidates_generated = len(cands)
    results = []
    for c in cands:
        try:
            tl = cached_threaded_loop(
                c.loops, c.spec_string, reduction_letters=reduction_letters,
                allow_races=allow_races)
            if validate_fn is not None:
                validate_fn(tl)
        except (LegalityError, ValueError):
            stats.candidates_filtered += 1
            continue
        rep = perf_model.predict(
            tl.nest, in_maps, out_map,
            dtype=dtype, flops_per_body=flops_per_body, tile_mnk=tile_mnk,
            target=target, reduction_letters=reduction_letters,
            epilogue_flops=epilogue_flops, scratch_bytes=scratch_bytes)
        results.append(TuneResult(c, rep))
        stats.candidates_scored += 1
    results.sort(key=_rank_key(target))
    if top_k is not None:
        results = results[:top_k]
    return results


# --------------------------------------------------------------------------
# Persistent-cache plumbing
# --------------------------------------------------------------------------

_CACHE_STORE_K = 32

# --- persistent-key completeness contract (TPP301) -------------------------
# Every parameter of ``autotune_with_stats`` must appear in exactly one of
# these two sets (tests/test_torch_autotune.py checks it).  TUNE_KEY_PARAMS
# are hashed into the persistent cache key; TUNE_KEY_EXEMPT parameters are
# documented result-neutral or handled by a dedicated mechanism.  An
# unclassified knob would let two different searches collide on one cache
# entry.
TUNE_KEY_PARAMS = frozenset({
    "loops", "in_maps", "out_map",            # keyed via loop_signature/maps
    "dtype", "flops_per_body", "tile_mnk", "reduction_letters",
    "epilogue_flops", "scratch_bytes", "max_blockings", "parallel_letters",
    "mesh_decomp", "target", "max_candidates", "seed", "strategy", "top_k",
    "cache_extra",                             # keyed as ``extra``
})
TUNE_KEY_EXEMPT = frozenset({
    # measured times re-rank on a hit and upgrade the stored entry in place
    # (see the measure_fn branch of the lookup path); the model ranking the
    # key protects is measurement-independent
    "measure_fn", "measure_top_k",
    # scoring batch size — identical results, different pipelining
    "batch_size",
    # unkeyed callables: searches using them skip the persistent cache
    # entirely unless a distinguishing cache_extra is supplied
    # (``hooks_unkeyed`` below)
    "spec_filter", "validate_fn",
    # cache plumbing, not search inputs
    "cache", "cache_dir", "use_cache",
})

# Component names of the persisted key, recorded in every stored entry as
# ``key_schema`` so that entries keyed under an older schema can be found
# and invalidated (TPP302).
TUNE_KEY_SCHEMA = (
    "loops", "maps", "dtype", "flops_per_body", "tile_mnk",
    "reduction_letters", "epilogue_flops", "scratch_bytes", "max_blockings",
    "parallel_letters", "mesh_decomp", "target", "max_candidates", "seed",
    "strategy", "top_k", "extra",
)


def _tune_cache_key(loops, in_maps, out_map, **params) -> str:
    all_maps = list(in_maps) + [out_map]
    assert set(params) | {"loops", "maps"} == set(TUNE_KEY_SCHEMA), \
        "tune-cache key components drifted from TUNE_KEY_SCHEMA — update " \
        "both together (and invalidate the entries keyed under the old one)"
    return tunecache.cache_key(
        loops=loop_signature(loops),
        maps=[(tm.letters, tm.tile, tm.layout) for tm in all_maps],
        **params,
    )


def _entry_from_results(results: Sequence[TuneResult],
                        stats: SearchStats) -> dict:
    return {
        "key_schema": list(TUNE_KEY_SCHEMA),
        "results": [
            {
                "spec": r.candidate.spec_string,
                "block_steps": [list(l.block_steps) for l in r.candidate.loops],
                "gflops": r.report.gflops,
                "measured_s": r.measured_s,
            }
            for r in results[:_CACHE_STORE_K]
        ],
        "stats": dataclasses.asdict(stats),
    }


def _results_from_entry(
    entry: dict, loops, in_maps, out_map, *, dtype, flops_per_body, tile_mnk,
    reduction_letters, epilogue_flops, scratch_bytes, target, allow_races,
) -> Optional[list[TuneResult]]:
    """Rebuild ranked TuneResults from a cache hit, preserving the stored
    order (measured entries stay ahead of model-ranked ones).  Any failure
    invalidates the hit — the caller falls through to a fresh search."""
    try:
        results = []
        for rec in entry["results"]:
            floops = tuple(
                dataclasses.replace(loop, block_steps=tuple(bs))
                for loop, bs in zip(loops, rec["block_steps"])
            )
            tl = cached_threaded_loop(
                floops, rec["spec"], reduction_letters=reduction_letters,
                allow_races=allow_races)
            rep = perf_model.predict(
                tl.nest, in_maps, out_map, dtype=dtype,
                flops_per_body=flops_per_body, tile_mnk=tile_mnk,
                target=target, reduction_letters=reduction_letters,
                epilogue_flops=epilogue_flops, scratch_bytes=scratch_bytes)
            results.append(TuneResult(
                Candidate(rec["spec"], floops), rep,
                measured_s=rec.get("measured_s")))
        return results
    except (LegalityError, ValueError, KeyError, TypeError):
        return None


def _measure_rerank(results, measure_fn, measure_top_k):
    top = results[:measure_top_k]
    for r in top:
        r.measured_s = measure_fn(r.candidate)
    top.sort(key=lambda r: r.measured_s)
    return top + results[measure_top_k:]


def autotune_with_stats(
    loops: Sequence[LoopSpec],
    in_maps: Sequence[TensorMap],
    out_map: TensorMap,
    *,
    dtype,
    flops_per_body: float,
    tile_mnk=None,
    reduction_letters: Sequence[str] = (),
    epilogue_flops: float = 0.0,
    scratch_bytes: float = 0.0,
    max_blockings: Optional[Sequence[int]] = None,
    parallel_letters: Sequence[str] = (),
    mesh_decomp: Sequence[tuple[str, str, int]] = (),
    target=perf_model.H100Target(),
    max_candidates: Optional[int] = 500,
    measure_fn: Optional[Callable[[Candidate], float]] = None,
    measure_top_k: int = 5,
    seed: int = 0,
    strategy: str = "streaming",
    top_k: Optional[int] = 32,
    batch_size: int = 512,
    spec_filter: Optional[Callable] = None,
    validate_fn: Optional[Callable[[ThreadedLoop], None]] = None,
    cache: Optional[tunecache.TuneCache] = None,
    cache_dir=None,
    use_cache: bool = True,
    cache_extra=(),
) -> tuple[list[TuneResult], SearchStats]:
    """Score candidate schedules; return (best-first results, search stats).

    See :func:`autotune` for the search semantics.  ``strategy`` selects the
    pipeline: ``"streaming"`` (lazy generation + bound pruning + batched
    scoring, results capped at ``top_k``) or ``"exhaustive"`` (the
    materialize-and-plan baseline).  With a persistent cache enabled
    (default), identical searches in later processes return immediately with
    ``stats.cache_hit`` set and zero candidates generated."""
    t0 = time.perf_counter()
    stats = SearchStats(strategy=strategy)
    if max_blockings is None:
        max_blockings = [2] * len(loops)
    allow_races = any(l in reduction_letters for (l, _a, _w) in mesh_decomp)

    tc = None
    key = None
    # Custom filters/validators change the result but cannot be hashed into
    # the cache key; without a distinguishing cache_extra, persisting would
    # let a differently-filtered search collide with this one — skip the
    # persistent cache in that configuration.
    hooks_unkeyed = (spec_filter is not None or validate_fn is not None) \
        and not cache_extra
    # Entries store at most _CACHE_STORE_K results; a search asking for more
    # could not round-trip through a hit, so it skips the persistent cache.
    cacheable_k = top_k is not None and top_k <= _CACHE_STORE_K
    if use_cache and cacheable_k and not hooks_unkeyed:
        if cache is not None:
            tc = cache
        elif cache_dir is not None:
            tc = tunecache.TuneCache(cache_dir)
        else:
            tc = tunecache.default_cache()
    if tc is not None:
        key = _tune_cache_key(
            loops, in_maps, out_map,
            dtype=perf_model.dtype_name(dtype), flops_per_body=flops_per_body,
            tile_mnk=tile_mnk, reduction_letters=tuple(reduction_letters),
            epilogue_flops=epilogue_flops, scratch_bytes=scratch_bytes,
            max_blockings=tuple(max_blockings),
            parallel_letters=tuple(parallel_letters),
            mesh_decomp=tuple(mesh_decomp),
            target=(type(target).__name__,) + dataclasses.astuple(target),
            max_candidates=max_candidates, seed=seed, strategy=strategy,
            top_k=top_k, extra=cache_extra)
        entry = tc.lookup(key)
        if entry is not None:
            results = _results_from_entry(
                entry, loops, in_maps, out_map, dtype=dtype,
                flops_per_body=flops_per_body, tile_mnk=tile_mnk,
                reduction_letters=reduction_letters,
                epilogue_flops=epilogue_flops, scratch_bytes=scratch_bytes,
                target=target, allow_races=allow_races)
            if results is not None:
                stats.cache_hit = True
                if measure_fn is not None and not any(
                        r.measured_s is not None for r in results):
                    results = _measure_rerank(results, measure_fn,
                                              measure_top_k)
                    # keep the producing search's stats on disk — the hit's
                    # stats (zero generated/scored) say nothing about cost
                    upgraded = _entry_from_results(results, stats)
                    upgraded["stats"] = entry.get("stats")
                    tc.store(key, upgraded)
                stats.search_time_s = time.perf_counter() - t0
                return results, stats

    common = dict(
        dtype=dtype, flops_per_body=flops_per_body, tile_mnk=tile_mnk,
        reduction_letters=tuple(reduction_letters),
        epilogue_flops=epilogue_flops, scratch_bytes=scratch_bytes,
        max_blockings=max_blockings,
        parallel_letters=tuple(parallel_letters),
        mesh_decomp=tuple(mesh_decomp), target=target,
        max_candidates=max_candidates, seed=seed, top_k=top_k,
        validate_fn=validate_fn, stats=stats,
    )
    obs_metrics.default_registry().counter("tune.searches").inc()
    with obs_trace.get_tracer().span(
            "tune.search", cat="tune", strategy=strategy,
            loops=loop_signature(loops), measured=measure_fn is not None) as sp:
        if strategy == "exhaustive":
            results = _search_exhaustive(loops, in_maps, out_map, **common)
        elif strategy == "streaming":
            if top_k is None:
                # without a result bound there is no pruning threshold; fall
                # back to scoring everything the stream yields
                common["top_k"] = 1 << 30
            results = _search_streaming(
                loops, in_maps, out_map, batch_size=batch_size,
                spec_filter=spec_filter, **common)
        else:
            raise ValueError(f"unknown search strategy {strategy!r}")

        if measure_fn is not None:
            results = _measure_rerank(results, measure_fn, measure_top_k)
        sp.set(results=len(results))
    stats.search_time_s = time.perf_counter() - t0
    if tc is not None and key is not None and results:
        tc.store(key, _entry_from_results(results, stats))
    return results, stats


def autotune(*args, **kw) -> list[TuneResult]:
    """Score candidate schedules; return them best-first.

    With ``measure_fn`` the top-k model-ranked candidates are re-ranked by
    measurement (the paper's finding — Fig. 6 — is that the model's top-5
    always contains the measured best); measured times persist in the tune
    cache and are preferred over model-ranked entries on later hits."""
    results, _stats = autotune_with_stats(*args, **kw)
    return results
