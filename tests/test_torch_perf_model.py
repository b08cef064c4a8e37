"""``repro_torch.core.perf_model`` against ``repro.core.perf_model`` on the
CPU, and the H100 rule on its own.

Under ``TpuTarget`` the port keeps the reference's arithmetic, so every
``PerfReport`` field is held equal to the reference's on the same nest
(``tests/test_perf_model.py``'s cases, each beside its reference).  Under
``H100Target`` (the port's default) the tests hold the rule's invariants:
predicted HBM bytes between the compulsory bytes (every operand block read
once) and the no-reuse bytes (every CTA reading its own panels), equal to
the compulsory bytes when the L2 holds every operand, fewer bytes for a
raster that revisits a large panel within the L2's window, the tuner's
per-candidate levels scoring what ``predict`` scores on the planned nest,
and the wave quantisation of the compute time.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro.core import LoopSpec as JLoopSpec
from repro.core import TensorMap as JTensorMap
from repro.core import ThreadedLoop as JThreadedLoop
from repro.core import autotune as jautotune
from repro.core import perf_model as jperf
from repro_torch.core import LoopSpec, TensorMap, ThreadedLoop, autotune, perf_model

TPU = perf_model.TpuTarget()


def _gemm_setup(L=LoopSpec, T=TensorMap, kb=8, mb=8, nb=8, bm=128, bk=128, bn=128,
                blocked=True):
    steps = (lambda t: (t // 2,)) if blocked else (lambda t: ())
    loops = [L(0, kb, 1, block_steps=steps(kb), name="k"),
             L(0, mb, 1, block_steps=steps(mb), name="m"),
             L(0, nb, 1, block_steps=steps(nb), name="n")]
    in_maps = [T(("b", "a"), (bm, bk), layout="flat"),
               T(("a", "c"), (bk, bn), layout="flat")]
    out_map = T(("b", "c"), (bm, bn), layout="flat")
    return loops, in_maps, out_map, 2 * bm * bk * bn, (bm, bn, bk)


def _both(spec, mode="analytic", target=TPU, jtarget=None, allow_races=False,
          reduction_letters=(), **kw):
    """(reference report, port report) of one GEMM nest under ``spec``."""
    out = []
    for L, T, TL, pm, tgt in ((JLoopSpec, JTensorMap, JThreadedLoop, jperf,
                               jtarget or jperf.TpuTarget()),
                              (LoopSpec, TensorMap, ThreadedLoop, perf_model, target)):
        loops, in_maps, out_map, flops, mnk = _gemm_setup(L, T, **kw)
        tl = TL(loops, spec, reduction_letters=("a",), allow_races=allow_races)
        out.append(pm.predict(tl.nest, in_maps, out_map, dtype=np.float32,
                              flops_per_body=flops, tile_mnk=mnk, mode=mode, target=tgt,
                              reduction_letters=reduction_letters))
    return out


def _assert_same(ref, port):
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.bound == ref.bound


# ---------------------------------------------------------------------------
# TpuTarget: the reference's reports (tests/test_perf_model.py's cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["bca", "cab", "acb", "cbca", "BCba", "bcbcaa"])
@pytest.mark.parametrize("mode", ["analytic", "trace"])
def test_tpu_reports_equal_the_reference(spec, mode):
    _assert_same(*_both(spec, mode=mode, kb=4, mb=4, nb=4))


def test_analytic_matches_trace_for_pipeline_model():
    """The reference's zero-reuse LRU: the trace's fetch counts equal the
    analytic pipeline rule, in both packages."""
    for pm, L, T, TL in ((jperf, JLoopSpec, JTensorMap, JThreadedLoop),
                         (perf_model, LoopSpec, TensorMap, ThreadedLoop)):
        loops, in_maps, out_map, flops, mnk = _gemm_setup(L, T, kb=4, mb=4, nb=4)
        tl = TL(loops, "bca", reduction_letters=("a",))
        ana = pm.predict(tl.nest, in_maps, out_map, dtype=np.float32, flops_per_body=flops,
                         tile_mnk=mnk, target=pm.TpuTarget())
        tra = pm.predict(tl.nest, in_maps, out_map, dtype=np.float32, flops_per_body=flops,
                         tile_mnk=mnk, mode="trace", target=pm.TpuTarget(vmem_bytes=1))
        assert ana.fetches == tra.fetches
    _assert_same(*_both("bca", mode="trace", target=perf_model.TpuTarget(vmem_bytes=1),
                        jtarget=jperf.TpuTarget(vmem_bytes=1), kb=4, mb=4, nb=4))


def test_loop_order_changes_traffic():
    r1, p1 = _both("bca")
    r2, p2 = _both("acb")
    _assert_same(r1, p1)
    _assert_same(r2, p2)
    assert p1.hbm_bytes != p2.hbm_bytes


def test_blocking_reduces_bytes():
    rf, flat = _both("bca", kb=16, mb=16, nb=16)
    rb, blocked = _both("cbca", kb=16, mb=16, nb=16)
    _assert_same(rf, flat)
    _assert_same(rb, blocked)
    assert blocked.hbm_bytes <= flat.hbm_bytes * 1.01


def test_vmem_infeasible_flagged():
    ref, r = _both("bca", bm=4096, bk=4096, bn=4096)
    _assert_same(ref, r)
    assert any("VMEM" in n for n in r.notes)
    assert r.gflops < _both("bca")[1].gflops


def test_mxu_efficiency_alignment():
    for args in ((128, 128, 128), (100, 128, 128), (128, 128, 512), (128, 128, 8)):
        assert perf_model.mxu_efficiency(*args) == jperf.mxu_efficiency(*args)
    assert perf_model.mxu_efficiency(128, 128, 128) > perf_model.mxu_efficiency(100, 128, 128)
    assert perf_model.mxu_efficiency(128, 128, 512) > perf_model.mxu_efficiency(128, 128, 8)


@pytest.mark.parametrize("target_cls", ["tpu", "h100"])
def test_mesh_split_k_collective_term(target_cls):
    if target_cls == "tpu":
        ref, r = _both("bcA{model:2}a", allow_races=True, reduction_letters=("a",))
        _assert_same(ref, r)
    else:
        r = _both("bcA{model:2}a", allow_races=True, reduction_letters=("a",),
                  target=perf_model.H100Target())[1]
    assert r.collective_time > 0


def test_prime_factor_blockings():
    assert autotune.prime_factors(12) == jautotune.prime_factors(12) == [2, 2, 3]
    opts = autotune.prefix_product_blockings(12, 2)
    assert opts == jautotune.prefix_product_blockings(12, 2)
    assert all(o % 2 == 0 for o in opts) and len(opts) >= 1


def test_generate_candidates_all_legal():
    loops, *_ = _gemm_setup()
    jloops, *_ = _gemm_setup(JLoopSpec, JTensorMap)
    kw = dict(max_blockings=[2, 2, 2], parallel_letters=("b", "c"), max_candidates=100)
    cands = autotune.generate_candidates(loops, **kw)
    jcands = jautotune.generate_candidates(jloops, **kw)
    assert [(c.spec_string, [l.block_steps for l in c.loops]) for c in cands] == \
        [(c.spec_string, [l.block_steps for l in c.loops]) for c in jcands]
    assert len(cands) > 10
    for c in cands[:20]:  # re-planning must not raise
        ThreadedLoop(c.loops, c.spec_string)


def test_autotune_ranks_and_measures():
    loops, in_maps, out_map, flops, mnk = _gemm_setup()
    jloops, jin, jout, *_ = _gemm_setup(JLoopSpec, JTensorMap)
    kw = dict(dtype=np.float32, flops_per_body=flops, tile_mnk=mnk, reduction_letters=("a",),
              parallel_letters=("b", "c"), max_candidates=60, use_cache=False)
    results = autotune.autotune(loops, in_maps, out_map, target=TPU, **kw)
    ref = jautotune.autotune(jloops, jin, jout, **kw)
    assert [r.candidate.spec_string for r in results] == [r.candidate.spec_string for r in ref]
    assert len(results) > 5
    scores = [r.score for r in results]
    assert scores == sorted(scores, reverse=True)
    mkw = dict(dtype=np.float32, flops_per_body=flops, tile_mnk=mnk, reduction_letters=("a",),
               max_candidates=20, measure_fn=lambda c: float(len(c.spec_string)),
               measure_top_k=3, use_cache=False)
    measured = autotune.autotune(loops, in_maps, out_map, target=TPU, **mkw)
    jmeasured = jautotune.autotune(jloops, jin, jout, **mkw)
    top3 = [r.measured_s for r in measured[:3]]
    assert top3 == sorted(top3)
    assert [r.candidate.spec_string for r in measured] == \
        [r.candidate.spec_string for r in jmeasured]


def test_plan_cache_reuse():
    loops, *_ = _gemm_setup()
    assert autotune.cached_threaded_loop(loops, "bca") is autotune.cached_threaded_loop(loops, "bca")


@pytest.mark.parametrize("trip", [2, 12, 36, 60, 64])
def test_property_prefix_products_divide_trip(trip):
    blockings = autotune.prefix_product_blockings(trip, 1)
    assert blockings == jautotune.prefix_product_blockings(trip, 1)
    assert all(trip % b == 0 for b in blockings)


# ---------------------------------------------------------------------------
# H100Target: the port's rule
# ---------------------------------------------------------------------------

def _h100_setup(kb, mb, nb, bm, bk, bn, steps=None, dtype=np.float32):
    steps = steps or {}
    loops = [LoopSpec(0, kb, 1, block_steps=steps.get("a", ())),
             LoopSpec(0, mb, 1, block_steps=steps.get("b", ())),
             LoopSpec(0, nb, 1, block_steps=steps.get("c", ()))]
    in_maps = [TensorMap(("b", "a"), (bm, bk), layout="flat"),
               TensorMap(("a", "c"), (bk, bn), layout="flat")]
    out_map = TensorMap(("b", "c"), (bm, bn), layout="flat")
    return loops, in_maps, out_map


def _h100(spec, target, mode="analytic", kb=16, mb=12, nb=24, tiles=(128, 64, 128),
          steps=None, dtype=np.float32):
    bm, bk, bn = tiles
    loops, in_maps, out_map = _h100_setup(kb, mb, nb, bm, bk, bn, steps)
    tl = ThreadedLoop(loops, spec, reduction_letters=("a",))
    rep = perf_model.predict(tl.nest, in_maps, out_map, dtype=dtype,
                             flops_per_body=2 * bm * bk * bn, tile_mnk=(bm, bn, bk),
                             target=target, mode=mode)
    db = np.dtype(dtype).itemsize
    bb = [perf_model._operand_block_bytes(tl.nest, tm, db) for tm in in_maps + [out_map]]
    bounds = perf_model.traffic_bounds(perf_model.nest_levels(tl.nest),
                                       [tm.letters for tm in in_maps + [out_map]], bb)
    return rep, bounds


# (SMs, CTA tile) giving waves of 1, 4 and 12 of the test problem's
# 128 x 128 output blocks (one CTA an SM)
WAVES = {1: (1, (128, 128)), 4: (1, (256, 256)), 12: (3, (256, 256))}


def _small_l2(wave=4, **kw):
    """An H100 whose L2 holds a few panels of the test problem, computing
    ``wave`` output blocks at once."""
    sms, tile = WAVES[wave]
    return perf_model.H100Target(sms=sms, ctas_per_sm=1, cta_tile=tile, **kw)


SPECS = ["bca", "cba", "bcba", "cbca", "BCa", "bcbca", "cbcba"]
STEPS = {"bcba": {"b": (4,)}, "cbca": {"c": (6,)}, "bcbca": {"b": (3,), "c": (8,)},
         "cbcba": {"b": (4,), "c": (6,)}}


@pytest.mark.parametrize("wave", sorted(WAVES))
@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("l2", [1, 600_000, 3_000_000])
def test_h100_bytes_between_compulsory_and_no_reuse(spec, wave, l2):
    rep, (compulsory, no_reuse) = _h100(spec, _small_l2(wave, l2_bytes=l2),
                                        steps=STEPS.get(spec))
    assert compulsory <= rep.hbm_bytes <= no_reuse
    assert rep.total_time >= max(rep.compute_time, rep.memory_time)


@pytest.mark.parametrize("wave", sorted(WAVES))
@pytest.mark.parametrize("spec", SPECS)
def test_h100_l2_holding_every_operand_reads_compulsory_bytes(spec, wave):
    rep, (compulsory, no_reuse) = _h100(spec, _small_l2(wave, l2_bytes=1 << 40),
                                        steps=STEPS.get(spec))
    assert rep.hbm_bytes == compulsory < no_reuse
    # every block of A (12 x 16), B (16 x 24) once; C (12 x 24) written once
    assert rep.fetches == {0: 12 * 16, 1: 16 * 24, 2: 12 * 24}


def test_h100_raster_revisiting_a_row_panel_reads_fewer_bytes():
    """A's row panels (128 rows × K 2048 of 64-wide blocks) are 16 times
    B's column panels (K × 8 columns): "bca" walks a row of output blocks
    and revisits its A panel from L2 wave after wave, "cba" walks a column
    and re-reads a new A panel for every block."""
    target = perf_model.H100Target(sms=1, ctas_per_sm=1, cta_tile=(128, 8), l2_bytes=1_200_000)
    kw = dict(kb=32, mb=6, nb=6, tiles=(128, 64, 8))
    bca, (compulsory, no_reuse) = _h100("bca", target, **kw)
    cba, _ = _h100("cba", target, **kw)
    assert bca.hbm_bytes < cba.hbm_bytes
    assert bca.fetches[0] == 6 * 32                      # each A panel once
    assert cba.fetches[0] == 36 * 32                     # A panel each block
    assert bca.total_time < cba.total_time


def test_h100_tiled_raster_beats_rows_when_a_wave_overflows_l2():
    """K1's up projection at llama2-13b's prefill (2048 x 5120 x 13824 in
    128 x 64 x 128 blocks): a wave of row-major blocks reads 108 column
    panels, more than the L2 holds across waves; a raster four block rows
    deep ("bcba" with b blocked by 4) reads fewer bytes."""
    target = perf_model.H100Target()
    kw = dict(kb=80, mb=16, nb=108, dtype=np.dtype("float16"))
    rows, (compulsory, no_reuse) = _h100("bca", target, **kw)
    tiled, _ = _h100("bcba", target, steps={"b": (4,)}, **kw)
    assert compulsory <= tiled.hbm_bytes < rows.hbm_bytes <= no_reuse
    assert rows.compute_time == tiled.compute_time


@pytest.mark.parametrize("spec", SPECS)
def test_h100_levels_score_what_predict_scores(spec):
    """The tuner's scoring path (``predict_levels`` on levels built from a
    family's trips) equals ``predict`` on the planned nest."""
    loops, in_maps, out_map = _h100_setup(16, 12, 24, 128, 64, 128, STEPS.get(spec))
    target = _small_l2(l2_bytes=600_000)
    tl = ThreadedLoop(loops, spec, reduction_letters=("a",))
    rep = perf_model.predict(tl.nest, in_maps, out_map, dtype=np.float32,
                             flops_per_body=2 * 128 * 64 * 128, tile_mnk=(128, 128, 64),
                             target=target)
    trips = {}
    for letter, loop in zip("abc", tl.loops):
        steps = tuple(loop.block_steps) + (loop.step,)
        trips[letter] = [loop.extent // steps[0]] + [o // i for o, i in zip(steps, steps[1:])]
    family = autotune._Family(tl.loops, (), trips, 1)
    perm = tuple(o.letter for o in tl.spec.occurrences)
    levels = autotune._levels_row(perm, family)
    assert levels == perf_model.nest_levels(tl.nest)
    bb = [autotune._static_block_bytes(loops, tm, 4) for tm in in_maps + [out_map]]
    again = perf_model.predict_levels(levels, [tm.letters for tm in in_maps + [out_map]], bb,
                                      dtype=np.float32, flops_per_body=2 * 128 * 64 * 128,
                                      tile_mnk=(128, 128, 64), target=target, spec=spec)
    assert dataclasses.asdict(again) == dataclasses.asdict(rep)


def test_h100_reduction_outside_an_output_level_is_penalised():
    legal, _ = _h100("bca", perf_model.H100Target())
    illegal, _ = _h100("abc", perf_model.H100Target())
    assert any("TPP102" in n for n in illegal.notes) and not legal.notes
    assert illegal.compute_time == pytest.approx(legal.compute_time * 1e3)


def test_h100_compute_time_wave_quantisation_and_wgmma_granularity():
    t = perf_model.H100Target()
    flops = 2.0 * 2048 * 5120 * 13824
    one = perf_model.h100_compute_time(flops, 0.0, 16 * 108, 128 * 128 * 2, 2, (128, 128, 64), t)
    # 1728 CTAs on 132 SMs: the busiest SM runs 14, the mean 13.09
    assert one == pytest.approx(flops / 989e12 * 14 * 132 / 1728)
    assert perf_model.wgmma_efficiency(128, 128, 64) == 1.0
    assert perf_model.wgmma_efficiency(100, 128, 64) == pytest.approx(100 / 128)
    assert perf_model.wgmma_efficiency(128, 100, 64) == pytest.approx(100 / 104)
    # decode: 8 rows on wgmma's n of 16, every SM busy
    dec = perf_model.h100_compute_time(flops, 0.0, 1, 8 * 512 * 2, 2, (8, 512, 1024), t)
    assert dec == pytest.approx(flops / 989e12 * 2)
    # the epilogue at the fp32 CUDA-core rate
    assert perf_model.h100_compute_time(0.0, 67e9, 1, 2, 2, None, t) == pytest.approx(1e-3)


def test_h100_target_constants():
    t = perf_model.H100Target()
    assert (t.sms, t.l2_bytes, t.smem_per_sm) == (132, 50 * 2 ** 20, 228 * 1024)
    assert (t.hbm_bw, t.peak_flops(2), t.peak_flops(4)) == (3.35e12, 989e12, 67e12)
    # two CTAs of K1's bf16 ring (3 stages of 32 KB) fit an SM; fp32 one
    assert t.ctas_at_once(2) == 2 and t.ctas_at_once(4) == 1
    assert perf_model.dtype_name(np.float32) == perf_model.dtype_name("float32") == "float32"
    import torch
    assert perf_model.dtype_name(torch.bfloat16) == "bfloat16"
    assert perf_model.dtype_bytes(torch.bfloat16) == 2 == perf_model.dtype_bytes(np.float16)


def test_predict_batch_refuses_an_h100_target():
    with pytest.raises(TypeError):
        perf_model.predict_batch([[1]], [[0, 0, 0]], [1, 1, 1], dtype=np.float32,
                                 flops_per_body=1.0, target=perf_model.H100Target())


@pytest.mark.parametrize("spec", SPECS)
def test_h100_has_one_rule_whatever_the_mode(spec):
    """``mode`` and ``trace_limit`` choose a ``TpuTarget``'s walk: under an
    ``H100Target`` a trace request gives the analytic report, with no note."""
    target = _small_l2(l2_bytes=600_000)
    loops, in_maps, out_map = _h100_setup(16, 12, 24, 128, 64, 128, STEPS.get(spec))
    tl = ThreadedLoop(loops, spec, reduction_letters=("a",))
    kw = dict(dtype=np.float32, flops_per_body=1.0, target=target)
    trace = perf_model.predict(tl.nest, in_maps, out_map, mode="trace", trace_limit=10, **kw)
    ana = perf_model.predict(tl.nest, in_maps, out_map, **kw)
    assert dataclasses.asdict(trace) == dataclasses.asdict(ana)
    assert not ana.notes and math.isfinite(ana.total_time)
