"""``repro_torch.core.autotune`` and ``core.tunecache`` against
``repro.core.autotune`` on the CPU (``tests/test_autotune_search.py``'s
cases, each beside its reference), and the tuner under ``H100Target``.

Under ``TpuTarget`` the ranked spec strings, their ``block_steps`` and the
``SearchStats`` counts (all but the search's seconds) equal the
reference's on the same nest; candidate sets equal the reference's.  Under
``H100Target``: streaming pruning never drops the exhaustive argmax, the
target keys the cache apart, the port's cache lives in its own directory
and environment variable, and a failing ``measure_fn`` raises.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.core import LoopSpec as JLoopSpec
from repro.core import TensorMap as JTensorMap
from repro.core import autotune as jautotune
from repro_torch.core import (LoopSpec, TensorMap, ThreadedLoop, autotune, loop_signature,
                              perf_model, tunecache)
from repro_torch.core.legality import LegalityError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU = perf_model.TpuTarget()
H100 = perf_model.H100Target()


@pytest.fixture(autouse=True)
def _own_tune_cache(tmp_path, monkeypatch):
    """Keep the default tune cache out of the checkout for every test."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE_DIR", str(tmp_path / "default-cache"))


def _setup(kb=8, mb=8, nb=8, bm=64, bk=64, bn=64, dtype=np.float32, L=LoopSpec, T=TensorMap):
    loops = [L(0, kb, 1, name="k"), L(0, mb, 1, name="m"), L(0, nb, 1, name="n")]
    in_maps = [T(("b", "a"), (bm, bk), layout="flat"),
               T(("a", "c"), (bk, bn), layout="flat")]
    out_map = T(("b", "c"), (bm, bn), layout="flat")
    kw = dict(dtype=dtype, flops_per_body=2 * bm * bk * bn,
              tile_mnk=(bm, bn, bk), reduction_letters=("a",),
              parallel_letters=("b", "c"), use_cache=False)
    return loops, in_maps, out_map, kw


def _ref(**setup):
    return _setup(L=JLoopSpec, T=JTensorMap, **setup)


def _key(c):
    return (c.spec_string, tuple(l.block_steps for l in c.loops))


def _ranked(results):
    return [_key(r.candidate) for r in results]


def _counts(stats):
    d = dataclasses.asdict(stats)
    d.pop("search_time_s")
    return d


def _search_both(setup=None, **kw):
    """(reference (results, stats), port (results, stats)) of one search
    under TpuTarget."""
    setup = setup or {}
    jl, ji, jo, jkw = _ref(**setup)
    pl, pi, po, pkw = _setup(**setup)
    ref = jautotune.autotune_with_stats(jl, ji, jo, **{**jkw, **kw})
    port = autotune.autotune_with_stats(pl, pi, po, target=TPU, **{**pkw, **kw})
    return ref, port


def _assert_same_search(ref, port):
    (rr, rs), (pr, ps) = ref, port
    assert _ranked(pr) == _ranked(rr)
    assert _counts(ps) == _counts(rs)
    assert [r.score for r in pr] == pytest.approx([r.score for r in rr], rel=1e-12)


# ---------------------------------------------------------------------------
# Generation equivalence + legality at generation time
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kb,mb,nb", [(2, 3, 4), (4, 12, 9), (6, 8, 2), (12, 2, 9), (8, 6, 4)])
def test_streaming_set_equals_exhaustive_and_the_reference(kb, mb, nb):
    kw = dict(max_blockings=[2, 2, 2], parallel_letters=("b", "c"))
    loops = [LoopSpec(0, kb, 1), LoopSpec(0, mb, 1), LoopSpec(0, nb, 1)]
    streamed = {_key(c) for c in autotune.generate_candidates(loops, max_candidates=10 ** 6, **kw)}
    exhaustive = {_key(c) for c in autotune._generate_candidates_exhaustive(
        loops, max_candidates=None, **kw)}
    jloops = [JLoopSpec(0, kb, 1), JLoopSpec(0, mb, 1), JLoopSpec(0, nb, 1)]
    ref = {_key(c) for c in jautotune.generate_candidates(jloops, max_candidates=10 ** 6, **kw)}
    assert streamed == exhaustive == ref and streamed


def test_streaming_set_equals_exhaustive_with_mesh():
    kw = dict(max_blockings=[2, 2, 2], parallel_letters=("b", "c"), mesh_decomp=(("b", "x", 2),))
    loops = [LoopSpec(0, 8, 1), LoopSpec(0, 8, 1), LoopSpec(0, 8, 1)]
    streamed = [_key(c) for c in autotune.generate_candidates(loops, max_candidates=10 ** 6, **kw)]
    exhaustive = {_key(c) for c in autotune._generate_candidates_exhaustive(
        loops, max_candidates=None, **kw)}
    jloops = [JLoopSpec(0, 8, 1), JLoopSpec(0, 8, 1), JLoopSpec(0, 8, 1)]
    ref = [_key(c) for c in jautotune.generate_candidates(jloops, max_candidates=10 ** 6, **kw)]
    assert set(streamed) == exhaustive and streamed == ref
    assert all("{x:2}" in s for s, _ in streamed)


def test_blocking_chains_legal_at_generation():
    for extent, step in [(12, 1), (16, 2), (24, 1), (36, 3)]:
        loop = LoopSpec(0, extent * step, step)
        chains = autotune._blocking_choices(loop, 3)
        assert chains == jautotune._blocking_choices(JLoopSpec(0, extent * step, step), 3)
        for chain in chains:
            blocked = LoopSpec(0, extent * step, step, block_steps=chain)
            ThreadedLoop([blocked], "a" * (len(chain) + 1))  # must not raise


def test_max_candidates_bounds_stream():
    loops = [LoopSpec(0, 16, 1), LoopSpec(0, 16, 1), LoopSpec(0, 16, 1)]
    cands = autotune.generate_candidates(loops, max_blockings=[3, 3, 3],
                                         parallel_letters=("b", "c"), max_candidates=50)
    assert len(cands) == 50


# ---------------------------------------------------------------------------
# Pruning safety + batched-scoring parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile,dtype,top_k", [(8, np.float32, 4), (16, np.float16, 8),
                                              (128, np.float32, 16), (128, np.float16, 4)])
def test_pruning_never_drops_argmax(tile, dtype, top_k):
    setup = dict(bm=tile, bk=tile, bn=tile, dtype=dtype)
    for strategy in ("exhaustive", "streaming"):
        _assert_same_search(*_search_both(setup, strategy=strategy, max_candidates=None,
                                          top_k=top_k))
    loops, in_maps, out_map, kw = _setup(**setup)
    ex, _ = autotune.autotune_with_stats(loops, in_maps, out_map, strategy="exhaustive",
                                         max_candidates=None, top_k=top_k, target=TPU, **kw)
    st_, _ = autotune.autotune_with_stats(loops, in_maps, out_map, strategy="streaming",
                                          max_candidates=None, top_k=top_k, target=TPU, **kw)
    assert ex[0].candidate.spec_string == st_[0].candidate.spec_string
    assert ex[0].score == pytest.approx(st_[0].score, rel=1e-12)


@pytest.mark.parametrize("kb,mb,nb,l2", [(8, 8, 8, 50 * 2 ** 20), (12, 8, 12, 300_000),
                                         (32, 6, 6, 1_200_000)])
def test_h100_pruning_never_drops_argmax(kb, mb, nb, l2):
    """Under the H100 rule the family bound (compute against compulsory
    bytes) never prunes the exhaustive search's best schedule."""
    target = perf_model.H100Target(sms=2, ctas_per_sm=1, l2_bytes=l2)
    loops, in_maps, out_map, kw = _setup(kb=kb, mb=mb, nb=nb, bm=128, bk=64, bn=128,
                                         dtype=np.float16)
    ex, _ = autotune.autotune_with_stats(loops, in_maps, out_map, strategy="exhaustive",
                                         max_candidates=None, top_k=8, target=target, **kw)
    st_, stats = autotune.autotune_with_stats(loops, in_maps, out_map, strategy="streaming",
                                              max_candidates=None, top_k=8, target=target, **kw)
    assert ex[0].score == pytest.approx(st_[0].score, rel=1e-12)
    assert ex[0].candidate.spec_string == st_[0].candidate.spec_string
    # the reduction stays inside the output blocks at the top
    assert st_[0].candidate.spec_string.lower().endswith("a")
    assert stats.considered == (stats.candidates_scored + stats.candidates_pruned
                                + stats.candidates_filtered)


def test_mesh_split_k_strategies_agree():
    kw = dict(mesh_decomp=(("a", "x", 2),), max_candidates=None, top_k=8)
    ex = _search_both(strategy="exhaustive", **kw)
    st_ = _search_both(strategy="streaming", **kw)
    _assert_same_search(*ex)
    _assert_same_search(*st_)
    assert ex[1][0][0].candidate.spec_string == st_[1][0][0].candidate.spec_string
    assert ex[1][0][0].report.collective_time > 0
    # scored under the H100 rule too; launching one still raises
    loops, in_maps, out_map, pkw = _setup()
    res, _ = autotune.autotune_with_stats(loops, in_maps, out_map, target=H100,
                                          **{**pkw, **kw})
    assert res and res[0].report.collective_time > 0
    from repro_torch.core.executor import require_no_mesh
    tl = ThreadedLoop(res[0].candidate.loops, res[0].candidate.spec_string,
                      reduction_letters=("a",), allow_races=True)
    with pytest.raises(LegalityError):
        require_no_mesh(tl.nest)


def test_unkeyed_hooks_bypass_cache(tmp_path):
    loops, in_maps, out_map, kw = _setup()
    kw.pop("use_cache")
    _, s1 = autotune.autotune_with_stats(loops, in_maps, out_map, cache_dir=tmp_path, **kw)
    assert not s1.cache_hit
    r2, s2 = autotune.autotune_with_stats(loops, in_maps, out_map, cache_dir=tmp_path,
                                          validate_fn=lambda tl: None, **kw)
    assert not s2.cache_hit and s2.candidates_generated > 0
    _, s3 = autotune.autotune_with_stats(loops, in_maps, out_map, cache_dir=tmp_path,
                                         validate_fn=lambda tl: None, cache_extra=("v1",), **kw)
    _, s4 = autotune.autotune_with_stats(loops, in_maps, out_map, cache_dir=tmp_path,
                                         validate_fn=lambda tl: None, cache_extra=("v1",), **kw)
    assert not s3.cache_hit and s4.cache_hit


def _only_k_innermost(exc):
    def check(tl):
        if tl.nest.levels[-1].letter != "a":
            raise exc("reject")
    return check


def test_unfiltered_validator_disables_pruning():
    from repro.core.loops import LegalityError as JLegalityError

    setup = dict(kb=32, mb=32, nb=32, bm=128, bk=128, bn=128)
    jl, ji, jo, jkw = _ref(**setup)
    pl, pi, po, pkw = _setup(**setup)
    kw = dict(max_candidates=None, top_k=8)
    ref = jautotune.autotune_with_stats(jl, ji, jo, validate_fn=_only_k_innermost(
        JLegalityError), **{**jkw, **kw})
    res, stats = port = autotune.autotune_with_stats(
        pl, pi, po, target=TPU, validate_fn=_only_k_innermost(LegalityError), **{**pkw, **kw})
    _assert_same_search(ref, port)
    ex, _ = autotune.autotune_with_stats(pl, pi, po, target=TPU, strategy="exhaustive",
                                         validate_fn=_only_k_innermost(LegalityError),
                                         **{**pkw, **kw})
    assert ex[0].candidate.spec_string == res[0].candidate.spec_string
    assert stats.candidates_pruned == 0
    assert all(r.candidate.spec_string.lower().endswith("a") for r in res)


def test_pruning_fires_and_counts():
    ref, port = _search_both(dict(kb=32, mb=32, nb=32, bm=128, bk=128, bn=128),
                             strategy="streaming", max_candidates=None, top_k=16)
    _assert_same_search(ref, port)
    stats = port[1]
    assert stats.candidates_pruned > 0
    assert stats.considered == (stats.candidates_scored + stats.candidates_pruned
                                + stats.candidates_filtered)


@pytest.mark.parametrize("pick", [0, 7, 123, 299, 388])
def test_predict_batch_matches_predict(pick):
    loops, in_maps, out_map, kw = _setup()
    cands = autotune.generate_candidates(loops, max_blockings=[2, 2, 2],
                                         parallel_letters=("b", "c"), max_candidates=400)
    c = cands[pick % len(cands)]
    tl = ThreadedLoop(c.loops, c.spec_string, reduction_letters=("a",))
    single = perf_model.predict(tl.nest, in_maps, out_map, dtype=np.float32,
                                flops_per_body=kw["flops_per_body"], tile_mnk=kw["tile_mnk"],
                                reduction_letters=("a",), target=TPU)
    trips = [[lvl.trip_count for lvl in tl.nest.levels]]
    all_maps = list(in_maps) + [out_map]
    pmax = [[perf_model._p_max(tl.nest, tm) for tm in all_maps]]
    bb = [perf_model._operand_block_bytes(tl.nest, tm, 4) for tm in all_maps]
    batch = perf_model.predict_batch(trips, pmax, bb, dtype=np.float32,
                                     flops_per_body=kw["flops_per_body"], tile_mnk=kw["tile_mnk"],
                                     target=TPU)
    assert batch["gflops"][0] == pytest.approx(single.gflops, rel=1e-9)
    assert batch["hbm_bytes"][0] == pytest.approx(single.hbm_bytes, rel=1e-9)


# ---------------------------------------------------------------------------
# Persistent cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", [TPU, H100], ids=["tpu", "h100"])
def test_cache_hit_in_process(tmp_path, target):
    loops, in_maps, out_map, kw = _setup()
    kw.pop("use_cache")
    r1, s1 = autotune.autotune_with_stats(loops, in_maps, out_map, cache_dir=tmp_path,
                                          target=target, **kw)
    r2, s2 = autotune.autotune_with_stats(loops, in_maps, out_map, cache_dir=tmp_path,
                                          target=target, **kw)
    assert not s1.cache_hit and s2.cache_hit
    assert s2.candidates_generated == 0
    assert _ranked(r1) == _ranked(r2)
    assert r1[0].score == pytest.approx(r2[0].score, rel=1e-12)


def test_the_target_keys_the_cache(tmp_path):
    loops, in_maps, out_map, kw = _setup()
    kw.pop("use_cache")
    _, s1 = autotune.autotune_with_stats(loops, in_maps, out_map, cache_dir=tmp_path,
                                         target=TPU, **kw)
    _, s2 = autotune.autotune_with_stats(loops, in_maps, out_map, cache_dir=tmp_path,
                                         target=H100, **kw)
    _, s3 = autotune.autotune_with_stats(loops, in_maps, out_map, cache_dir=tmp_path,
                                         target=perf_model.H100Target(sms=114), **kw)
    _, s4 = autotune.autotune_with_stats(loops, in_maps, out_map, cache_dir=tmp_path,
                                         target=H100, **kw)
    assert not (s1.cache_hit or s2.cache_hit or s3.cache_hit) and s4.cache_hit
    assert len(tunecache.TuneCache(tmp_path)) == 3


_FRESH_PROCESS_SCRIPT = """
import json, sys
import numpy as np
sys.path.insert(0, {src!r})
from repro_torch.core import LoopSpec, TensorMap, autotune
loops = [LoopSpec(0, 8, 1), LoopSpec(0, 8, 1), LoopSpec(0, 8, 1)]
in_maps = [TensorMap(("b", "a"), (64, 64), layout="flat"),
           TensorMap(("a", "c"), (64, 64), layout="flat")]
out_map = TensorMap(("b", "c"), (64, 64), layout="flat")
res, stats = autotune.autotune_with_stats(
    loops, in_maps, out_map, dtype=np.float32, flops_per_body=2 * 64 ** 3,
    tile_mnk=(64, 64, 64), reduction_letters=("a",),
    parallel_letters=("b", "c"))
print(json.dumps({{"hit": stats.cache_hit,
                   "generated": stats.candidates_generated,
                   "top": res[0].candidate.spec_string}}))
"""


def test_cache_hit_across_processes(tmp_path):
    """A second ``autotune()`` with identical inputs in a fresh process
    returns from the port's default cache (``REPRO_TORCH_TUNE_CACHE_DIR``)
    without generating a candidate; the reference's variable does not move
    it."""
    script = _FRESH_PROCESS_SCRIPT.format(src=os.path.join(REPO, "src"))
    env = dict(os.environ, REPRO_TORCH_TUNE_CACHE_DIR=str(tmp_path / "port"),
               REPRO_TUNE_CACHE_DIR=str(tmp_path / "reference"))
    env.pop("REPRO_TORCH_TUNE_CACHE", None)

    def run_once():
        out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                             check=True, cwd=REPO, env=env, timeout=120)
        return json.loads(out.stdout.strip().splitlines()[-1])

    first, second = run_once(), run_once()
    assert not first["hit"] and first["generated"] > 0
    assert second["hit"] and second["generated"] == 0
    assert second["top"] == first["top"]
    assert len(list((tmp_path / "port").glob("*.json"))) == 1
    assert not (tmp_path / "reference").exists()


def test_cache_measured_rerank_persists(tmp_path):
    loops, in_maps, out_map, kw = _setup()
    kw.pop("use_cache")
    r1, _ = autotune.autotune_with_stats(
        loops, in_maps, out_map, cache_dir=tmp_path,
        measure_fn=lambda c: float(len(c.spec_string)), measure_top_k=3, target=TPU, **kw)
    jl, ji, jo, jkw = _ref()
    jkw.pop("use_cache")
    jr, _ = jautotune.autotune_with_stats(
        jl, ji, jo, cache_dir=tmp_path / "reference",
        measure_fn=lambda c: float(len(c.spec_string)), measure_top_k=3, **jkw)
    assert _ranked(r1) == _ranked(jr)
    r2, s2 = autotune.autotune_with_stats(
        loops, in_maps, out_map, cache_dir=tmp_path, measure_fn=lambda c: 1e9,
        measure_top_k=3, target=TPU, **kw)
    assert s2.cache_hit
    assert [r.measured_s for r in r2[:3]] == [r.measured_s for r in r1[:3]]
    assert r2[0].measured_s == min(r.measured_s for r in r2[:3])


def test_failed_measurement_raises(tmp_path):
    """``_measure_rerank`` catches nothing: a candidate that cannot be
    measured ends the search, on a miss and on a hit alike."""
    loops, in_maps, out_map, kw = _setup()
    kw.pop("use_cache")

    def broken(candidate):
        raise RuntimeError("launch failed")

    with pytest.raises(RuntimeError, match="launch failed"):
        autotune.autotune_with_stats(loops, in_maps, out_map, cache_dir=tmp_path,
                                     measure_fn=broken, **kw)
    autotune.autotune_with_stats(loops, in_maps, out_map, cache_dir=tmp_path, **kw)
    with pytest.raises(RuntimeError, match="launch failed"):
        autotune.autotune_with_stats(loops, in_maps, out_map, cache_dir=tmp_path,
                                     measure_fn=broken, **kw)


def test_uncacheable_top_k_bypasses_cache(tmp_path):
    loops, in_maps, out_map, kw = _setup()
    kw.pop("use_cache")
    r1, s1 = autotune.autotune_with_stats(loops, in_maps, out_map, cache_dir=tmp_path,
                                          top_k=None, **kw)
    r2, s2 = autotune.autotune_with_stats(loops, in_maps, out_map, cache_dir=tmp_path,
                                          top_k=None, **kw)
    assert not s1.cache_hit and not s2.cache_hit
    assert len(r1) == len(r2) > autotune._CACHE_STORE_K


def test_measured_upgrade_keeps_search_stats(tmp_path):
    loops, in_maps, out_map, kw = _setup()
    kw.pop("use_cache")
    tc = tunecache.TuneCache(tmp_path)
    _, s1 = autotune.autotune_with_stats(loops, in_maps, out_map, cache=tc, **kw)
    key = next(iter(tmp_path.glob("*.json"))).stem
    before = tc.lookup(key)["stats"]
    assert before["candidates_scored"] == s1.candidates_scored > 0
    _, s2 = autotune.autotune_with_stats(loops, in_maps, out_map, cache=tc,
                                         measure_fn=lambda c: float(len(c.spec_string)), **kw)
    assert s2.cache_hit
    after = tc.lookup(key)
    assert after["stats"] == before
    assert any(r["measured_s"] is not None for r in after["results"])


def test_cache_corrupt_entry_is_miss(tmp_path):
    tc = tunecache.TuneCache(tmp_path)
    key = tunecache.cache_key(anything=1)
    tc.store(key, {"results": []})
    assert tc.lookup(key) is not None
    path = tmp_path / f"{key}.json"
    path.write_text("{not json")
    with pytest.warns(RuntimeWarning, match="corrupted"):
        assert tc.lookup(key) is None
    assert not path.exists()
    tc.store(key, {"results": [1]})
    assert tc.lookup(key)["results"] == [1]


def test_cache_store_failure_is_nonfatal(tmp_path):
    blocker = tmp_path / "occupied"
    blocker.write_text("")
    tc = tunecache.TuneCache(blocker / "cache")
    with pytest.warns(RuntimeWarning, match="not persisted"):
        tc.store("deadbeef", {"results": []})
    assert tc.lookup("deadbeef") is None


def test_cache_disabled_by_env(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", "0")
    assert tunecache.default_cache() is None
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", "1")
    monkeypatch.setenv("REPRO_TUNE_CACHE", "0")       # the reference's switch
    assert tunecache.default_cache() is not None


def test_default_cache_dir_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE_DIR")
    monkeypatch.setenv("REPRO_TUNE_CACHE_DIR", "/elsewhere")
    path = tunecache.default_cache_dir()
    assert path == tunecache._CHECKOUT / "build" / "tune-cache"
    assert path.parts[-2:] == ("build", "tune-cache")


# ---------------------------------------------------------------------------
# Plan-cache keying + signatures
# ---------------------------------------------------------------------------

def test_cached_threaded_loop_unhashable_kwargs():
    loops = [LoopSpec(0, 8, 1), LoopSpec(0, 8, 1), LoopSpec(0, 8, 1)]
    a = autotune.cached_threaded_loop(loops, "bca", reduction_letters=["a"])
    b = autotune.cached_threaded_loop(loops, "bca", reduction_letters=("a",))
    assert a is b
    assert autotune._freeze({"b": [4], "a": {1, 2}}) == (("a", (1, 2)), ("b", (4,)))


def test_loop_signature_ignores_names():
    a = [LoopSpec(0, 8, 1, name="k"), LoopSpec(0, 8, 1, name="m")]
    b = [LoopSpec(0, 8, 1, name="x"), LoopSpec(0, 8, 1)]
    assert loop_signature(a) == loop_signature(b)
    c = [LoopSpec(0, 8, 1, block_steps=(4,)), LoopSpec(0, 8, 1)]
    assert loop_signature(a) != loop_signature(c)


def test_tune_key_params_classify_every_argument():
    import inspect
    params = set(inspect.signature(autotune.autotune_with_stats).parameters)
    assert params == autotune.TUNE_KEY_PARAMS | autotune.TUNE_KEY_EXEMPT
    assert not autotune.TUNE_KEY_PARAMS & autotune.TUNE_KEY_EXEMPT
    assert autotune.TUNE_KEY_SCHEMA == jautotune.TUNE_KEY_SCHEMA


# ---------------------------------------------------------------------------
# Fusion: cheap schedule filter must agree with the planned validators
# ---------------------------------------------------------------------------

def test_graph_filter_matches_validators():
    from repro_torch import fusion
    from repro_torch.core.parser import parse_spec_string
    from repro_torch.fusion import lowering
    from repro_torch.fusion.cost import _graph_schedule_filter

    g = fusion.fused_output_graph(0.0)
    flt = _graph_schedule_filter(g)
    loops = [LoopSpec(0, 8, 1), LoopSpec(0, 8, 1), LoopSpec(0, 8, 1)]
    cands = autotune.generate_candidates(loops, max_blockings=[2, 2, 2],
                                         parallel_letters=("b",), max_candidates=2000)
    assert len(cands) > 200
    agree = 0
    for c in cands:
        spec = parse_spec_string(c.spec_string)
        perm = tuple(o.letter for o in spec.occurrences)
        par_pos = tuple(o.position for o in spec.occurrences if o.parallel)
        mesh_pos = tuple(o.position for o in spec.occurrences if o.mesh_axis is not None)
        cheap = flt(perm, par_pos, mesh_pos)
        tl = ThreadedLoop(c.loops, c.spec_string, reduction_letters=("a",))
        try:
            lowering.validate_reduction_innermost(tl.nest, ("b", "c"), ("a",))
            lowering.validate_epilogue_band(tl.nest, g)
            real = True
        except LegalityError:
            real = False
        assert cheap == real, (c.spec_string, cheap, real)
        agree += cheap
    assert 0 < agree < len(cands)


def test_autotune_graph_cache_roundtrip(tmp_path):
    from repro_torch import fusion

    g = fusion.fused_mlp_graph()
    kw = dict(tiles=(16, 32, 64), max_candidates=200, cache_dir=tmp_path, return_stats=True)
    r1, s1 = fusion.autotune_graph(g, 64, 64, 128, **kw)
    r2, s2 = fusion.autotune_graph(g, 64, 64, 128, **kw)
    assert not s1.cache_hit and s2.cache_hit
    assert r1[0].candidate.spec_string == r2[0].candidate.spec_string
    _, s3 = fusion.autotune_graph(fusion.fused_output_graph(0.0), 64, 64, 128, **kw)
    assert not s3.cache_hit


def test_h100_ties_rank_by_predicted_bytes():
    """Compute-bound schedules of one nest tie on the roofline; the tuner
    ranks them by the HBM bytes the L2 walk predicts, exhaustive and
    streaming alike."""
    target = perf_model.H100Target(sms=4, ctas_per_sm=1, l2_bytes=2_000_000,
                                   peak_flops_bf16=5e12)     # a slow card: compute-bound
    loops, in_maps, out_map, kw = _setup(kb=12, mb=8, nb=12, bm=128, bk=64, bn=128,
                                         dtype=np.float16)
    kw["parallel_letters"] = ()
    for strategy in ("exhaustive", "streaming"):
        res, _ = autotune.autotune_with_stats(loops, in_maps, out_map, strategy=strategy,
                                              max_candidates=None, top_k=None, target=target,
                                              **kw)
        keys = [(-r.score, r.report.hbm_bytes) for r in res]
        assert keys == sorted(keys)
        tied = [r.report.hbm_bytes for r in res if r.score == res[0].score]
        assert len(set(tied)) > 1


# ---------------------------------------------------------------------------
# K1's own search: brgemm.autotune_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,tiles", [((256, 512, 384), (64, 64, 64)),
                                         ((512, 1024, 512), (128, 64, 128))])
def test_autotune_matmul_ranks_plans_k1_launches(tmp_path, shape, tiles):
    """Every schedule ``autotune_matmul`` returns is one ``brgemm.schedule``
    plans (the reduction inside the output blocks); the search equals the
    generic tuner's under the bare GEMM graph's filter; a repeat is a cache
    hit that generates no candidate."""
    import torch

    from repro_torch import fusion
    from repro_torch.fusion import cost
    from repro_torch.kernels import brgemm

    m, k, n = shape
    tc = tunecache.TuneCache(tmp_path / "cache")
    results, stats = brgemm.autotune_matmul(m, k, n, tiles=tiles, max_candidates=40, top_k=6,
                                            cache=tc, return_stats=True)
    assert len(results) == 6 and not stats.cache_hit and stats.candidates_filtered > 0
    for r in results:
        kw = fusion.schedule_kwargs(r.candidate)
        plan = brgemm.schedule(m, k, n, torch.bfloat16, tiles=tiles, **kw)
        assert plan.visit_order.shape[0] == (m // tiles[0]) * (n // tiles[2])
    bm, bk, bn = tiles
    loops, in_maps, out_map = brgemm.nest_inputs(m, k, n, tiles)
    g = fusion.fused_attn_out_graph()
    generic = autotune.autotune(
        loops, in_maps, out_map, dtype=torch.bfloat16, flops_per_body=2.0 * bm * bk * bn,
        tile_mnk=(bm, bn, bk), reduction_letters=("a",), max_candidates=40, top_k=6,
        spec_filter=cost._graph_schedule_filter(g), validate_fn=cost._graph_validator(g),
        use_cache=False)
    assert [(r.candidate, r.report.total_time) for r in generic] == [
        (r.candidate, r.report.total_time) for r in results]
    again, stats2 = brgemm.autotune_matmul(m, k, n, tiles=tiles, max_candidates=40, top_k=6,
                                           cache=tc, return_stats=True)
    assert stats2.cache_hit and stats2.candidates_generated == 0
    assert [r.candidate for r in again] == [r.candidate for r in results]


def test_autotune_matmul_refuses_tiles_that_do_not_divide():
    from repro_torch.kernels import brgemm

    with pytest.raises(LegalityError):
        brgemm.autotune_matmul(100, 64, 64, tiles=(64, 64, 64), use_cache=False)
