"""``repro_torch.obs.profiler``, ``obs.report`` and ``serve.tuning``
against the reference's on the CPU (``tests/test_obs.py``'s profiler and
tune-cache counter cases, ``tests/test_serve_engine.py``'s serving-shape
split), each beside its reference where the two compute the same thing.

The profiler's device takes the place of the reference's ``backend``: on
the CPU it times K5's plain version on the host clock (an injected clock
in the golden test).  Under ``TpuTarget`` ``tune_serving_shapes``' report
and ``run_report``'s winning schedules and predictions equal the
reference's.  The card itself (CUDA events, K5 under each schedule) is
exercised by ``chip_smoke.py`` phase 7i.
"""
import json

import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.obs import profiler as jprofiler
from repro.obs import report as jreport
from repro.serve import tuning as jtuning
from repro_torch import fusion as tf
from repro_torch.configs.base import get_config
from repro_torch.core import perf_model
from repro_torch.obs import metrics, profiler, report
from repro_torch.serve import tuning

TPU = perf_model.TpuTarget()


@pytest.fixture(autouse=True)
def _own_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE_DIR", str(tmp_path / "default-cache"))


class FakeClock:
    """Deterministic monotonic clock: each call advances by ``tick``."""

    def __init__(self, tick=1.0, t=0.0):
        self.tick, self.t = tick, t

    def __call__(self):
        self.t += self.tick
        return self.t


# ---------------------------------------------------------------------------
# Kernel profiler: drift goldens on a scripted clock
# ---------------------------------------------------------------------------

def test_time_callable_median_with_fake_clock():
    med, samples = profiler.time_callable(lambda: 0, iters=3, warmup=1, clock=FakeClock(1.0),
                                          device="cpu")
    assert samples == [1.0, 1.0, 1.0] and med == 1.0
    ref = jprofiler.time_callable(lambda: 0, iters=3, warmup=1, clock=FakeClock(1.0))
    assert (med, samples) == ref
    with pytest.raises(ValueError):
        profiler.time_callable(lambda: 0, iters=0, device="cpu")


def test_time_callable_on_cuda_takes_no_host_clock():
    with pytest.raises(ValueError, match="CUDA events"):
        profiler.time_callable(lambda: 0, iters=1, clock=FakeClock(), device="cuda")


def test_time_callable_counts_warmup_and_iters():
    calls = []
    profiler.time_callable(lambda: calls.append(1), iters=4, warmup=2, device="cpu")
    assert len(calls) == 6


def _rec(mod, name, predicted, measured, **where):
    return mod.ProfileRecord(name=name, shape=(8, 8, 8), spec="bca", predicted_s=predicted,
                             measured_s=measured, bound="compute", iters=1, warmup=0,
                             samples=[measured], **where)


def test_drift_flags_relative_to_median():
    uniform = [_rec(profiler, f"g{i}", 1e-6, 1e-4, device="cpu") for i in range(3)]
    assert profiler.drift_flags(uniform) == [False, False, False]
    recs = uniform + [_rec(profiler, "outlier", 1e-6, 1e-2, device="cpu")]
    jrecs = [_rec(jprofiler, r.name, r.predicted_s, r.measured_s, backend="xla") for r in recs]
    assert profiler.drift_flags(recs) == jprofiler.drift_flags(jrecs) == [False] * 3 + [True]
    table = profiler.attribution_table(recs)
    assert "DRIFT" in table and "outlier" in table and table.count("DRIFT") == 1
    assert table.splitlines()[0].split()[2] == "device"


@pytest.mark.parametrize("name,args", [("fused_mlp_graph", ("gelu",)),
                                       ("fused_output_graph", (0.1,)),
                                       ("fused_gated_mlp_graph", ("silu",))],
                         ids=lambda v: str(v))
def test_synth_operands_draw_the_references_values(name, args):
    from repro import fusion as jf
    g, jg = getattr(tf, name)(*args), getattr(jf, name)(*args)
    ops = profiler.synth_operands(g, 16, 32, 64, seed=5, device="cpu")
    jops = jprofiler.synth_operands(jg, 16, 32, 64, seed=5)
    assert set(ops) == set(jops)
    for nm, v in ops.items():
        want = np.asarray(jops[nm])
        got = v if isinstance(v, int) else v.numpy()
        np.testing.assert_array_equal(np.asarray(got), want.astype(np.asarray(got).dtype))


def test_profile_graph_smoke():
    g = tf.fused_mlp_graph("gelu")
    rec = profiler.profile_graph(g, 32, 64, 64, device="cpu", iters=2, warmup=1)
    assert rec.measured_s > 0 and rec.predicted_s > 0
    assert rec.bound in ("compute", "memory", "collective")
    assert rec.shape == (32, 64, 64) and rec.device == "cpu"
    json.dumps(rec.to_dict())
    # the prediction is graph_cost's for the same schedule and tiles
    from repro.fusion import library as jlib
    jrec = jprofiler.profile_graph(jlib.fused_mlp_graph("gelu"), 32, 64, 64, backend="xla",
                                   iters=1, warmup=0)
    again = profiler.profile_graph(g, 32, 64, 64, device="cpu", iters=1, warmup=0, target=TPU)
    assert (again.spec, again.predicted_s, again.bound) == (jrec.spec, jrec.predicted_s,
                                                            jrec.bound)


def test_make_measure_fn_feeds_autotune():
    g = tf.fused_mlp_graph("gelu")
    results = tf.measured_autotune_graph(g, 32, 64, 64, device="cpu", max_candidates=4, top_k=2,
                                         use_cache=False, measure_iters=1, measure_warmup=0)
    assert results and results[0].measured_s is not None
    measured = [r.measured_s for r in results if r.measured_s is not None]
    assert measured == sorted(measured)


def test_make_measure_fn_runs_each_schedule():
    g = tf.fused_gated_mlp_graph("silu")
    seen = []
    clock = FakeClock(0.5)
    measure = profiler.make_measure_fn(g, 64, 64, 128, device="cpu", tiles=(16, 32, 32),
                                       iters=1, warmup=0, clock=clock)
    results = tf.autotune_graph(g, 64, 64, 128, tiles=(16, 32, 32), max_candidates=20, top_k=3,
                                use_cache=False,
                                measure_fn=lambda c: seen.append(c.spec_string) or measure(c))
    assert len(seen) == 3 and all(r.measured_s == 0.5 for r in results[:3])


# ---------------------------------------------------------------------------
# Tune-cache counters
# ---------------------------------------------------------------------------

def test_tunecache_counters(tmp_path):
    from repro_torch.core.tunecache import TuneCache
    reg = metrics.Registry()
    old = metrics.set_default_registry(reg)
    try:
        tc = TuneCache(tmp_path)
        key = "k" * 64
        assert tc.lookup(key) is None
        assert reg.counter("tune.cache.misses").value == 1
        tc.store(key, {"specs": ["bca"]})
        assert tc.lookup(key)["specs"] == ["bca"]
        assert reg.counter("tune.cache.hits").value == 1
        tc._file(key).write_text("{not json")
        with pytest.warns(RuntimeWarning, match="corrupted"):
            assert tc.lookup(key) is None
        assert reg.counter("tune.cache.corrupt_recoveries").value == 1
        assert reg.counter("tune.cache.misses").value == 2
        assert not tc._file(key).exists()
        snap = reg.snapshot()
        assert snap["tune.cache.hits"] == 1 and snap["tune.cache.misses"] == 2
        assert reg.enabled and not metrics.NULL_REGISTRY.enabled
        assert metrics.NULL_REGISTRY.snapshot() == {}
    finally:
        metrics.set_default_registry(old)


def test_registry_snapshot_summarises_histograms():
    reg = metrics.Registry()
    reg.counter("a").inc(3)
    reg.gauge("b").set(2.5)
    h = reg.histogram("c")
    for v in (1e-4, 2e-3, 5.0):
        h.observe(v)
    snap = reg.snapshot()
    assert snap["a"] == 3 and snap["b"] == 2.5
    assert snap["c"]["count"] == 3 and snap["c"]["p50"] == 3e-3
    json.dumps(snap)


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------

def test_run_report_equals_the_reference_under_the_tpu_target(tmp_path):
    clock = FakeClock(1e-3)
    payload = report.run_report(128, 256, 256, device="cpu", iters=1, warmup=0, smoke=True,
                                clock=clock, target=TPU, cache_dir=tmp_path)
    ref = jreport.run_report(128, 256, 256, backend="xla", iters=1, warmup=0, smoke=True,
                             clock=FakeClock(1e-3))
    got = [(r["name"], r["spec"], r["predicted_s"], r["bound"]) for r in payload["records"]]
    want = [(r["name"], r["spec"], r["predicted_s"], r["bound"]) for r in ref["records"]]
    assert got == want
    assert [r["measured_s"] for r in payload["records"]] == [1e-3, 1e-3]
    assert payload["drift_flags"] == ref["drift_flags"] == [False, False]
    assert payload["device"] == "cpu" and payload["dtype"] == "float32"
    assert "tune.searches" in payload["counters"]


def test_report_main_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE_DIR", str(tmp_path / "cache"))
    out = tmp_path / "report.json"
    assert report.main(["--device", "cpu", "--smoke", "--shape", "64", "128", "128",
                        "--iters", "1", "--warmup", "0", "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "model-vs-measured attribution" in text and "fused_gated_mlp_silu" in text
    assert "tune.cache.misses" in text
    payload = json.loads(out.read_text())
    assert len(payload["records"]) == 2 and payload["target"] == "h100_sxm"
    # a second run finds both searches in the cache
    assert report.main(["--device", "cpu", "--smoke", "--shape", "64", "128", "128",
                        "--iters", "1", "--warmup", "0"]) == 0
    assert "tune.cache.hits" in capsys.readouterr().out


def test_report_main_without_a_card_fails(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert report.main(["--smoke"]) != 0
    assert "no CUDA device" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Prefill-vs-decode tune split
# ---------------------------------------------------------------------------

def test_tune_serving_shapes_split_phases(tmp_path):
    cfg = get_config("minicpm_2b").reduced()
    rep = tuning.tune_serving_shapes(cfg, num_slots=4, prefill_buckets=(32,), max_candidates=4,
                                     cache_dir=str(tmp_path / "tune"))
    assert set(rep) == {"decode", "prefill@32"}
    dec = {r["graph"]: r for r in rep["decode"]}
    pre = {r["graph"]: r for r in rep["prefill@32"]}
    assert set(dec) == set(pre)
    for name in dec:
        assert dec[name]["m"] == 4 and pre[name]["m"] == 32
        assert dec[name]["spec"] and pre[name]["spec"]


@pytest.mark.parametrize("arch", ["minicpm_2b", "llama2_13b", "gptj_6b"])
def test_tune_serving_shapes_equals_the_reference(tmp_path, arch, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE_DIR", str(tmp_path / "reference"))
    cfg = get_config(arch)
    jcfg = jget_config(arch)
    if arch == "minicpm_2b":
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert [(nm, tf.graph_signature(g), k, n) for nm, g, k, n in tuning.serving_graph_shapes(cfg)] \
        == [(nm, tf.graph_signature(g), k, n) for nm, g, k, n in
            jtuning.serving_graph_shapes(jcfg)]
    kw = dict(num_slots=8, prefill_buckets=(64, 512), max_candidates=16)
    got = tuning.tune_serving_shapes(cfg, target=TPU, cache_dir=str(tmp_path / "port"), **kw)
    want = jtuning.tune_serving_shapes(jcfg, cache_dir=str(tmp_path / "reference"), **kw)
    assert got == want
    h100 = tuning.tune_serving_shapes(cfg, dtype=torch.bfloat16, cache_dir=str(tmp_path / "port"),
                                      **kw)
    assert set(h100) == set(want)
    assert all(r["cost"] > 0 for rows in h100.values() for r in rows)


# ---------------------------------------------------------------------------
# The measured re-rank is keyed by the device it was measured on
# ---------------------------------------------------------------------------

def test_measured_rerank_is_keyed_by_its_device(tmp_path, monkeypatch):
    """A re-rank measured on the CPU is not served to a caller measuring on
    the card, nor to a model-only search; one measured on a device serves
    a later caller measuring on that device, which measures nothing."""
    from repro_torch.core import tunecache

    measured_on = []

    def fake_make_measure_fn(graph, m, k, n, *, device, **_kw):
        def measure(candidate):
            measured_on.append(str(device))
            return 1.0 / len(measured_on)      # each later one faster: the top 3 reverse
        return measure

    monkeypatch.setattr(profiler, "make_measure_fn", fake_make_measure_fn)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    g = tf.fused_mlp_graph("gelu")
    tc = tunecache.TuneCache(tmp_path / "cache")
    kw = dict(max_candidates=8, top_k=4, cache=tc, return_stats=True)
    model, s0 = tf.autotune_graph(g, 32, 64, 64, **kw)
    cpu, s1 = tf.measured_autotune_graph(g, 32, 64, 64, device="cpu", measure_top_k=3, **kw)
    assert not s0.cache_hit and not s1.cache_hit and measured_on == ["cpu"] * 3
    assert [r.candidate for r in cpu[:3]] == [r.candidate for r in reversed(model[:3])]
    card, s2 = tf.measured_autotune_graph(g, 32, 64, 64, device="cuda", measure_top_k=3, **kw)
    assert not s2.cache_hit and measured_on[3:] == ["cuda"] * 3
    assert [r.measured_s for r in card[:3]] == [1 / 6, 1 / 5, 1 / 4]
    again, s3 = tf.measured_autotune_graph(g, 32, 64, 64, device="cpu", measure_top_k=3, **kw)
    assert s3.cache_hit and len(measured_on) == 6
    assert [r.measured_s for r in again] == [r.measured_s for r in cpu]
    plain, s4 = tf.autotune_graph(g, 32, 64, 64, **kw)
    assert s4.cache_hit and all(r.measured_s is None for r in plain)
    assert [r.candidate for r in plain] == [r.candidate for r in model]
