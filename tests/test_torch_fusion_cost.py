"""``repro_torch.fusion.cost`` against ``repro.fusion.cost`` on the CPU
(``tests/test_fusion.py``'s cost-path cases and ``tests/test_fusion_autodiff.py``'s
backward-graph cases, each beside its reference).

Under ``TpuTarget`` ``graph_cost``'s reports, ``estimate_unfused``'s
prices, ``autotune_graph``'s ranked schedules and search counts, and
``graph_signature``'s strings equal the reference's.  Every tuned schedule
runs K5's plain version through ``compile_for_device`` on CPU tensors: its
output is bitwise the fixed schedule's and within fp32 tolerance (rtol
1e-4, atol 1e-3: sums in another order, ``tests/test_torch_fusion.py``'s)
of the reference's XLA path on the same numpy inputs.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fusion as jf
from repro.fusion import autodiff as jautodiff
from repro_torch import fusion as tf
from repro_torch.core import perf_model
from repro_torch.fusion import autodiff as tautodiff
from repro_torch.fusion import cost

TPU = perf_model.TpuTarget()
F32_TOL = dict(rtol=1e-4, atol=1e-3)
M, K, N = 32, 64, 128


@pytest.fixture(autouse=True)
def _own_tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE_DIR", str(tmp_path / "default-cache"))


def _operands(graph, m, k, n, seed=0):
    """numpy operands → (jax dict, torch dict), fp32, rowvecs fp32."""
    rng = np.random.default_rng(seed)
    jops, tops = {}, {}
    for spec in graph.operands:
        if spec.kind == "mask":
            v = rng.random((m, n)) > 0.4
            jops[spec.name], tops[spec.name] = jnp.asarray(v), torch.from_numpy(v)
            continue
        if spec.kind == "scalar":
            v = int(rng.integers(0, 2**31))
            jops[spec.name], tops[spec.name] = jnp.asarray(v, jnp.uint32), v
            continue
        shape = {"lhs": (k, m) if spec.trans else (m, k), "rhs": (n, k) if spec.trans else (k, n),
                 "tile": (m, n), "rowvec": (n,)}[spec.kind]
        v = rng.normal(size=shape).astype(np.float32)
        jops[spec.name], tops[spec.name] = jnp.asarray(v), torch.from_numpy(v)
    return jops, tops


def _same_report(ref, port):
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def _pair(name, *args, **kw):
    """The same library graph from both packages."""
    return getattr(jf, name)(*args, **kw), getattr(tf, name)(*args, **kw)


LIBRARY = [("fused_output_graph", (0.1,)), ("fused_output_graph", (0.0,)),
           ("fused_mlp_graph", ("relu",)), ("fused_mlp_graph", ("gelu",)),
           ("fused_gated_mlp_graph", ("silu",)), ("fused_qkv_graph", ()),
           ("fused_attn_out_graph", ()), ("fused_attn_out_graph", (True, "layernorm")),
           ("fused_attention_graph", ())]


@pytest.mark.parametrize("name,args", LIBRARY, ids=lambda v: str(v))
def test_graph_signature_equals_the_reference(name, args):
    jg, tg = _pair(name, *args)
    assert tf.graph_signature(tg) == jf.graph_signature(jg)
    assert tf.graph_signature(tf.simplify_graph(tg)) == jf.graph_signature(jf.simplify_graph(jg))


@pytest.mark.parametrize("name,args", LIBRARY[:-1], ids=lambda v: str(v))
@pytest.mark.parametrize("spec,steps", [("bca", None), ("cba", None), ("bcba", {"b": (2,)})])
def test_graph_cost_equals_the_reference(name, args, spec, steps):
    jg, tg = _pair(name, *args)
    if spec != "bca" and tg.reducing_node() is not None:
        spec, steps = "bbca", {"b": (2,)}
    kw = dict(tiles=(32, 64, 64), dtype=np.float32, spec_string=spec, block_steps=steps)
    _same_report(jf.graph_cost(jg, 256, 256, 256, **kw),
                 tf.graph_cost(tg, 256, 256, 256, target=TPU, **kw))
    rep = tf.graph_cost(tg, 256, 256, 256, **kw)          # the card's rule
    assert rep.hbm_bytes > 0 and rep.total_time > 0


def test_graph_cost_counts_epilogue_traffic_and_flops():
    m, k, n = 256, 256, 256
    for target in (TPU, perf_model.H100Target()):
        kw = dict(tiles=(32, 64, 64), dtype=np.float32, target=target)
        rep_full = tf.graph_cost(tf.fused_output_graph(0.1), m, k, n, **kw)
        rep_plain = tf.graph_cost(tf.fused_mlp_graph("relu"), m, k, n, **kw)
        assert rep_full.hbm_bytes > rep_plain.hbm_bytes
        assert rep_full.compute_time > rep_plain.compute_time
        assert len(rep_full.fetches) == len(tf.fused_output_graph(0.1).operands) + 1
        rep0 = tf.graph_cost(tf.fused_output_graph(0.0), m, k, n, **kw)
        assert len(rep0.fetches) == len(rep_full.fetches) - 1


def _search_pair(name, args, m, k, n, **kw):
    jg, tg = _pair(name, *args)
    ref = jf.autotune_graph(jg, m, k, n, use_cache=False, return_stats=True, **kw)
    port = tf.autotune_graph(tg, m, k, n, use_cache=False, return_stats=True, target=TPU, **kw)
    return ref, port


def _ranked(results):
    return [(r.candidate.spec_string, [l.block_steps for l in r.candidate.loops])
            for r in results]


def _assert_same_search(ref, port):
    (rr, rs), (pr, ps) = ref, port
    assert _ranked(pr) == _ranked(rr)
    a, b = dataclasses.asdict(ps), dataclasses.asdict(rs)
    a.pop("search_time_s"), b.pop("search_time_s")
    assert a == b
    assert [r.score for r in pr] == pytest.approx([r.score for r in rr], rel=1e-12)


@pytest.mark.parametrize("name,args", [("fused_output_graph", (0.0,)),
                                       ("fused_gated_mlp_graph", ("silu",)),
                                       ("fused_mlp_graph", ("gelu",))], ids=lambda v: str(v))
def test_autotune_graph_equals_the_reference(name, args):
    _assert_same_search(*_search_pair(name, args, 128, 128, 256, tiles=(16, 32, 64),
                                      max_candidates=60))


def test_autotune_graph_returns_legal_ranked_schedules():
    """Every surviving schedule plans and runs: K5's plain version under it
    is bitwise the fixed schedule's and within fp32 tolerance of the
    reference's XLA path."""
    jg, g = _pair("fused_output_graph", 0.0)
    results = tf.autotune_graph(g, 128, 128, 256, tiles=(16, 32, 64), max_candidates=60)
    assert results, "no legal fused schedules found"
    scores = [r.score for r in results]
    assert scores == sorted(scores, reverse=True)
    jops, tops = _operands(g, 128, 128, 256)
    fixed = tf.compile_for_device(g)(**tops)
    want = np.asarray(jf.compile(jg, path="xla")(**jops))
    for r in results:
        out = tf.compile_for_device(g, tiles=(16, 32, 64), **tf.schedule_kwargs(r.candidate))(**tops)
        assert out.shape == (128, 256)
        assert torch.equal(out, fixed), r.candidate.spec_string
        np.testing.assert_allclose(out.numpy(), want, **F32_TOL)


@pytest.mark.parametrize("name,args", [("fused_gated_mlp_graph", ("silu",)),
                                       ("fused_output_graph", (0.1,)),
                                       ("fused_attn_out_graph", (True, "rmsnorm"))],
                         ids=lambda v: str(v))
def test_tuned_schedule_plain_version_is_bitwise_the_fixed_grid(name, args):
    g = getattr(tf, name)(*args)
    m, k, n = 64, 64, 128
    results = tf.autotune_graph(g, m, k, n, tiles=(16, 32, 32), max_candidates=40, top_k=4)
    _, tops = _operands(g, m, k, n, seed=3)
    fixed = tf.compile_for_device(g)(**tops)
    for r in results:
        out = tf.compile_for_device(g, tiles=(16, 32, 32), **tf.schedule_kwargs(r.candidate))(
            **tops)
        assert torch.equal(out, fixed), r.candidate.spec_string


def test_autotune_graph_multi_root_ranks_and_caches(tmp_path):
    jg, g = _pair("fused_gated_mlp_graph", "silu")
    kw = dict(tiles=(16, 32, 64), max_candidates=60, cache_dir=tmp_path, return_stats=True)
    results, stats = tf.autotune_graph(g, 128, 128, 256, **kw)
    assert results and not stats.cache_hit
    scores = [r.score for r in results]
    assert scores == sorted(scores, reverse=True)
    jops, tops = _operands(g, 128, 128, 256)
    out = tf.compile_for_device(g, tiles=(16, 32, 64), **tf.schedule_kwargs(results[0].candidate))(
        **tops)
    np.testing.assert_allclose(out.numpy(), np.asarray(jf.compile(jg, path="xla")(**jops)),
                               **F32_TOL)
    again, stats2 = tf.autotune_graph(g, 128, 128, 256, **kw)
    assert stats2.cache_hit and stats2.candidates_generated == 0
    assert [r.candidate.spec_string for r in again[:5]] == \
        [r.candidate.spec_string for r in results[:5]]
    _res3, stats3 = tf.autotune_graph(tf.fused_qkv_graph(), 128, 128, 256, **kw)
    assert not stats3.cache_hit


def test_graph_signature_distinguishes_roots_and_outputs():
    sigs = {tf.graph_signature(g) for g in (tf.fused_mlp_graph("gelu"),
                                            tf.fused_gated_mlp_graph("silu"),
                                            tf.fused_qkv_graph())}
    assert len(sigs) == 3


def test_graph_signature_keys_dropout_rate_and_scheme():
    def sig(f, g):
        return f.graph_signature(f.simplify_graph(g))

    for rng_dropout in (True, False):
        sigs = {sig(tf, tf.fused_output_graph(r, rng_dropout=rng_dropout))
                for r in (0.0, 0.1, 0.2)}
        assert len(sigs) == 3, rng_dropout
        for r in (0.0, 0.1, 0.2):
            assert sig(tf, tf.fused_output_graph(r, rng_dropout=rng_dropout)) == \
                sig(jf, jf.fused_output_graph(r, rng_dropout=rng_dropout))
    assert sig(tf, tf.fused_output_graph(0.1)) != sig(
        tf, tf.fused_output_graph(0.1, rng_dropout=False))
    from repro_torch.fusion import rng as trng
    assert f"rng:{trng.SCHEME}" in sig(tf, tf.fused_output_graph(0.1))
    assert "rng:" not in sig(tf, tf.fused_output_graph(0.1, rng_dropout=False))
    assert sig(tf, tf.fused_output_graph(0.1, dropout_salt=1)) != sig(
        tf, tf.fused_output_graph(0.1, dropout_salt=2))


def test_cross_rate_autotune_cache_miss(tmp_path):
    for rng_dropout in (True, False):
        kw = dict(tiles=(16, 32, 64), max_candidates=12, cache_dir=tmp_path, return_stats=True)
        g1 = tf.fused_output_graph(0.1, rng_dropout=rng_dropout)
        g2 = tf.fused_output_graph(0.2, rng_dropout=rng_dropout)
        g0 = tf.fused_output_graph(0.0, rng_dropout=rng_dropout)
        _r, s1 = tf.autotune_graph(g1, 128, 128, 256, **kw)
        _r, s1b = tf.autotune_graph(g1, 128, 128, 256, **kw)
        _r, s2 = tf.autotune_graph(g2, 128, 128, 256, **kw)
        _r, s0 = tf.autotune_graph(g0, 128, 128, 256, **kw)
        assert not s1.cache_hit and s1b.cache_hit, rng_dropout
        assert not s2.cache_hit, rng_dropout
        assert not s0.cache_hit, rng_dropout


def test_multi_root_graph_cost_scales_flops_and_shares_lhs():
    m = k = n = 256
    for target in (TPU, perf_model.H100Target()):
        kw = dict(tiles=(32, 64, 64), dtype=np.float32, target=target)
        g2 = tf.fused_gated_mlp_graph("silu")
        rep2 = tf.graph_cost(g2, m, k, n, **kw)
        rep1 = tf.graph_cost(tf.fused_attn_out_graph(), m, k, n, **kw)
        ep = g2.epilogue_flops_per_elem() * m * n
        assert rep2.flops == pytest.approx(2 * rep1.flops + ep)
        assert rep2.hbm_bytes < 2 * rep1.hbm_bytes
        unf = tf.estimate_unfused(g2, m, k, n, dtype=np.float32, tiles=(32, 64, 64),
                                  target=target)
        assert rep2.hbm_bytes < unf.hbm_bytes


@pytest.mark.parametrize("tiles", [None, (32, 64, 64)])
def test_estimate_unfused_equals_the_reference(tiles):
    for name, args in (("fused_output_graph", (0.0,)), ("fused_gated_mlp_graph", ("silu",)),
                       ("fused_output_graph", (0.1,))):
        jg, tg = _pair(name, *args)
        ref = jf.estimate_unfused(jg, 1024, 1024, 1024, dtype=np.float32, tiles=tiles)
        port = tf.estimate_unfused(tg, 1024, 1024, 1024, dtype=np.float32, tiles=tiles,
                                   target=TPU)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_estimate_unfused_charges_roundtrips():
    m, k, n = 1024, 1024, 1024
    for target in (TPU, perf_model.H100Target()):
        unf = tf.estimate_unfused(tf.fused_output_graph(0.0), m, k, n, dtype=np.float32,
                                  target=target)
        assert unf.hbm_bytes > (m * k + k * n + m * n) * 4


def test_default_tiles_are_pick_tiles():
    from repro_torch.kernels.brgemm import pick_tiles
    assert cost._default_tiles(2048, 5120, 13824, torch.bfloat16) == \
        pick_tiles(2048, 5120, 13824, torch.bfloat16)
    assert cost._default_tiles(8, 5120, 5120, np.float32) == pick_tiles(8, 5120, 5120,
                                                                         torch.float32)


# ---------------------------------------------------------------------------
# Backward graphs ride the cost model and the persistent tune cache
# (tests/test_fusion_autodiff.py's cases)
# ---------------------------------------------------------------------------

def test_backward_graph_signatures_distinct():
    g = tf.fused_gated_mlp_graph("silu")
    jg = jf.fused_gated_mlp_graph("silu")
    bwd = tautodiff.backward_graphs(g)
    sigs = {tf.graph_signature(bg) for bg in bwd.values()}
    sigs.add(tf.graph_signature(g))
    assert len(sigs) == 4
    assert sigs == {jf.graph_signature(bg) for bg in jautodiff.backward_graphs(jg).values()} | \
        {jf.graph_signature(jg)}
    drhs = next(bg for nm, bg in bwd.items() if "@bwd_drhs" in nm)
    assert "x:lhs^T" in tf.graph_signature(drhs)


def test_backward_graph_hits_tune_cache(tmp_path):
    g = tf.fused_gated_mlp_graph("silu")
    drhs = next(bg for nm, bg in tautodiff.backward_graphs(g).items() if "@bwd_drhs" in nm)
    kw = dict(tiles=(16, 16, 64), max_candidates=12, cache_dir=tmp_path, return_stats=True)
    r1, s1 = tf.autotune_graph(drhs, K, M, N, **kw)
    r2, s2 = tf.autotune_graph(drhs, K, M, N, **kw)
    assert not s1.cache_hit and s2.cache_hit
    assert [r.candidate.spec_string for r in r1] == [r.candidate.spec_string for r in r2]
    jg = jf.fused_gated_mlp_graph("silu")
    jdrhs = next(bg for nm, bg in jautodiff.backward_graphs(jg).items() if "@bwd_drhs" in nm)
    ref = jf.autotune_graph(jdrhs, K, M, N, tiles=(16, 16, 64), max_candidates=12,
                            use_cache=False, return_stats=True)
    port = tf.autotune_graph(drhs, K, M, N, tiles=(16, 16, 64), max_candidates=12,
                             use_cache=False, return_stats=True, target=TPU)
    _assert_same_search(ref, port)


def test_backward_graph_cost_prices_transposed_ops():
    g = tf.fused_mlp_graph("gelu")
    dlhs = next(bg for nm, bg in tautodiff.backward_graphs(g).items() if "@bwd_dlhs" in nm)
    jg = jf.fused_mlp_graph("gelu")
    jdlhs = next(bg for nm, bg in jautodiff.backward_graphs(jg).items() if "@bwd_dlhs" in nm)
    rep = tf.graph_cost(dlhs, M, N, K, tiles=(16, 64, 32), dtype=np.float32)
    assert rep.total_time > 0 and rep.hbm_bytes > 0
    _same_report(jf.graph_cost(jdlhs, M, N, K, tiles=(16, 64, 32), dtype=np.float32),
                 tf.graph_cost(dlhs, M, N, K, tiles=(16, 64, 32), dtype=np.float32, target=TPU))
