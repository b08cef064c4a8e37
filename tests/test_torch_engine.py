"""The port's paged model path and continuous-batching engine against the
JAX package, on the CPU, for reduced fp32 configs with the reference's own
weights (``repro.models.lm.init_params`` → numpy → ``params_from_numpy``).

Paged logits are held to the port's dense logits at atol 2e-4 (the
reference's own paged-vs-dense tolerance, ``test_serve_engine.py``) and to
the reference's paged logits at rtol 1e-4 / atol 1e-3 (two fp32 layers
summed in another order).  Reduced falcon-mamba-7b (Mamba-1 layers, no KV
pools) runs the same checks where its state replaces the pools.  Token lists, statuses and ``stats`` of the two
engines must be equal: the same calls drive both, and the sampler is
bit-exact (``test_torch_serve.py``), so a difference would be a fault of the
port.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs.base import get_config as jax_config
from repro.models import lm as jlm
from repro_torch import serve as tserve
from repro_torch.configs.base import get_config as torch_config
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.kvcache import pages_needed

PAGED_DENSE_ATOL = 2e-4
LOGIT_TOL = dict(rtol=1e-4, atol=1e-3)

# Engine shapes of the reference's fault tests (test_serve_faults.py).
E_RES = dict(num_slots=3, page_size=4, max_seq=64, segment_len=4, seed=7)
E_OPT = dict(E_RES, admission="optimistic", num_pages=10, thrash_preemptions=50)
E_TIGHT = dict(E_RES, admission="optimistic", num_pages=6, thrash_preemptions=50)
E_SMALL = dict(num_slots=1, page_size=4, max_seq=64, num_pages=2, segment_len=4, seed=7)
PKGS = {"jax": jserve, "torch": tserve}


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg, tcfg = jax_config(arch).reduced(), torch_config(arch).reduced()
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return {"jax": (jcfg, jparams), "torch": (tcfg, tparams)}


def _trace(n, seed, vocab, *, sampled=True):
    """Ragged requests; with ``sampled`` the knobs mix greedy rows with
    temperature, top-k and top-p rows."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        plen = int(rng.integers(3, 12))
        out.append(dict(
            prompt=rng.integers(1, vocab, size=plen).tolist(),
            max_new=int(rng.integers(4, 10)),
            temperature=float(rng.choice([0.0, 0.8, 1.0])) if sampled else 0.0,
            top_k=int(rng.choice([0, 5, 20])),
            top_p=float(rng.choice([1.0, 0.9]))))
    return out


def _drain(pkg, ecfg, reqs, *, faults=None, arch="minicpm_2b", fused=False):
    """Submit ``reqs`` to one package's engine and step it dry, validating
    after every step; → (tokens, statuses, stats, engine).  ``fused`` runs
    the config with ``use_fusion=True`` on the same weights."""
    mod = PKGS[pkg]
    cfg, params = _models(arch)[pkg]
    if fused:
        cfg = dataclasses.replace(cfg, use_fusion=True)
    eng = mod.Engine(cfg, params, mod.EngineConfig(**ecfg), faults=faults)
    for r in reqs:
        eng.submit(r["prompt"], r["max_new"], temperature=r["temperature"],
                   top_k=r["top_k"], top_p=r["top_p"])
    for _ in range(500):
        if eng.idle:
            break
        eng.step()
        eng.validate()
    assert eng.idle, f"{pkg} engine did not drain"
    assert eng.kv.free_pages == eng.kv.num_pages, f"{pkg} engine leaked pages"
    tokens = {uid: eng.collect(uid) for uid in sorted(eng._terminal)}
    statuses = {uid: eng.status(uid).value for uid in tokens}
    return tokens, statuses, eng.stats, eng


def _assert_same(want, got):
    assert got[1] == want[1], "statuses differ"
    assert got[2] == want[2], "stats differ"
    for uid, toks in want[0].items():
        assert got[0][uid] == toks, f"uid {uid}: tokens differ"


# --------------------------------------------------------------------------
# Paged model path
# --------------------------------------------------------------------------

def _shuffled_table(b, ppr, num_pages, seed):
    """(b, ppr + 1) table over a shuffled pool; the last column is the trash
    page, as a slot's unallocated columns are."""
    pages = np.random.default_rng(seed).permutation(num_pages)[: b * ppr]
    table = np.full((b, ppr + 1), num_pages, np.int32)
    table[:, :ppr] = pages.reshape(b, ppr)
    return table


@pytest.mark.parametrize("arch", ["llama2_13b", "minicpm_2b", "falcon_mamba_7b",
                                  "qwen3_moe_235b"])
def test_paged_cache_matches_dense_logits(arch):
    """Bucket-padded paged prefill and (B,)-position paged decode reproduce
    the dense-cache logits (the port's copy of the reference's test); for
    mamba layers the padding must leave the state of the unpadded prompt."""
    cfg, params = _models(arch)["torch"]
    rng = np.random.default_rng(0)
    b, p, new, ps = 3, 8, 5, 4
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, p)))

    caches = tlm.init_cache(cfg, b, p + new, device="cpu")
    logits, caches = tlm.prefill(cfg, params, caches, {"tokens": prompts})
    dense = [logits]
    tok = logits.argmax(-1)
    for t in range(new - 1):
        logits, caches = tlm.decode_step(cfg, params, caches, tok, p + t)
        dense.append(logits)
        tok = logits.argmax(-1)

    ppr = pages_needed(p + new, ps)
    num_pages = ppr * b + 2
    pcaches = tlm.init_paged_cache(cfg, b, num_pages, ps, device="cpu")
    table = torch.from_numpy(_shuffled_table(b, ppr, num_pages, seed=1))
    padded = torch.cat([prompts, torch.zeros(b, 16 - p, dtype=prompts.dtype)], 1)
    logits, pcaches = tlm.prefill(cfg, params, pcaches, {"tokens": padded},
                                  page_table=table, page_size=ps,
                                  logit_index=torch.full((b,), p - 1))
    paged = [logits]
    tok = logits.argmax(-1)
    pos = torch.full((b,), p)
    for _ in range(new - 1):
        logits, pcaches = tlm.decode_step(cfg, params, pcaches, tok, pos,
                                          page_table=table, page_size=ps)
        paged.append(logits)
        tok = logits.argmax(-1)
        pos = pos + 1

    for t, (d, q) in enumerate(zip(dense, paged)):
        np.testing.assert_allclose(q.numpy(), d.numpy(), atol=PAGED_DENSE_ATOL,
                                   err_msg=f"{arch} diverged at step {t}")


def test_dense_cache_per_slot_positions_match_scalar():
    """Ragged per-slot positions on a dense cache: each row equals a
    batch-1 decode at its own scalar position."""
    cfg, params = _models("llama2_13b")["torch"]
    rng = np.random.default_rng(2)
    b, smax = 3, 16
    lens = [5, 9, 7]
    caches = tlm.init_cache(cfg, b, smax, device="cpu")
    for i, n in enumerate(lens):
        row = [{k: v[i:i + 1] for k, v in c.items()} for c in caches]
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n)))
        tlm.prefill(cfg, params, row, {"tokens": toks})
    singles = [{k: v.clone() for k, v in c.items()} for c in caches]
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, b))
    got, _ = tlm.decode_step(cfg, params, caches, tok, torch.tensor(lens))
    for i, n in enumerate(lens):
        row = [{k: v[i:i + 1] for k, v in c.items()} for c in singles]
        want, _ = tlm.decode_step(cfg, params, row, tok[i:i + 1], n)
        np.testing.assert_allclose(got[i].numpy(), want[0].numpy(), atol=PAGED_DENSE_ATOL)


@pytest.mark.parametrize("arch", ["llama2_13b", "minicpm_2b"])
def test_paged_prefill_and_decode_match_reference(arch):
    """Prefill plus 5 paged decode steps, the same shuffled page table and
    tokens in both packages: logits and the pools' live rows agree."""
    (jcfg, jparams), (tcfg, tparams) = _models(arch)["jax"], _models(arch)["torch"]
    rng = np.random.default_rng(3)
    b, p, new, ps = 3, 8, 5, 4
    prompts = rng.integers(0, jcfg.vocab_size, (b, 16)).astype(np.int32)
    ppr = pages_needed(p + new, ps)
    num_pages = ppr * b + 2
    table = _shuffled_table(b, ppr, num_pages, seed=4)
    lidx = np.asarray([p - 1, p - 3, p - 2], np.int32)

    jprefill = jax.jit(lambda prm, c, t, tab, li: jlm.prefill(
        jcfg, prm, c, {"tokens": t}, page_table=tab, page_size=ps, logit_index=li))
    jstep = jax.jit(lambda prm, c, t, pos, tab: jlm.decode_step(
        jcfg, prm, c, t, pos, page_table=tab, page_size=ps))
    jc = jlm.init_paged_cache(jcfg, b, num_pages, ps)
    tc = tlm.init_paged_cache(tcfg, b, num_pages, ps, device="cpu")
    jl, jc = jprefill(jparams, jc, jnp.asarray(prompts), jnp.asarray(table), jnp.asarray(lidx))
    tl, tc = tlm.prefill(tcfg, tparams, tc, {"tokens": torch.from_numpy(prompts)},
                         page_table=torch.from_numpy(table), page_size=ps,
                         logit_index=torch.from_numpy(lidx))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL, err_msg="prefill")
    pos = lidx.astype(np.int32) + 1
    for t in range(new):
        toks = rng.integers(0, jcfg.vocab_size, b).astype(np.int32)
        jl, jc = jstep(jparams, jc, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(table))
        tl, tc = tlm.decode_step(tcfg, tparams, tc, torch.from_numpy(toks),
                                 torch.from_numpy(pos).long(),
                                 page_table=torch.from_numpy(table), page_size=ps)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL,
                                   err_msg=f"decode step {t}")
        pos = pos + 1
    live = table[:, :ppr]
    for layer, tcl in enumerate(tc):
        jk = np.asarray(jc["dec"][0][0]["attn"]["k"][layer])
        np.testing.assert_allclose(tcl["k"].numpy()[live], jk[live], **LOGIT_TOL,
                                   err_msg=f"layer {layer} pool")


# --------------------------------------------------------------------------
# The engine against the reference's engine
# --------------------------------------------------------------------------

ENGINE_CASES = {
    "ragged_greedy": (E_RES, dict(n=8, seed=1, sampled=False)),
    "mixed_sampled": (E_RES, dict(n=8, seed=2, sampled=True)),
    "optimistic_preempting": (E_TIGHT, dict(n=8, seed=3, sampled=True)),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_reference_engine(case):
    _engine_matches_reference(case, "minicpm_2b")


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_mamba_engine_matches_reference_engine(case):
    """Reduced falcon-mamba-7b: 8 requests on 3 slots, so slots are reused
    (a slot's mamba state must start from zero at each admission and
    re-prefill), with no KV pools at all."""
    _engine_matches_reference(case, "falcon_mamba_7b")


def _engine_matches_reference(case, arch):
    ecfg, trace_kw = ENGINE_CASES[case]
    cfg = _models(arch)["torch"][0]
    reqs = _trace(vocab=cfg.vocab_size, **trace_kw)
    if case == "mixed_sampled":
        for i, r in enumerate(reqs):   # the engine phase's knobs on odd rows
            r.update(temperature=0.8 if i % 2 else 0.0, top_k=5, top_p=0.9)
    want = _drain("jax", ecfg, reqs, arch=arch)
    got = _drain("torch", ecfg, reqs, arch=arch)
    _assert_same(want, got)
    for uid, r in enumerate(reqs):
        assert len(got[0][uid]) == len(r["prompt"]) + r["max_new"]
    if case == "optimistic_preempting":
        assert got[2]["preemptions"] > 0 and got[2]["page_grows"] > 0


@pytest.mark.parametrize("case", ["ragged_greedy", "optimistic_preempting"])
def test_fused_engine_matches_reference_engine(case):
    """``use_fusion=True`` engines: the same tokens, statuses and stats as
    the reference's fused engine."""
    ecfg, trace_kw = ENGINE_CASES[case]
    cfg = _models("minicpm_2b")["torch"][0]
    reqs = _trace(vocab=cfg.vocab_size, **trace_kw)
    want = _drain("jax", ecfg, reqs, fused=True)
    got = _drain("torch", ecfg, reqs, fused=True)
    _assert_same(want, got)
    assert set(got[1].values()) == {"finished"}


@pytest.mark.parametrize("seed", [3, 11])
def test_chaos_plan_matches_reference(seed):
    """Allocator exhaustion, forced preemption, clock skew and a NaN-poisoned
    request, from ``FaultPlan.random`` on the optimistic engine: both
    packages end with the same statuses, tokens and stats."""
    cfg = _models("minicpm_2b")["torch"][0]
    reqs = _trace(8, seed, cfg.vocab_size)
    poison_uid = 2
    kw = dict(p_exhaust=0.25, p_preempt=0.15, p_delay=0.1, delay_s=0.001,
              poison=(poison_uid, len(reqs[poison_uid]["prompt"]) + 2))
    want = _drain("jax", E_OPT, reqs, faults=jserve.FaultPlan.random(seed, 40, **kw))
    got = _drain("torch", E_OPT, reqs, faults=tserve.FaultPlan.random(seed, 40, **kw))
    _assert_same(want, got)
    assert got[1][poison_uid] == "failed"
    assert got[3].flight.last_dump["reason"] == "nan_quarantine"


def _lifecycle(pkg):
    """Cancel from the queue and mid-decode, deadlines on a virtual clock,
    a prefill poisoned to NaN and a hopeless head, on the one-slot engine."""
    mod = PKGS[pkg]
    cfg, params = _models("minicpm_2b")[pkg]
    clock = [0.0]
    plan = mod.FaultPlan(delays={2: 10.0}, poison_uid=4, poison_pos=3)
    eng = mod.Engine(cfg, params, mod.EngineConfig(**E_SMALL), faults=plan,
                     clock=lambda: clock[0])
    u0 = eng.submit([1, 2], 6)
    u1 = eng.submit([4, 5], 4)
    eng.step()
    log = [eng.cancel(u1), eng.cancel(u0), eng.cancel(u0)]
    eng.submit([7, 8], 6, deadline=5.0)      # running when the skew hits
    eng.submit([3, 1], 4, ttft_deadline=2.0)
    eng.step()
    eng.submit([1, 2], 3)                 # uid 4: NaN logits at prefill
    eng.submit([1] * 20, 10)              # needs more pages than the pool
    eng.submit([6, 6], 3, uid=9)
    with pytest.raises(ValueError, match="duplicate uid 9"):
        eng.submit([1], 2, uid=9)
    for _ in range(50):
        if eng.idle:
            break
        eng.step()
        eng.validate()
    tokens = {uid: eng.collect(uid) for uid in sorted(eng._terminal)}
    return log, tokens, {u: eng.status(u).value for u in tokens}, eng.stats


def test_lifecycle_matches_reference():
    want, got = _lifecycle("jax"), _lifecycle("torch")
    assert got == want
    assert set(got[2].values()) == {"cancelled", "timed_out", "failed", "finished"}


def test_forced_preemption_resumes_bit_identical():
    _forced_preemption("minicpm_2b")


def test_mamba_forced_preemption_resumes_bit_identical():
    _forced_preemption("falcon_mamba_7b")


def _forced_preemption(arch):
    cfg = _models(arch)["torch"][0]
    reqs = _trace(5, 2, cfg.vocab_size)
    golden = _drain("torch", E_RES, reqs, arch=arch)[0]
    plan = tserve.FaultPlan(preempt_steps=frozenset({1, 2}))
    tokens, statuses, stats, eng = _drain("torch", E_RES, reqs, faults=plan, arch=arch)
    assert stats["preemptions"] >= 1
    assert any(m["preemptions"] for m in eng.metrics.values())
    assert tokens == golden
    assert set(statuses.values()) == {"finished"}


@pytest.mark.parametrize("greedy", [True, False])
def test_engine_matches_generate_loop(greedy):
    """``generate`` (the engine, uid i for row i) gives ``generate_loop``'s
    tokens, greedy and sampled."""
    cfg, params = _models("minicpm_2b")["torch"]
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 8))
    scfg = tserve.ServeConfig(max_seq=64, greedy=greedy, temperature=1.5, top_k=20, seed=13)
    want = tserve.generate_loop(cfg, params, prompts, 6, scfg=scfg)
    got = tserve.generate(cfg, params, prompts, 6, scfg=scfg)
    torch.testing.assert_close(got, want)
    with pytest.raises(ValueError, match="exceeds"):
        tserve.generate(cfg, params, prompts, 60, scfg=scfg)


def test_mamba_engine_matches_generate_loop():
    """Reduced falcon-mamba-7b: ``generate`` (the engine, per-slot state)
    gives ``generate_loop``'s tokens (dense state), sampled."""
    cfg, params = _models("falcon_mamba_7b")["torch"]
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 8))
    scfg = tserve.ServeConfig(max_seq=64, greedy=False, temperature=1.5, top_k=20, seed=13)
    want = tserve.generate_loop(cfg, params, prompts, 6, scfg=scfg)
    got = tserve.generate(cfg, params, prompts, 6, scfg=scfg)
    torch.testing.assert_close(got, want)


def test_engine_rejects_what_it_cannot_serve():
    cfg, params = _models("minicpm_2b")["torch"]
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        tserve.Engine(dataclasses.replace(cfg, is_encdec=True), params,
                      tserve.EngineConfig(**E_RES))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tserve.Engine(dataclasses.replace(cfg, use_mla=True), params,
                      tserve.EngineConfig(**E_RES))
    with pytest.raises(ValueError, match="admission"):
        tserve.EngineConfig(admission="greedy")
