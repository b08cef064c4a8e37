"""gemma3-12b's serving path in the port against the JAX package, on the
CPU, at the fp32 ``reduced()`` config (6 layers, 5 local of a 32-key window
and 1 global) with the reference's own weights: the ring-buffer local cache
(``init_cache(ring_local=True)``), per-slot decode on it, prompts longer
than the window through ``generate_loop`` and the engine, the two chunks
the port's ring refuses, and ``kernels.ref.attention_chunked``, the plain
attention in query blocks the CPU runs once the scores would be large.

Logits are held at rtol 1e-4 / atol 1e-3 against the reference, and at atol
2e-4 against the port's own full-length cache or full forward (the
reference's ring test, ``tests/test_launch.py``); tokens must be equal.
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
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.serve import decode as jdecode
from repro_torch import serve as tserve
from repro_torch.configs.base import get_config as torch_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import decode as tdecode

LOGIT_TOL = dict(rtol=1e-4, atol=1e-3)
SELF_ATOL = 2e-4
B, S, P = 2, 24, 4            # 20 decode steps past a 4-token prompt: two wraps of 8


@functools.lru_cache(maxsize=None)
def _models(window=None):
    """Both packages' reduced gemma3 on the reference's weights;
    ``window`` replaces the reduced config's 32-key sliding window."""
    jcfg, tcfg = jax_config("gemma3_12b").reduced(), torch_config("gemma3_12b").reduced()
    if window is not None:
        jcfg = dataclasses.replace(jcfg, sliding_window=window)
        tcfg = dataclasses.replace(tcfg, sliding_window=window)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _full_logits(cfg, params, toks):
    """The port's full forward: (B, S, V) fp32 logits at every position."""
    h, _, _ = tlm.forward_hidden(cfg, params, {"tokens": torch.from_numpy(toks)}, remat=False)
    b, s, d = h.shape
    return tlm._logits(cfg, params, h.reshape(b * s, d)).view(b, s, -1)


def _jax_step(jcfg):
    return jax.jit(lambda p, c, t, pos: jlm.decode_step(jcfg, p, c, t, pos))


def test_ring_cache_shapes():
    """Local layers hold min(max_seq, window) positions, global ones
    max_seq, as the reference's ``init_cache(ring_local=True)``."""
    jcfg, _, tcfg, _ = _models(8)
    tc = tlm.init_cache(tcfg, B, S, ring_local=True, device="cpu")
    jc = jlm.init_cache(jcfg, B, S, ring_local=True)
    kinds = tlm.layer_kinds(tcfg)
    assert kinds == ["local"] * 5 + ["global"]
    for i, (kind, c) in enumerate(zip(kinds, tc)):
        assert c["k"].shape == (B, tcfg.num_kv_heads, 8 if kind == "local" else S, tcfg.head_dim)
        assert c["k"].shape == jc["dec"][0][i]["attn"]["k"].shape[1:]
    # the full-length cache where the ring is not asked for, or max_seq < window
    assert tlm.init_cache(tcfg, B, S, device="cpu")[0]["k"].shape[2] == S
    assert tlm.init_cache(tcfg, B, 5, ring_local=True, device="cpu")[0]["k"].shape[2] == 5


def test_ring_cache_matches_reference_across_wraps():
    """Window 8, a 4-token prompt, 20 decode steps (two wraps): each step's
    logits and the final ring contents equal the reference's ring."""
    jcfg, jparams, tcfg, tparams = _models(8)
    toks = _tokens(tcfg, (B, S), 1)
    jcache = jlm.init_cache(jcfg, B, S, ring_local=True)
    tcache = tlm.init_cache(tcfg, B, S, ring_local=True, device="cpu")
    jl, jcache = jlm.prefill(jcfg, jparams, jcache, {"tokens": jnp.asarray(toks[:, :P])})
    tl, tcache = tlm.prefill(tcfg, tparams, tcache, {"tokens": torch.from_numpy(toks[:, :P])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    jstep = _jax_step(jcfg)
    for t in range(P, S):
        jl, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t]), jnp.int32(t))
        tl, tcache = tlm.decode_step(tcfg, tparams, tcache, torch.from_numpy(toks[:, t]), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL,
                                   err_msg=f"decode step at position {t}")
    for i, c in enumerate(tcache):
        for key in ("k", "v"):
            np.testing.assert_allclose(c[key].numpy(), np.asarray(jcache["dec"][0][i]["attn"][key][0]),
                                       **LOGIT_TOL, err_msg=f"layer {i} {key}")


def test_ring_cache_matches_full_length_cache():
    """The same steps on the ring and on the port's full-length cache
    (windowed local layers), and against the full forward."""
    _, _, cfg, params = _models(8)
    toks = _tokens(cfg, (B, S), 1)
    full = _full_logits(cfg, params, toks)
    ring = tlm.init_cache(cfg, B, S, ring_local=True, device="cpu")
    dense = tlm.init_cache(cfg, B, S, device="cpu")
    prompt = {"tokens": torch.from_numpy(toks[:, :P])}
    lr, ring = tlm.prefill(cfg, params, ring, prompt)
    ld, dense = tlm.prefill(cfg, params, dense, prompt)
    errs = [float((lr - ld).abs().max()), float((lr - full[:, P - 1]).abs().max())]
    for t in range(P, S):
        tok = torch.from_numpy(toks[:, t])
        lr, ring = tlm.decode_step(cfg, params, ring, tok, t)
        ld, dense = tlm.decode_step(cfg, params, dense, tok, t)
        errs += [float((lr - ld).abs().max()), float((lr - full[:, t]).abs().max())]
    assert max(errs) < SELF_ATOL, errs


def test_per_slot_ring_decode():
    """Per-slot (B,) positions on the ring, slot 1 five positions behind
    slot 0 (it rewrites position 0 until it starts): each slot's logits
    equal the reference's per-slot step and the full forward at its
    position, past two wraps."""
    jcfg, jparams, tcfg, tparams = _models(8)
    toks = _tokens(tcfg, (B, S), 2)
    full = _full_logits(tcfg, tparams, toks)
    jcache = jlm.init_cache(jcfg, B, S, ring_local=True)
    tcache = tlm.init_cache(tcfg, B, S, ring_local=True, device="cpu")
    jstep = _jax_step(jcfg)
    for t in range(S):
        pos = np.array([t, max(t - 5, 0)])
        tok = toks[np.arange(B), pos]
        jl, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))
        tl, tcache = tlm.decode_step(tcfg, tparams, tcache, torch.from_numpy(tok),
                                     torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL,
                                   err_msg=f"per-slot step {t}")
        want = full[np.arange(B), pos]
        assert float((tl - want).abs().max()) < SELF_ATOL, f"per-slot step {t}"


def test_chunk_inside_the_ring_matches_reference():
    """A 2-token prefill, then a 4-token chunk at position 2 that ends inside
    the ring of 8: the last rows equal the reference's and the full
    forward's."""
    jcfg, jparams, tcfg, tparams = _models(8)
    toks = _tokens(tcfg, (B, 6), 3)
    jcache = jlm.init_cache(jcfg, B, S, ring_local=True)
    tcache = tlm.init_cache(tcfg, B, S, ring_local=True, device="cpu")
    _, jcache = jlm.prefill(jcfg, jparams, jcache, {"tokens": jnp.asarray(toks[:, :2])})
    _, tcache = tlm.prefill(tcfg, tparams, tcache, {"tokens": torch.from_numpy(toks[:, :2])})
    jh, _, _ = jlm.forward_hidden(jcfg, jparams, {"tokens": jnp.asarray(toks[:, 2:])},
                                  caches=jcache, cache_pos=2, remat=False)
    th, _, _ = tlm.forward_hidden(tcfg, tparams, {"tokens": torch.from_numpy(toks[:, 2:])},
                               caches=tcache, cache_pos=2, remat=False)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **LOGIT_TOL)
    hf, _, _ = tlm.forward_hidden(tcfg, tparams, {"tokens": torch.from_numpy(toks)}, remat=False)
    assert float((th - hf[:, 2:]).abs().max()) < SELF_ATOL


def test_ring_refuses_a_prompt_longer_than_the_ring():
    """A 10-token prompt into a ring of 8: ValueError naming the ring and
    the prompt; the reference raises TypeError."""
    jcfg, jparams, tcfg, tparams = _models(8)
    toks = _tokens(tcfg, (B, 10), 4)
    tcache = tlm.init_cache(tcfg, B, S, ring_local=True, device="cpu")
    with pytest.raises(ValueError, match=r"prompt of 10 tokens.*ring of 8"):
        tlm.prefill(tcfg, tparams, tcache, {"tokens": torch.from_numpy(toks)})
    jcache = jlm.init_cache(jcfg, B, S, ring_local=True)
    with pytest.raises(TypeError):
        jlm.prefill(jcfg, jparams, jcache, {"tokens": jnp.asarray(toks)})


def test_ring_refuses_a_chunk_across_its_end():
    """Prefill 4, then a chunk of 6 at position 4 into a ring of 8: the port
    raises ValueError; the reference runs it, and its last hidden row
    differs from the full-cache result by O(1), which is why the port
    refuses."""
    jcfg, jparams, tcfg, tparams = _models(8)
    toks = _tokens(tcfg, (B, 10), 5)
    tcache = tlm.init_cache(tcfg, B, S, ring_local=True, device="cpu")
    _, tcache = tlm.prefill(tcfg, tparams, tcache, {"tokens": torch.from_numpy(toks[:, :4])})
    with pytest.raises(ValueError, match=r"chunk of 6 tokens at position 4.*ring of 8"):
        tlm.forward_hidden(tcfg, tparams, {"tokens": torch.from_numpy(toks[:, 4:])},
                           caches=tcache, cache_pos=4, remat=False)

    jring = jlm.init_cache(jcfg, B, S, ring_local=True)
    jfull = jlm.init_cache(jcfg, B, S)
    got = {}
    for name, cache in (("ring", jring), ("full", jfull)):
        _, cache = jlm.prefill(jcfg, jparams, cache, {"tokens": jnp.asarray(toks[:, :4])})
        h, _, _ = jlm.forward_hidden(jcfg, jparams, {"tokens": jnp.asarray(toks[:, 4:])},
                                     caches=cache, cache_pos=4, remat=False)
        got[name] = np.asarray(h[:, -1])
    assert np.abs(got["ring"] - got["full"]).max() > 0.1


def test_long_prompt_generate_loop_tokens_equal_reference():
    """A 40-token prompt, longer than the reduced 32-key window, through
    ``generate_loop`` (full-length caches, windowed local layers)."""
    jcfg, jparams, tcfg, tparams = _models()
    prompts = _tokens(tcfg, (B, 40), 6)
    want = jdecode.generate_loop(jcfg, jparams, jnp.asarray(prompts), 8,
                                 scfg=jdecode.ServeConfig(max_seq=64), jit=False)
    got = tdecode.generate_loop(tcfg, tparams, prompts, 8, scfg=tdecode.ServeConfig(max_seq=64))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_long_prompt_engine_tokens_equal_reference():
    """Prompts of 33 to 50 tokens, past the 32-key window, through both
    packages' engines (4-token pages, windowed paged decode), greedy and
    sampled: tokens, statuses and stats equal."""
    jcfg, jparams, tcfg, tparams = _models()
    rng = np.random.default_rng(7)
    reqs = [dict(prompt=rng.integers(1, tcfg.vocab_size, int(rng.integers(33, 51))).tolist(),
                 max_new=int(rng.integers(4, 10)), temperature=0.8 if i % 2 else 0.0)
            for i in range(5)]
    ecfg = dict(num_slots=3, page_size=4, max_seq=64, segment_len=4, seed=7)
    out = {}
    for name, mod, cfg, params in (("jax", jserve, jcfg, jparams), ("torch", tserve, tcfg, tparams)):
        eng = mod.Engine(cfg, params, mod.EngineConfig(**ecfg))
        for r in reqs:
            eng.submit(r["prompt"], r["max_new"], temperature=r["temperature"])
        for _ in range(200):
            if eng.idle:
                break
            eng.step()
            eng.validate()
        assert eng.idle, f"{name} engine did not drain"
        tokens = {uid: eng.collect(uid) for uid in range(len(reqs))}
        out[name] = (tokens, {uid: eng.status(uid).value for uid in tokens}, eng.stats)
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][2] == out["jax"][2]
    for uid, toks in out["jax"][0].items():
        assert out["torch"][0][uid] == toks, f"uid {uid}: tokens differ"
        assert len(toks) == len(reqs[uid]["prompt"]) + reqs[uid]["max_new"]


def _qkv(b, h, hk, s, d, vd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, d), dtype=np.float32),
            rng.standard_normal((b, hk, s, d), dtype=np.float32),
            rng.standard_normal((b, hk, s, vd), dtype=np.float32))


@pytest.mark.parametrize("window", [None, 128], ids=["causal", "window128"])
@pytest.mark.parametrize("vd", [16, 8], ids=["vd16", "vd8"])
def test_attention_chunked_matches_reference(window, vd):
    """Sq = Skv = 1024, GQA 4/2, D 16 (v's head dim 16 or 8), causal with
    and without a 128-key window: ``attention_chunked`` against
    ``attention_xla_chunked``; and ``ops.attention`` on CPU tensors of this
    size runs it."""
    q, k, v = _qkv(1, 4, 2, 1024, 16, vd, 8)
    want = jref.attention_xla_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=True, window=window)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = tref.attention_chunked(tq, tk, tv, causal=True, window=window)
    assert got.shape == (1, 4, 1024, vd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    if vd == 16:
        assert torch.equal(ops.attention(tq, tk, tv, causal=True, window=window), got)


def test_attention_dispatch_below_the_threshold(monkeypatch):
    """At Sq·Skv <= 512·1024 or Sq <= 512 ``ops.attention`` keeps the plain
    version it ran before; above both it takes the chunked one."""
    def refuse(*a, **k):
        raise AssertionError("attention_chunked called below the threshold")

    for sq, skv in ((512, 1024), (1024, 512), (600, 600)):
        q, k, v = _qkv(1, 4, 2, skv, 16, 16, 9)
        tq, tk, tv = (torch.from_numpy(x) for x in (q[:, :, -sq:], k, v))
        monkeypatch.setattr(tref, "attention_chunked", refuse)
        got = ops.attention(tq, tk, tv, causal=True)
        monkeypatch.undo()
        assert torch.equal(got, tref.attention_ref(tq, tk, tv, causal=True))
    calls = []
    monkeypatch.setattr(tref, "attention_chunked",
                        lambda *a, **k: calls.append(1) or tref.attention_ref(*a, **k))
    q, k, v = _qkv(1, 4, 2, 1025, 16, 16, 10)
    ops.attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True)
    assert calls == [1]


def test_attention_chunked_gradient():
    """Under autograd each block is checkpointed: the gradients equal those
    of ``attention_ref``'s (Sq = Skv = 256 in blocks of 64, GQA 4/2,
    window 40)."""
    q, k, v = _qkv(1, 4, 2, 256, 16, 16, 11)
    grads = []
    for fn in (lambda *t: tref.attention_chunked(*t, causal=True, window=40, block_q=64),
               lambda *t: tref.attention_ref(*t, causal=True, window=40)):
        ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        (fn(*ts) * torch.linspace(-1, 1, 16)).sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
