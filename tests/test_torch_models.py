"""The port's decoders (dense, Mamba-1 and MoE) and greedy serving loop against
the JAX package, on the CPU, for reduced fp32 configs: the reference's own weights
(``repro.models.lm.init_params`` → numpy → ``params_from_numpy``) and the
same numpy-seeded tokens go through both.

Logits are held at rtol 1e-4 / atol 1e-3 (the fp32 GEMM tolerance of
``tests/test_kernels.py``: two layers of fp32 products summed in another
order); greedy tokens must be equal.  The reference's step functions run
jitted for the logits and eagerly (``generate_loop(..., jit=False)``) for the
greedy tokens.  The port's decode steps also reproduce its own full
forward at the reference's atol 2e-4 (``tests/test_models.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import lm as jlm
from repro.serve import decode as jdecode
from repro_torch.configs.base import get_config as torch_config
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import decode as tdecode

ARCHS = ["llama2_13b", "gptj_6b", "minicpm_2b", "falcon_mamba_7b", "chatglm3_6b", "glm4_9b",
         "gemma3_12b", "qwen3_moe_235b"]
# encoder-only: no decode step in the reference (tests/test_models.py)
ENCODERS = ["bert_large"]
LOGIT_TOL = dict(rtol=1e-4, atol=1e-3)
BATCH, PROMPT, STEPS = 2, 8, 8


@functools.lru_cache(maxsize=None)
def _models(arch, fused=False):
    """Both packages' reduced config and weights; ``fused`` sets
    ``use_fusion=True`` on the same weights."""
    if fused:
        jcfg, jparams, tcfg, tparams = _models(arch)
        return (dataclasses.replace(jcfg, use_fusion=True), jparams,
                dataclasses.replace(tcfg, use_fusion=True), tparams)
    jcfg, tcfg = jax_config(arch).reduced(), torch_config(arch).reduced()
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("arch", ARCHS + ENCODERS)
def test_configs_are_copies_of_the_reference(arch):
    full_j, full_t = jax_config(arch), torch_config(arch)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert dataclasses.asdict(full_t.reduced()) == dataclasses.asdict(full_j.reduced())
    assert full_t.padded_vocab == full_j.padded_vocab


def test_padded_vocab_and_unported_archs():
    assert torch_config("minicpm_2b").padded_vocab == 122880
    with pytest.raises(KeyError, match="ROADMAP"):
        torch_config("deepseek_v2_236b")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch):
    _check_logits(*_models(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_prefill_and_decode_logits_match_reference(arch):
    """``use_fusion=True``: the fused output projection (with the residual)
    and up projection in both packages, held as the unfused logits are."""
    _check_logits(*_models(arch, fused=True))


def _check_logits(jcfg, jparams, tcfg, tparams):
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, jcfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    max_seq = PROMPT + STEPS
    jcache = jlm.init_cache(jcfg, BATCH, max_seq)
    tcache = tlm.init_cache(tcfg, BATCH, max_seq, device="cpu")
    jprefill = jax.jit(lambda p, c, t: jlm.prefill(jcfg, p, c, {"tokens": t}))
    jstep = jax.jit(lambda p, c, t, pos: jlm.decode_step(jcfg, p, c, t, pos))

    jl, jcache = jprefill(jparams, jcache, jnp.asarray(prompts))
    tl, tcache = tlm.prefill(tcfg, tparams, tcache, {"tokens": torch.from_numpy(prompts)})
    assert tl.shape == (BATCH, tcfg.padded_vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for t in range(STEPS):
        toks = rng.integers(0, jcfg.vocab_size, (BATCH,)).astype(np.int32)
        jl, jcache = jstep(jparams, jcache, jnp.asarray(toks), PROMPT + t)
        tl, tcache = tlm.decode_step(tcfg, tparams, tcache, torch.from_numpy(toks), PROMPT + t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL,
                                   err_msg=f"decode step {t}")
        assert tlm.finite_logits(tl).all()
    # the reference keeps one cache entry per position of the layer pattern,
    # each stacked over the pattern's repeats: layer i is entry i % period,
    # row i // period
    period = tcfg.pattern_period
    jdec = jcache["dec"][0]
    for layer, tc in enumerate(tcache):
        entry = jdec[layer % period]
        for part, key in (("attn", "k"), ("mamba", "conv"), ("mamba", "h")):
            if part in entry:
                np.testing.assert_allclose(tc[key].numpy(),
                                           np.asarray(entry[part][key][layer // period]),
                                           **LOGIT_TOL, err_msg=f"layer {layer} {key}")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_loop_tokens_equal_reference(arch):
    _check_tokens(*_models(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_generate_loop_tokens_equal_reference(arch):
    _check_tokens(*_models(arch, fused=True))


def _check_tokens(jcfg, jparams, tcfg, tparams):
    prompts = np.random.default_rng(6).integers(
        0, jcfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    want = jdecode.generate_loop(jcfg, jparams, jnp.asarray(prompts), STEPS,
                                 scfg=jdecode.ServeConfig(max_seq=64), jit=False)
    got = tdecode.generate_loop(tcfg, tparams, prompts, STEPS,
                                scfg=tdecode.ServeConfig(max_seq=64))
    assert got.shape == (BATCH, PROMPT + STEPS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Prefill of 8 tokens, then 8 decode steps on the dense cache: each
    step's logits equal the full forward's at that position."""
    _, _, cfg, params = _models(arch)
    b, s, p = 2, 16, 8
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (b, s)))
    h, _, _ = tlm.forward_hidden(cfg, params, {"tokens": toks})
    full = tlm._logits(cfg, params, h.reshape(b * s, -1)).view(b, s, -1)
    caches = tlm.init_cache(cfg, b, s, device="cpu")
    logits, caches = tlm.prefill(cfg, params, caches, {"tokens": toks[:, :p]})
    errs = [float((logits - full[:, p - 1]).abs().max())]
    for t in range(p, s):
        logits, caches = tlm.decode_step(cfg, params, caches, toks[:, t], t)
        errs.append(float((logits - full[:, t]).abs().max()))
    assert max(errs) < 2e-4, errs


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_encoder_hidden_and_loss_match_reference(fused):
    """bert-large (bidirectional attention, layernorm, gelu MLP with
    biases, tied embeddings): the final hidden states of a full forward and
    the chunked LM loss, unfused and with ``use_fusion=True``."""
    jcfg, jparams, tcfg, tparams = _models("bert_large", fused=fused)
    assert set(tlm.layer_kinds(tcfg)) == {"bidir"}
    rng = np.random.default_rng(7)
    b, s = 2, 16
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32),
             "mask": (rng.random((b, s)) > 0.1).astype(np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jh = jlm.forward_hidden(jcfg, jparams, jb, remat=False)[0]
    th, _, _ = tlm.forward_hidden(tcfg, tparams, tb, remat=False)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **LOGIT_TOL)
    # a later token changes an earlier position's state: attention is not causal
    tb2 = dict(tb, tokens=tb["tokens"].clone())
    tb2["tokens"][:, -1] = (tb2["tokens"][:, -1] + 1) % tcfg.vocab_size
    th2, _, _ = tlm.forward_hidden(tcfg, tparams, tb2, remat=False)
    assert float((th2[:, 0] - th[:, 0]).abs().max()) > 1e-6
    jloss, _ = jlm.lm_loss(jcfg, jparams, jb, remat=False, loss_chunk=8)
    tloss, _ = tlm.lm_loss(tcfg, tparams, tb, remat=False, loss_chunk=8)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_generate_loop_validates_lengths():
    _, _, tcfg, tparams = _models("llama2_13b")
    with pytest.raises(ValueError, match="max_seq"):
        tdecode.generate_loop(tcfg, tparams, np.zeros((1, 8), np.int32), 8,
                              scfg=tdecode.ServeConfig(max_seq=10))
    with pytest.raises(ValueError, match="num_new"):
        tdecode.generate_loop(tcfg, tparams, np.zeros((1, 8), np.int32), 0)
