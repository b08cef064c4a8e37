"""The port's training slice on the CPU against the JAX reference: schedules,
AdamW, the synthetic corpus, dropout bits, the fp32 master parameters,
``lm_loss`` and its gradients, a 5-step ``make_train_step`` trajectory, and
mirrors of ``tests/test_train_and_ft.py`` (trainer, checkpoints, watchdog).

Inputs come from numpy seeds; the reference's parameters (and its gradients,
so both trees share one layout) go through ``params_from_numpy``.
Tolerances: fp32 elementwise math (schedules, one AdamW update) rtol 1e-6;
the loss rtol 1e-5 and gradients rtol 1e-4 / atol 1e-5 (fp32 sums taken in
another order through two layers); a trajectory after several AdamW steps
at ``test_microbatch_matches_full_batch``'s rtol 2e-3 / atol 2e-4, since
Adam's normalised update amplifies last-bit differences of tiny gradients.
"""
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticCorpus as JCorpus
from repro.fusion import rng as jrng
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro.train import steps as jsteps
from repro_torch.checkpoint import all_steps, latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs.base import get_config
from repro_torch.data import DataConfig, SyntheticCorpus, to_device
from repro_torch.fusion import rng as trng
from repro_torch.models import blocks, convert, lm
from repro_torch.optim import AdamWConfig, apply_updates, init_state, schedules
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import (SimulatedPreemption, TrainConfig, TrainerConfig,
                               init_train_state, make_train_step, train)

ARCHS = ("minicpm_2b", "gptj_6b")
CFG = get_config("minicpm_2b").reduced()
DCFG = DataConfig(vocab_size=CFG.vocab_size, seq_len=32, global_batch=8, seed=1)


def _tcfg(**kw):
    base = dict(peak_lr=3e-3, warmup_steps=5, total_steps=40, loss_chunk=32)
    base.update(kw)
    return TrainConfig(**base)


def _jax_state(arch, seed=0):
    cfg_j = jget(arch).reduced()
    params = jlm.init_params(cfg_j, jax.random.PRNGKey(seed))
    return cfg_j, params


def _port_params(cfg, tree, requires_grad=True):
    params = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, tree), device="cpu",
                                       dtype=torch.float32)
    for p in tree_leaves(params):
        p.requires_grad_(requires_grad)
    return params


def _batch(cfg, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "mask": (rng.random((b, s)) > 0.1).astype(np.float32)}


def _close(got, want, **tol):
    for g, w in zip(tree_leaves(got), want):
        np.testing.assert_allclose(g.detach().float().numpy(), np.asarray(w, np.float32), **tol)


# ---------------------------------------------------------------------------
# Schedules, AdamW
# ---------------------------------------------------------------------------

def test_schedules_match_reference():
    for step in (0, 3, 10, 25, 31, 39, 45, 200):
        kw = dict(peak_lr=3e-3, warmup_steps=10, total_steps=40)
        np.testing.assert_allclose(float(schedules.cosine_schedule(step, **kw)),
                                   float(jsched.cosine_schedule(step, **kw)), rtol=1e-6)
        kw = dict(peak_lr=1e-2, warmup_steps=10, stable_steps=20, decay_steps=10)
        np.testing.assert_allclose(float(schedules.wsd_schedule(step, **kw)),
                                   float(jsched.wsd_schedule(step, **kw)), rtol=1e-6)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, None, 0.05])
def test_adamw_matches_reference(clip, moments):
    """Three updates of a small tree (a norm scale and an embedding among
    its leaves: weight decay reaches every leaf), with and without clipping
    at the global norm, fp32 and bf16 moments."""
    rng = np.random.default_rng(0)
    shapes = {"embed": (12, 8), "final_norm": {"scale": (8,)},
              "layers": [{"w": (8, 4)}, {"w": (8, 4), "b": (4,)}]}

    def tree(node):
        if isinstance(node, tuple):
            return rng.normal(size=node).astype(np.float32)
        if isinstance(node, dict):
            return {k: tree(v) for k, v in node.items()}
        return [tree(v) for v in node]

    p_np = tree(shapes)
    cfg = AdamWConfig(clip_norm=clip, moment_dtype=moments)
    jcfg = jadamw.AdamWConfig(clip_norm=clip, moment_dtype=moments)
    jp = jax.tree.map(jnp.asarray, p_np)
    jstate = jadamw.init_state(jp, jcfg)
    tp = jax.tree.map(torch.from_numpy, p_np)
    tstate = init_state(tp, cfg)
    for step in range(3):
        g_np = tree(shapes)
        jp, jstate, jm = jadamw.apply_updates(jp, jax.tree.map(jnp.asarray, g_np), jstate,
                                              lr=1e-2, cfg=jcfg)
        tp, tstate, tm = apply_updates(tp, jax.tree.map(torch.from_numpy, g_np), tstate,
                                       lr=1e-2, cfg=cfg)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        _close(tp, jax.tree.leaves(jp), rtol=1e-6, atol=1e-7)
        _close(tstate["mu"], jax.tree.leaves(jstate["mu"]), rtol=1e-6, atol=1e-7)
        assert int(tstate["count"]) == int(jstate["count"]) == step + 1
        assert tstate["count"].dtype == torch.int32
        assert all(m.dtype == getattr(torch, moments) for m in tree_leaves(tstate["nu"]))


# ---------------------------------------------------------------------------
# Data and dropout bits
# ---------------------------------------------------------------------------

def test_corpus_matches_reference_and_resumes():
    jc = JCorpus(JDataConfig(vocab_size=CFG.vocab_size, seq_len=32, global_batch=8, seed=1))
    c = SyntheticCorpus(DCFG)
    for step in range(4):
        got, want = next(c), next(jc)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert c.state() == jc.state() == {"step": 4, "seed": 1}
    resumed = SyntheticCorpus.from_state(DCFG, {"step": 2, "seed": 1})
    np.testing.assert_array_equal(next(resumed)["tokens"], SyntheticCorpus(DCFG).batch_at(2)["tokens"])
    with pytest.raises(ValueError):
        SyntheticCorpus.from_state(DCFG, {"step": 0, "seed": 5})
    it = SyntheticCorpus(DCFG).prefetching(depth=2)
    np.testing.assert_array_equal(next(it)["labels"], jc.batch_at(0)["labels"])
    dev = to_device(c.batch_at(0), "cpu")
    assert dev["tokens"].dtype == torch.int64 and dev["mask"].dtype == torch.float32


@pytest.mark.parametrize("offsets", [(0, 0), (7, 130)])
def test_dropout_bits_match_reference(offsets):
    seed = int(jrng.fold_in(jnp.uint32(5), jnp.uint32(3)))
    assert int(trng.fold_in(5, 3)) == seed
    salt = blocks.ATTN_OUT_DROPOUT_SALT
    want = np.asarray(jrng.tile_bits(seed, salt, (16, 24), offsets=offsets))
    got = trng.tile_bits(seed, salt, (16, 24), offsets=offsets)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        trng.keep_mask(seed, salt, (16, 24), rate=0.3, offsets=offsets).numpy(),
        np.asarray(jrng.keep_mask(seed, salt, (16, 24), rate=0.3, offsets=offsets)))
    x = np.random.default_rng(1).normal(size=(16, 24)).astype(np.float32)
    np.testing.assert_array_equal(
        trng.dropout(torch.from_numpy(x), seed, salt, 0.3, offsets=offsets).numpy(),
        np.asarray(jrng.dropout(jnp.asarray(x), seed, salt, 0.3, offsets=offsets)))
    assert trng.keep_threshold(0.3) == jrng.keep_threshold(0.3)


# ---------------------------------------------------------------------------
# fp32 masters, lm_loss and its gradients
# ---------------------------------------------------------------------------

def test_fp32_masters_load_bit_for_bit_and_serving_default_is_unchanged():
    cfg_j, jp = _jax_state("minicpm_2b")
    cfg = get_config("minicpm_2b").reduced()
    params = _port_params(cfg, jp, requires_grad=False)
    np.testing.assert_array_equal(params["embed"].numpy(), np.asarray(jp["embed"]))
    wq = np.asarray(jp["groups"][0][0]["attn"]["wq"])
    for i, layer in enumerate(params["layers"]):
        assert layer["attn"]["wq"].dtype == torch.float32
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(), wq[i])
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    serving = convert.params_from_numpy(bf16, jax.tree.map(np.asarray, jp), device="cpu")
    assert serving["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert serving["layers"][0]["norm1"]["scale"].dtype == torch.float32
    assert lm.init_params(bf16, device="cpu")["embed"].dtype == torch.bfloat16
    assert lm.init_params(bf16, device="cpu", dtype=torch.float32)["embed"].dtype == torch.float32


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch, remat):
    cfg_j, jp = _jax_state(arch)
    cfg = get_config(arch).reduced()
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jlm.lm_loss(cfg_j, p, jb, remat=remat, loss_chunk=16), has_aux=True)(jp)
    params = _port_params(cfg, jp)
    loss, met = lm.lm_loss(cfg, params, to_device(batch, "cpu"), remat=remat, loss_chunk=16)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(met["tokens"]), float(jmet["tokens"]))
    want = tree_leaves(_port_params(cfg, jgrads, requires_grad=False))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5)


def test_dropout_training_loss_matches_reference():
    """cfg.dropout_rate > 0 with a seed: the attention output-projection
    dropout draws the reference's bits (same salt, (B·S, d) index space and
    per-layer folding), so loss and gradients agree."""
    cfg_j = dataclasses.replace(jget("minicpm_2b").reduced(), dropout_rate=0.2)
    cfg = dataclasses.replace(CFG, dropout_rate=0.2)
    jp = jlm.init_params(cfg_j, jax.random.PRNGKey(1))
    batch = _batch(cfg, seed=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    seed = jrng.fold_in(jnp.uint32(9), jnp.uint32(4))
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jlm.lm_loss(cfg_j, p, jb, loss_chunk=16, dropout_seed=seed), has_aux=True)(jp)
    params = _port_params(cfg, jp)
    loss, _ = lm.lm_loss(cfg, params, to_device(batch, "cpu"), loss_chunk=16,
                         dropout_seed=trng.fold_in(9, 4))
    no_drop, _ = lm.lm_loss(cfg, params, to_device(batch, "cpu"), loss_chunk=16)
    assert abs(float(loss) - float(no_drop)) > 1e-4
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    for g, w in zip(grads, tree_leaves(_port_params(cfg, jgrads, requires_grad=False))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5)


def test_train_step_trajectory_matches_reference():
    """Five ``make_train_step`` steps from the reference's initial state on
    the reference's batches (cosine schedule with warmup, clipping)."""
    cfg_j, jp = _jax_state("minicpm_2b")
    cfg = get_config("minicpm_2b").reduced()
    tkw = dict(peak_lr=3e-3, warmup_steps=2, total_steps=40, loss_chunk=16)
    jstep = jax.jit(jsteps.make_train_step(cfg_j, jsteps.TrainConfig(**tkw)))
    jopt = jadamw.init_state(jp)
    params = _port_params(cfg, jp)
    opt = init_state(params)
    step_fn = make_train_step(cfg, TrainConfig(**tkw))
    corpus = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
                                        seed=3))
    for step in range(5):
        b = corpus.batch_at(step)
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in b.items()},
                             jnp.int32(step))
        params, opt, m = step_fn(params, opt, to_device(b, "cpu"), step)
        tol = dict(rtol=1e-5) if step == 0 else dict(rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **tol)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    want = tree_leaves(_port_params(cfg, jp, requires_grad=False))
    for g, w in zip(tree_leaves(params), want):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), rtol=2e-3, atol=2e-4)


def test_grad_compression_raises():
    with pytest.raises(NotImplementedError, match="distributed"):
        make_train_step(CFG, _tcfg(grad_compression=True))


# ---------------------------------------------------------------------------
# Mirrors of tests/test_train_and_ft.py
# ---------------------------------------------------------------------------

def _train(tcfg, rcfg, seed=0):
    return train(CFG, tcfg, DCFG, rcfg, seed=seed, device="cpu")


def test_loss_decreases():
    rcfg = TrainerConfig(num_steps=25, ckpt_every=100, ckpt_dir=None, log_every=0)
    _, _, h = _train(_tcfg(), rcfg)
    assert h["loss"][-1] < h["loss"][0] - 0.3
    assert all(np.isfinite(h["grad_norm"]))


def test_preempt_resume_bitwise(tmp_path):
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    p1, _, _ = _train(_tcfg(), TrainerConfig(num_steps=12, ckpt_every=4, ckpt_dir=d1,
                                             log_every=0))
    with pytest.raises(SimulatedPreemption):
        _train(_tcfg(), TrainerConfig(num_steps=12, ckpt_every=4, ckpt_dir=d2, log_every=0,
                                      preempt_after=5))
    assert latest_step(d2) == 4
    p2, _, _ = _train(_tcfg(), TrainerConfig(num_steps=12, ckpt_every=4, ckpt_dir=d2,
                                             log_every=0))
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert torch.equal(a, b)


def test_microbatch_matches_full_batch():
    rcfg = TrainerConfig(num_steps=5, ckpt_every=100, ckpt_dir=None, log_every=0)
    p1, _, _ = _train(_tcfg(microbatches=1), rcfg)
    p2, _, _ = _train(_tcfg(microbatches=4), rcfg)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=2e-3, atol=2e-4)


def test_straggler_watchdog():
    """A delay injected after step 12 makes step 13 a straggler.  The delay
    is at least 0.6 s (the reference test's) and 5x the slowest step so far,
    so the step stays flagged on a loaded machine where a CPU step is slow."""
    seen, marks = [], []

    def cb(step, params, metrics):
        marks.append(time.perf_counter())
        if step == 12:
            slowest = max(b - a for a, b in zip(marks, marks[1:]))
            time.sleep(max(0.6, 5 * slowest))  # inject a straggler
        seen.append(step)

    rcfg = TrainerConfig(num_steps=16, ckpt_every=100, ckpt_dir=None, log_every=0,
                         step_callback=cb, straggler_factor=2.5)
    _, _, h = _train(_tcfg(), rcfg)
    assert any(s == 13 for s, *_ in h["slow_steps"])
    assert seen == list(range(16))


def test_checkpoint_roundtrip_and_keep(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.arange(10), "b": [torch.ones(2, 2), torch.zeros(3)],
            "m": torch.randn(3, 5).to(torch.bfloat16), "count": torch.tensor(7, dtype=torch.int32)}
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(d, s, tree, extra={"x": s}, keep=2)
    assert latest_step(d) == 5 and all_steps(d) == [4, 5]
    out, step, extra = restore_checkpoint(d, tree)
    assert step == 5 and extra["x"] == 5
    for a, b in zip(tree_leaves(tree), tree_leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, {"a": torch.ones(4)})
    with pytest.raises(ValueError):
        restore_checkpoint(d, {"a": torch.ones(5)})


def test_checkpoint_atomic_no_partial_dirs(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, {"a": torch.ones(4)})
    assert not [f for f in os.listdir(d) if f.startswith(".tmp")]
    with pytest.raises(TypeError):
        save_checkpoint(d, 2, {"a": object()})
    assert all_steps(d) == [1]
    assert not [f for f in os.listdir(d) if f.startswith(".tmp")]


def test_init_train_state_fp32_masters_require_grad():
    params, opt = init_train_state(CFG, _tcfg(), 0, device="cpu")
    leaves = tree_leaves(params)
    assert all(p.dtype == torch.float32 and p.requires_grad for p in leaves)
    assert len(tree_leaves(opt["mu"])) == len(leaves) and int(opt["count"]) == 0
