"""The port's counter-based sampler and host-side serving bookkeeping
against the JAX package, on the CPU.

threefry2x32 must give the reference's bits exactly (the cipher is integer
adds, xors and rotates), and ``sample_tokens`` the reference's tokens on the
same fp32 logits.  ``PagedKvCache``, ``Scheduler`` and ``FaultPlan.random``
are copies: one random sequence of operations driven through both packages
must end in equal page tables, free lists, queues and fault schedules.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fusion import rng as jrng
from repro.serve import faults as jfaults
from repro.serve import kvcache as jkv
from repro.serve import sampling as jsampling
from repro.serve import scheduler as jsched
from repro_torch.fusion import rng as trng
from repro_torch.serve import faults as tfaults
from repro_torch.serve import kvcache as tkv
from repro_torch.serve import sampling as tsampling
from repro_torch.serve import scheduler as tsched


def _words(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("shape", [(7,), (3, 64), (2, 5, 9)])
def test_threefry_bits_equal_reference(shape):
    rng = np.random.default_rng(sum(shape))
    words = [_words(rng, shape) for _ in range(4)]
    want = jrng.threefry2x32(*[jnp.asarray(w) for w in words])
    got = trng.threefry2x32(*[torch.from_numpy(w.astype(np.int64)) for w in words])
    for w, g in zip(want, got):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_threefry_broadcasts_scalars_and_salts_equal_reference():
    ctr = np.arange(300, dtype=np.uint32)
    want = jrng.threefry2x32(jnp.uint32(0xDEADBEEF), 12345, jnp.asarray(ctr), 0)
    got = trng.threefry2x32(0xDEADBEEF, 12345, torch.from_numpy(ctr.astype(np.int64)), 0)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    for name in ("serve/sampler", "fused_output/dropout", ""):
        assert trng.derive_salt(name) == jrng.derive_salt(name)
    assert tsampling.SAMPLER_SALT == jsampling.SAMPLER_SALT
    for seed, data in ((0, 0), (7, 3), (2 ** 32 - 1, 2 ** 31 + 5)):
        assert int(trng.fold_in(seed, data)) == int(jrng.fold_in(jnp.uint32(seed), jnp.uint32(data)))


def _knob_rows(rng, b):
    """Rows mixing greedy, temperature, top-k and top-p."""
    temp = rng.choice([0.0, 0.5, 0.8, 1.0, 2.0], b).astype(np.float32)
    top_k = rng.choice([0, 1, 5, 40], b).astype(np.int32)
    top_p = rng.choice([1.0, 0.9, 0.5, 0.05], b).astype(np.float32)
    return temp, top_k, top_p


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_tokens_equal_reference(seed):
    rng = np.random.default_rng(seed)
    b, v = 48, 256
    logits = (rng.normal(size=(b, v)) * 3).astype(np.float32)
    logits[0, :5] = logits[0].max()            # a tie: the first index wins
    temp, top_k, top_p = _knob_rows(rng, b)
    uids = rng.integers(0, 10_000, b).astype(np.uint32)
    pos = rng.integers(0, 4096, b).astype(np.int32)
    want = jsampling.sample_tokens(
        jnp.asarray(logits), uids=jnp.asarray(uids), positions=jnp.asarray(pos),
        seed=jnp.uint32(seed + 11), temperature=jnp.asarray(temp),
        top_k=jnp.asarray(top_k), top_p=jnp.asarray(top_p))
    got = tsampling.sample_tokens(
        torch.from_numpy(logits), uids=torch.from_numpy(uids.astype(np.int64)),
        positions=torch.from_numpy(pos), seed=seed + 11,
        temperature=torch.from_numpy(temp), top_k=torch.from_numpy(top_k),
        top_p=torch.from_numpy(top_p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0] == 0 or temp[0] > 0


def test_gumbel_noise_within_1e6_of_reference():
    """The uniforms are bit-exact; torch's fp32 ``log`` differs from XLA's
    in the last bits, so the noise differs by at most 1e-6 (and a sampled
    token can differ only where two candidates are closer than that)."""
    bits = np.random.default_rng(8).integers(0, 2 ** 32, 1 << 20, dtype=np.uint64)
    bits[:2] = (0, 2 ** 32 - 1)                 # the smallest and largest draw
    ju = (jnp.asarray(bits.astype(np.uint32)) >> jnp.uint32(8)).astype(jnp.float32) \
        * (1.0 / (1 << 24)) + (0.5 / (1 << 24))
    want = np.asarray(-jnp.log(-jnp.log(ju)))
    got = tsampling._gumbel(torch.from_numpy(bits.astype(np.int64))).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-6)


def test_sampler_keyed_by_uid_and_position_not_slot():
    """Permuting the rows permutes the tokens; a new position or uid draws
    anew, and a repeat of the same (seed, uid, position) draws the same."""
    rng = np.random.default_rng(3)
    b, v = 6, 64
    logits = torch.from_numpy(rng.normal(size=(b, v)).astype(np.float32))
    knobs = dict(temperature=torch.full((b,), 1.5), top_k=torch.zeros(b, dtype=torch.int64),
                 top_p=torch.ones(b))
    uids = torch.tensor([7, 3, 11, 0, 5, 9])
    pos = torch.full((b,), 9)
    base = tsampling.sample_tokens(logits, uids=uids, positions=pos, seed=4, **knobs)
    perm = torch.from_numpy(rng.permutation(b))
    shuf = tsampling.sample_tokens(logits[perm], uids=uids[perm], positions=pos[perm],
                                   seed=4, **knobs)
    torch.testing.assert_close(shuf, base[perm])
    again = tsampling.sample_tokens(logits, uids=uids, positions=pos, seed=4, **knobs)
    torch.testing.assert_close(again, base)
    draws = {tuple(tsampling.sample_tokens(logits, uids=uids, positions=pos + k,
                                           seed=4, **knobs).tolist()) for k in range(6)}
    assert len(draws) > 1


def _state(kv, sched):
    return dict(table=kv.table().tolist(), free=list(kv._free), owned=dict(kv._owned),
                waiting=[(r.uid, r.prompt, r.max_new) for r in sched.waiting],
                running={s: r.uid for s, r in sched.running.items()},
                seq=dict(sched.admitted_seq), mode=sched.mode)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_allocator_scheduler_and_fault_plans_are_copies(seed):
    """One random sequence of submit / admit / grow / preempt / retire /
    requeue / remove calls through both packages' PagedKvCache and
    Scheduler; the states must agree after every call, and both packages'
    FaultPlan.random must draw the same schedule."""
    rng = np.random.default_rng(seed)
    mode = ("reserve", "optimistic")[seed % 2]
    pkgs = []
    for kv_mod, sched_mod in ((jkv, jsched), (tkv, tsched)):
        kv = kv_mod.PagedKvCache(num_slots=3, num_pages=12, page_size=4, max_pages_per_slot=6)
        pkgs.append((kv, sched_mod.Scheduler(3, kv, mode=mode), sched_mod))
    uid = 0
    for _ in range(200):
        op = rng.integers(0, 6)
        arg = int(rng.integers(0, 1000))
        outs = []
        for kv, sched, mod in pkgs:
            if op == 0:
                plen, mnew = 1 + arg % 13, 1 + arg % 7
                req = mod.Request(uid=uid, prompt=list(range(plen)), max_new=mnew)
                try:
                    sched.submit(req)
                    outs.append("ok")
                except ValueError as exc:
                    outs.append(str(exc))
            elif op == 1:
                outs.append([(s, r.uid) for s, r in sched.admit()])
            elif op == 2 and sched.running:
                slot = sorted(sched.running)[arg % len(sched.running)]
                outs.append(kv.grow(slot, 1 + arg % 3))
            elif op == 3 and sched.running:
                victim = sched.youngest_running()
                req = sched.preempt(victim)
                sched.requeue_front(mod.Request(uid=req.uid, prompt=req.prompt + [0],
                                                max_new=max(1, req.max_new - 1)))
                outs.append(victim)
            elif op == 4 and sched.running:
                slot = sorted(sched.running)[arg % len(sched.running)]
                outs.append(sched.retire(slot).uid)
            elif op == 5 and sched.waiting:
                target = sched.waiting[arg % len(sched.waiting)].uid
                outs.append(sched.remove_waiting(target).uid)
            else:
                outs.append(None)
            sched.check_invariants()
        if op == 0:
            uid += 1
        assert outs[0] == outs[1]
        assert _state(pkgs[0][0], pkgs[0][1]) == _state(pkgs[1][0], pkgs[1][1])
    assert tkv.pages_needed(17, 4) == jkv.pages_needed(17, 4)

    kw = dict(p_exhaust=0.2, p_preempt=0.15, p_delay=0.1, delay_s=0.5,
              poison=(2, 9) if seed % 2 else None)
    jp, tp = jfaults.FaultPlan.random(seed, 60, **kw), tfaults.FaultPlan.random(seed, 60, **kw)
    assert (tp.exhaust_steps, tp.preempt_steps, tp.delays, tp.poison_uid, tp.poison_pos) == \
        (jp.exhaust_steps, jp.preempt_steps, jp.delays, jp.poison_uid, jp.poison_pos)
    assert tfaults.POISON_OFF == jfaults.POISON_OFF and not tfaults.NO_FAULTS.active
