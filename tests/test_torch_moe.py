"""The port's mixture-of-experts layer (``repro_torch.models.blocks.moe_apply``,
its experts on K9's plain version on the CPU) against the JAX package's
``repro.models.blocks.moe_apply``, at reduced qwen3-moe-235b (d 64, 4 experts,
top 2, ``moe_d_ff`` 64): the reference's own weights through numpy, the same
numpy-seeded tokens.

Held: y at fp32 rtol 1e-4 / atol 1e-3 and aux at rtol 1e-5, dropless and at
``capacity_factor`` 0.5, where slots are dropped; a zero router (every
probability equal: ties to the lower expert, as ``lax.top_k``); a shared
expert; the fused gated up projection; a bf16 layer at rtol 2e-2 / atol
2e-1 (``tests/test_kernels.py``'s bf16 tolerance); ``_expert_ffn``'s three
products on ``ops.grouped_matmul``; the layer's gradients (input, router,
``wg``, ``wu``, ``wd``) against ``jax.grad`` of the reference's
``moe_apply`` at fp32 rtol 1e-4 / atol 1e-5, dropless, at capacity 0.5 and
with the fused gated up projection; the layer groups of the reference's
``derive_groups``; and the whole reduced model's ``lm_loss`` (ce and aux),
and its gradients with drops.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.models import blocks as JB
from repro.models import lm as jlm
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.base import get_config as torch_config
from repro_torch.kernels import ops as tops
from repro_torch.models import blocks as TB
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_numpy

F32_TOL = dict(rtol=1e-4, atol=1e-3)
BF16_TOL = dict(rtol=2e-2, atol=2e-1)
T = 64


def _cfgs(**kw):
    jcfg = dataclasses.replace(jax_config("qwen3_moe_235b").reduced(), **kw)
    tcfg = dataclasses.replace(torch_config("qwen3_moe_235b").reduced(), **kw)
    return jcfg, tcfg


def _layer(jcfg, tcfg, seed=0, *, zero_router=False):
    """The reference's MoE weights (fp32) and the port's copy in the compute
    dtype, and T numpy-seeded tokens of width d in both."""
    jp = JB.init_moe(jcfg, jax.random.PRNGKey(seed))
    if zero_router:
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    dt = TB.compute_dtype(tcfg)

    def conv(node):
        return {k: conv(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)).to(dt)
                for k, v in node.items()}

    x = np.random.default_rng(seed + 1).normal(size=(T, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(JB.compute_dtype(jcfg))
    return jp, conv(jp), jx, torch.from_numpy(x).to(dt)


def _both(jcfg, tcfg, **kw):
    jp, tp, jx, tx = _layer(jcfg, tcfg, **kw)
    jy, jaux = JB.moe_apply(jcfg, jp, jx)
    ty, taux = TB.moe_apply(tcfg, tp, tx)
    assert ty.shape == (T, tcfg.d_model) and ty.dtype == TB.compute_dtype(tcfg)
    assert taux.dtype == torch.float32 and taux.shape == ()
    return (np.asarray(jy.astype(jnp.float32)), float(jaux), ty.float().numpy(), float(taux),
            tp, tx)


def _dropped(tcfg, tp, tx):
    """Slots past their expert's capacity, counted from the port's routing."""
    logits = tops.matmul(tx, tp["router"], out_dtype=torch.float32)
    _, topi = TB._top_k(torch.softmax(logits, -1), tcfg.experts_per_tok)
    t, k, e = tx.shape[0], tcfg.experts_per_tok, tcfg.num_experts
    cap = int(min(t, max(1, math.ceil(tcfg.capacity_factor * t * k / e))))
    counts = torch.bincount(topi.reshape(-1), minlength=e)
    return int(torch.clamp(counts - cap, min=0).sum())


def test_dropless_layer_matches_reference():
    jy, jaux, ty, taux, tp, tx = _both(*_cfgs())
    np.testing.assert_allclose(ty, jy, **F32_TOL)
    np.testing.assert_allclose(taux, jaux, rtol=1e-5)
    assert _dropped(_cfgs()[1], tp, tx) == 0


def test_capacity_drops_match_reference():
    """``capacity_factor`` 0.5: each expert holds 16 of its slots; the
    others are dropped in both packages alike, and the layer then differs
    from the dropless one (the port's side of ``tests/test_models.py``'s
    ``test_moe_capacity_drops_tokens``)."""
    jcfg, tcfg = _cfgs(capacity_factor=0.5)
    jy, jaux, ty, taux, tp, tx = _both(jcfg, tcfg)
    np.testing.assert_allclose(ty, jy, **F32_TOL)
    np.testing.assert_allclose(taux, jaux, rtol=1e-5)
    assert _dropped(tcfg, tp, tx) > 0
    _, _, loose, loose_aux, _, _ = _both(*_cfgs())
    assert float(np.abs(ty - loose).max()) > 1e-3
    np.testing.assert_allclose(taux, loose_aux, rtol=1e-6)    # aux ignores capacity


def test_zero_router_takes_the_lowest_experts():
    """All probabilities equal: ``lax.top_k`` takes experts 0..k-1 with
    weight 1/k each, and so does the port's stable sort."""
    jcfg, tcfg = _cfgs()
    jp, tp, jx, tx = _layer(jcfg, tcfg, zero_router=True)
    k = tcfg.experts_per_tok
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.zeros((T, tcfg.num_experts))), k)
    w, idx = TB._top_k(torch.full((T, tcfg.num_experts), 1.0 / tcfg.num_experts), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx.numpy(), np.tile(np.arange(k), (T, 1)))
    jy, jaux = JB.moe_apply(jcfg, jp, jx)
    ty, taux = TB.moe_apply(tcfg, tp, tx)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_shared_expert_matches_reference():
    jcfg, tcfg = _cfgs(num_shared_experts=1)
    jy, jaux, ty, taux, tp, _ = _both(jcfg, tcfg)
    assert set(tp["shared"]) == {"wg", "wu", "wd"}
    assert tuple(tp["shared"]["wg"].shape) == (tcfg.d_model, tcfg.moe_d_ff)
    np.testing.assert_allclose(ty, jy, **F32_TOL)
    np.testing.assert_allclose(taux, jaux, rtol=1e-5)


def test_fused_expert_ffn_matches_reference():
    """``use_fusion``: each expert's gated up projection is one
    ``fused_gated_mlp_apply`` call in both packages."""
    jcfg, tcfg = _cfgs(use_fusion=True)
    jy, jaux, ty, taux, _, _ = _both(jcfg, tcfg)
    np.testing.assert_allclose(ty, jy, **F32_TOL)
    _, _, unfused, _, _, _ = _both(*_cfgs())
    np.testing.assert_allclose(ty, unfused, **F32_TOL)


def test_bf16_layer_matches_reference():
    jy, jaux, ty, taux, _, _ = _both(*_cfgs(dtype="bfloat16"))
    np.testing.assert_allclose(ty, jy, **BF16_TOL)
    np.testing.assert_allclose(taux, jaux, rtol=1e-4)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_expert_products_run_on_grouped_matmul(monkeypatch, fused):
    """Three K9 products (gate, up, down) for the unfused layer, the down
    product alone when the fused graph computes the gated up projection;
    each over E row tiles of ``cap`` rows with ``group_id = arange(E)``.
    No ``torch.matmul``, ``bmm`` or ``einsum`` runs outside the kernels'
    plain versions (K1's router, K9, K5's fused graph)."""
    jcfg, tcfg = _cfgs(use_fusion=fused)
    _, tp, _, tx = _layer(jcfg, tcfg)
    calls, inside = [], [0]

    def kernel(fn, record=False):
        def run(*a, **kw):
            if record:
                x, group_id, w = a
                calls.append((tuple(x.shape), group_id.tolist(), tuple(w.shape),
                              kw.get("out_dtype")))
            inside[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                inside[0] -= 1
        return run

    def forbidden(fn, name):
        def run(*a, **kw):
            assert inside[0], f"torch.{name} outside a kernel's plain version"
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(tops, "grouped_matmul", kernel(tops.grouped_matmul, record=True))
    monkeypatch.setattr(tops, "matmul", kernel(tops.matmul))
    monkeypatch.setattr(TB.fusion_lib, "fused_gated_mlp_apply",
                        kernel(TB.fusion_lib.fused_gated_mlp_apply))
    for name in ("matmul", "bmm", "einsum"):
        monkeypatch.setattr(torch, name, forbidden(getattr(torch, name), name))
    TB.moe_apply(tcfg, tp, tx)
    e, d, f = tcfg.num_experts, tcfg.d_model, tcfg.moe_d_ff
    rows = e * T                       # dropless: cap = T
    want = [((rows, d), list(range(e)), (e, d, f), torch.float32)] * (0 if fused else 2)
    want.append(((rows, f), list(range(e)), (e, f, d), torch.float32))
    assert calls == want


GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("capacity, fused", [(1e9, False), (0.5, False), (1e9, True),
                                             (0.5, True)],
                         ids=["dropless", "drops", "fused-dropless", "fused-drops"])
def test_layer_gradients_match_reference(capacity, fused):
    """jax.grad of sum(r * y) + 0.3 aux through the reference's
    ``moe_apply`` against ``torch.autograd.grad`` through the port's (K9's
    backward on its plain versions; the fused up projection through K5's
    derived graphs), with respect to the input and every weight; at
    capacity 0.5 some slots are dropped, and those take no gradient."""
    jcfg, tcfg = _cfgs(capacity_factor=capacity, use_fusion=fused)
    jp, tp, jx, tx = _layer(jcfg, tcfg)
    r = np.random.default_rng(7).normal(size=(T, tcfg.d_model)).astype(np.float32)

    def jloss(p, x):
        y, aux = JB.moe_apply(jcfg, p, x)
        return jnp.sum(y * r) + 0.3 * aux

    jdx, jdp = jax.grad(jloss, argnums=(1, 0))(jp, jx)
    names = ("router", "wg", "wu", "wd")
    leaves = [tx.requires_grad_()] + [tp[k].requires_grad_() for k in names]
    y, aux = TB.moe_apply(tcfg, tp, tx)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + 0.3 * aux, leaves)
    for name, got, want in zip(("x",) + names, grads, [jdx] + [jdp[k] for k in names]):
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL, err_msg=name)
    if capacity < 1:
        assert _dropped(tcfg, tp, tx.detach()) > 0


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch,changes", [
    ("qwen3_moe_235b", {}),
    ("qwen3_moe_235b", dict(num_layers=6, first_k_dense=2)),
    ("jamba_1_5_large", {}),
    ("deepseek_v2_236b", dict(use_mla=False)),
    ("llama2_13b", {}),
], ids=["qwen3", "qwen3-dense-first", "jamba", "deepseek-no-mla", "llama2"])
def test_layer_groups_match_reference(arch, changes):
    """``derive_groups``: a ``first_k_dense`` group, then a period of
    ``lcm(pattern_period, moe_period)``, group for group the reference's
    (configs the port does not serve yet are built from the reference's
    fields)."""
    jcfg = dataclasses.replace(jax_config(arch), **changes)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    want = [(g.kinds, g.repeat) for g in jlm.derive_groups(jcfg)]
    assert [(g.kinds, g.repeat) for g in tlm.derive_groups(tcfg)] == want
    assert tlm.layer_signatures(tcfg) == [s for kinds, r in want for _ in range(r) for s in kinds]


def test_moe_blocks_hold_moe_not_mlp():
    """qwen3's ``d_ff`` is set but unused: every block holds ``"moe"``."""
    cfg = torch_config("qwen3_moe_235b").reduced()
    params = tlm.init_params(cfg, 0, device="cpu")
    for p in params["layers"]:
        assert "moe" in p and "mlp" not in p
        assert tuple(p["moe"]["wd"].shape) == (cfg.num_experts, cfg.moe_d_ff, cfg.d_model)
    meta = tlm.init_params(torch_config("qwen3_moe_235b"), 0, device="meta")
    assert tuple(meta["layers"][0]["moe"]["wg"].shape) == (128, 4096, 1536)


@pytest.mark.parametrize("capacity", [1e9, 0.5], ids=["dropless", "drops"])
def test_lm_loss_matches_reference(capacity):
    """The reduced model's chunked loss under ``torch.no_grad()``: ce and
    the aux loss summed over both MoE layers, and the loss ce + 0.01 aux."""
    jcfg, tcfg = _cfgs(capacity_factor=capacity)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(4)
    b, s = 2, 16
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32),
             "mask": (rng.random((b, s)) > 0.1).astype(np.float32)}
    jloss, jm = jlm.lm_loss(jcfg, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                            remat=False, loss_chunk=8)
    with torch.no_grad():
        tloss, tm = tlm.lm_loss(tcfg, tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
                                loss_chunk=8)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-5)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert float(tm["aux"]) > 0


@pytest.mark.parametrize("remat", [True, False])
def test_lm_loss_gradients_with_drops_match_reference(remat):
    """Every gradient leaf of the reduced model's ``lm_loss`` (router,
    ``wg``, ``wu``, ``wd``, attention, norms, embedding, head) at capacity
    0.5, where slots are dropped, against ``jax.grad`` of the reference's
    (the dropless case is ``tests/test_torch_train.py``'s)."""
    from repro_torch.optim.adamw import tree_leaves

    jcfg, tcfg = _cfgs(capacity_factor=0.5)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    b, s = 2, 32
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32),
             "mask": (rng.random((b, s)) > 0.1).astype(np.float32)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jlm.lm_loss(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()},
                              remat=remat, loss_chunk=16), has_aux=True)(jparams)
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu",
                                dtype=torch.float32)
    leaves = tree_leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_()
    loss, _ = tlm.lm_loss(tcfg, tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
                          remat=remat, loss_chunk=16)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    grads = torch.autograd.grad(loss, leaves)
    want = tree_leaves(params_from_numpy(tcfg, jax.tree.map(np.asarray, jgrads), device="cpu",
                                         dtype=torch.float32))
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)
