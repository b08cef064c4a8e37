"""Decoder LM: init, forward, loss, dense-cache prefill and decode.

Ported from ``repro/models/lm.py``.  The reference stacks each layer group's
parameters on a leading axis and runs ``lax.scan`` over it; here
``params["layers"]`` is a list with one dictionary per layer and the scan is
a Python loop.  ``models.convert.params_from_numpy`` builds that list from
the reference's stacked pytree.

Dense caches are a list with one dictionary per layer: ``{"k", "v"}`` of
(B, Hk, S_max, hd) tensors for an attention layer, ``{"conv", "h"}`` of
(B, conv-1, d_inner) and (B, d_inner, N) fp32 state for a mamba layer.  The
serving engine's paged caches (``init_paged_cache``) hold token-major page
pools (num_pages + 1, page_size, Hk, hd) for each attention layer and
per-slot mamba state.  Both are updated in place by ``prefill`` and
``decode_step``.

Dense decoders, the encoder-only bert-large (``"bidir"`` layers: attention
without a causal mask), the attention-free Mamba-1 LM (falcon-mamba-7b) and
the mixture-of-experts decoder qwen3-moe-235b (its experts on K9, trained
through K9's backward) run here; MLA, encoder-decoder and VLM configs raise
``NotImplementedError`` (ROADMAP.md, Queue 1).  ``forward_hidden`` returns
the reference's ``(h, caches, aux)``: aux is the MoE layers' load-balance
loss summed over layers (zero without MoE layers), which ``lm_loss``
weights by ``aux_weight``.  Like the reference, ``init_cache``, ``prefill`` and
``decode_step`` do not refuse a bidirectional config (its prefill attends
over the whole prompt); the reference's tests give bert no decode step,
and neither do the port's.  Training (``lm_loss``) takes fp32 master
parameters (``init_params(..., dtype=torch.float32)``), cast to the
compute dtype at use.  ``use_fusion`` configs serve and train through the fused TppGraph
layers and their derived backward graphs; a mamba block has no fused form
and computes the same either way, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.fusion import rng
from repro_torch.kernels import ops
from repro_torch.models import blocks as B

__all__ = [
    "LayerGroup", "derive_groups", "layer_signatures", "layer_kinds", "init_params",
    "forward_hidden", "lm_loss", "init_cache", "init_paged_cache", "prefill",
    "decode_step", "finite_logits",
]


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    kinds: tuple[tuple[str, bool], ...]   # (block kind, is_moe) per position
    repeat: int


def _check_dense(cfg: ModelConfig) -> None:
    unsupported = {
        "MLA attention": cfg.use_mla,
        "encoder-decoder models": cfg.is_encdec,
        "modality frontends": cfg.frontend is not None,
    }
    for what, present in unsupported.items():
        if present:
            raise B._later(what)


def derive_groups(cfg: ModelConfig) -> list[LayerGroup]:
    """The reference's layer groups: the ``first_k_dense`` layers, then one
    group whose period is ``lcm(pattern_period, moe_period)``, each position
    a (kind, is_moe) pair."""
    _check_dense(cfg)
    sigs = cfg._layer_kinds()
    groups = []
    k = cfg.first_k_dense
    if k:
        groups.append(LayerGroup(tuple(sigs[:k]), 1))
    rest = sigs[k:]
    if rest:
        period = math.lcm(cfg.pattern_period, cfg.moe_period if cfg.is_moe else 1)
        if len(rest) % period or any(s != rest[i % period] for i, s in enumerate(rest)):
            raise ValueError(f"{cfg.name}: {len(rest)} layers do not repeat a period of"
                             f" {period}")
        groups.append(LayerGroup(tuple(rest[:period]), len(rest) // period))
    return groups


def layer_signatures(cfg: ModelConfig) -> list[tuple[str, bool]]:
    """(block kind, is_moe) of every layer, in order."""
    return [sig for g in derive_groups(cfg) for _ in range(g.repeat) for sig in g.kinds]


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """Block kind of every layer, in order."""
    return [kind for kind, _ in layer_signatures(cfg)]


# --------------------------------------------------------------------------
# Blocks and parameters
# --------------------------------------------------------------------------

def init_block(cfg: ModelConfig, gen, kind: str, moe: bool, dtype=None):
    """A block's parameters: its mixer, then ``"moe"`` for an MoE layer or
    else ``"mlp"`` where ``d_ff > 0`` (the reference's ``_has_ffn``)."""
    p = {"norm1": B.init_norm(cfg, gen.device)}
    if kind == "mamba":
        p["mamba"] = B.init_mamba(cfg, gen, dtype)
    else:
        p["attn"] = B.init_attention(cfg, gen, dtype)
    if moe or cfg.d_ff > 0:
        p["norm2"] = B.init_norm(cfg, gen.device)
        p["moe" if moe else "mlp"] = (B.init_moe(cfg, gen, dtype) if moe
                                      else B.init_mlp(cfg, gen, dtype))
    return p


def block_apply(cfg: ModelConfig, p, x, *, kind: str, cache=None,
                cache_pos=0, positions=None, page_table=None, page_size=0,
                dropout_seed=None, seq_lengths=None):
    """Pre-norm residual block → (x, cache, aux), aux the MoE layer's
    load-balance loss (an fp32 scalar; the float 0.0 for a block without
    one, which launches nothing).
    ``dropout_seed`` (training only, already folded per layer) enables the
    attention-output dropout.
    With ``cfg.use_fusion`` the residual of an attention block rides the
    fused output projection (``fused_attn_out_res``), which returns the
    post-residual value, as in ``repro/models/lm.py``.  A mamba block keeps
    its per-row state in the cache whatever the layout of the attention
    caches, and honours ``seq_lengths`` ((B,) valid-token counts), so a
    bucket-padded prefill leaves exact state."""
    h = B._norm(cfg, p["norm1"], x)
    if kind == "mamba":
        x = x + B.mamba_apply(cfg, p["mamba"], h, cache=cache, length=seq_lengths)
    else:
        res_folded = cfg.use_fusion
        out, cache = B.attention_apply(cfg, p["attn"], h, kind=kind,
                                       positions=positions, cache=cache,
                                       cache_pos=cache_pos, page_table=page_table,
                                       page_size=page_size, dropout_seed=dropout_seed,
                                       residual=x if res_folded else None)
        x = out if res_folded else x + out
    aux = 0.0
    if "norm2" in p:
        h = B._norm(cfg, p["norm2"], x)
        b, s, d = h.shape
        if "moe" in p:
            y, aux = B.moe_apply(cfg, p["moe"], h.reshape(b * s, d))
        else:
            y = B.mlp_apply(cfg, p["mlp"], h.reshape(b * s, d))
        x = x + y.view(b, s, d)
    return x, cache, aux


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None, dtype=None):
    """Random weights from a seeded ``torch.Generator`` on ``device`` (CUDA
    unless given), with the reference's scales: N(0, 0.02) embeddings and
    LM head, N(0, 1/fan_in) projections, unit norm scales, zero biases.
    Embeddings, projections and biases are stored in ``dtype``: the compute
    dtype by default (serving), or ``torch.float32`` for the fp32 masters
    training updates (the reference's storage).  Norms are fp32 either way.
    A mamba block's ``dt_bias``, ``a_log`` and ``d_skip`` stay fp32 too.
    The draws differ from ``jax.random``'s; tests load the reference's
    weights through ``models.convert.params_from_numpy`` instead.  On the
    ``meta`` device the tensors have shapes and dtypes and no storage."""
    dev = resolve_device(device)
    gen = (B.ShapesOnly() if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    dt = dtype or B.compute_dtype(cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    params = {
        "embed": B._init(gen, (v, d), 0.02, dtype=dt),
        "final_norm": B.init_norm(cfg, gen.device),
        "layers": [init_block(cfg, gen, kind, moe, dt)
                   for kind, moe in layer_signatures(cfg)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = B._init(gen, (d, v), 0.02, dtype=dt)
    return params


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _embed(cfg, params, tokens):
    # The gather, then the cast to the compute dtype: the reference's values
    # (cast, then gather), without casting the whole table.  Its gradient is
    # embedding's sort-based scatter, the same bits from run to run.
    return F.embedding(tokens, params["embed"]).to(B.compute_dtype(cfg))


def _positions_from(pos0, b, s, device):
    """(B, S) positions: ``pos0 + j``, with ``pos0`` a scalar or per-slot
    (B,) positions."""
    steps = torch.arange(s, device=device)
    if isinstance(pos0, torch.Tensor) and pos0.dim() == 1:
        return pos0[:, None] + steps[None, :]
    return int(pos0) + steps.expand(b, s)


def forward_hidden(cfg: ModelConfig, params, batch, *, caches=None,
                   cache_pos=0, page_table=None, page_size=0, remat=True,
                   dropout_seed=None, seq_lengths=None):
    """→ (hidden (B, S, d) in the compute dtype, caches, aux): aux the MoE
    layers' load-balance losses summed (fp32 scalar).  ``batch`` holds
    ``tokens`` (B, S) at positions ``cache_pos ..``; ``cache_pos`` may be a
    per-slot (B,) tensor, and ``page_table``/``page_size`` switch the
    attention caches to the paged pool layout (see ``init_paged_cache``).
    ``seq_lengths`` ((B,), optional) marks the tokens past each row's
    length as padding for the mamba layers.

    Training (no caches, gradients on): with ``remat`` each block runs under
    ``torch.utils.checkpoint``, which keeps only its input and recomputes
    the rest in the backward (the reference's ``jax.checkpoint`` with
    ``nothing_saveable``).  ``dropout_seed`` is folded with each layer's
    index (``fusion.rng.fold_in``) into that layer's dropout seed.  With
    ``cfg.use_fusion`` the fused layers' autograd Functions are replayed by
    the checkpoint; their dropout bits are counter-based, so the replay
    draws the same ones."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = _positions_from(cache_pos, b, s, tokens.device)
    remat = remat and caches is None and torch.is_grad_enabled()
    aux = 0.0
    for i, (kind, p) in enumerate(zip(layer_kinds(cfg), params["layers"])):
        seed_i = rng.fold_in(dropout_seed, i) if dropout_seed is not None else None
        kw = dict(kind=kind, cache=caches[i] if caches is not None else None,
                  cache_pos=cache_pos, positions=positions, page_table=page_table,
                  page_size=page_size, dropout_seed=seed_i, seq_lengths=seq_lengths)
        if remat:
            # the blocks draw no torch random numbers: nothing to replay
            x, _, aux_i = checkpoint(block_apply, cfg, p, x, use_reentrant=False,
                                     preserve_rng_state=False, **kw)
        else:
            x, _, aux_i = block_apply(cfg, p, x, **kw)
        aux = aux + aux_i
    if not isinstance(aux, torch.Tensor):
        aux = torch.zeros((), device=tokens.device)
    return B._norm(cfg, params["final_norm"], x), caches, aux


def _chunk_loss(cfg, w, hc, yc, mc):
    """Summed cross-entropy and token count of one sequence chunk: logits
    (B·chunk, V) in fp32 through K1, padded vocabulary masked to -1e30."""
    b, c, d = hc.shape
    logits = _mask_pad_logits(cfg, ops.matmul(hc.reshape(b * c, d), w,
                                              out_dtype=torch.float32))
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, yc.reshape(b * c, 1))[:, 0]
    m = mc.reshape(b * c)
    return ((logz - ll) * m).sum(), m.sum()


def lm_loss(cfg: ModelConfig, params, batch, *, remat=True, loss_chunk=512,
            aux_weight=0.01, dropout_seed=None):
    """batch: tokens (B, S), labels (B, S), mask (B, S).  → (loss, metrics
    {"ce", "aux", "tokens"}).  Cross-entropy over sequence chunks of
    ``loss_chunk`` tokens, each chunk checkpointed when gradients are on,
    so logits live for one chunk at a time; ``ce = tot / max(cnt, 1)``.
    ``aux`` is ``forward_hidden``'s (zero without MoE layers), weighted by
    ``aux_weight``.  Counterpart of ``repro/models/lm.py::lm_loss``."""
    h, _, aux = forward_hidden(cfg, params, batch, remat=remat, dropout_seed=dropout_seed)
    w = _unembed_weight(cfg, params)
    labels = batch["labels"].long()
    mask = batch["mask"].float()
    b, s, _ = h.shape
    chunk = min(loss_chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of loss_chunk {chunk}")
    tot = torch.zeros((), device=h.device)
    cnt = torch.zeros((), device=h.device)
    for c0 in range(0, s, chunk):
        args = (h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk], mask[:, c0:c0 + chunk])
        if torch.is_grad_enabled():
            t, n = checkpoint(_chunk_loss, cfg, w, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            t, n = _chunk_loss(cfg, w, *args)
        tot, cnt = tot + t, cnt + n
    ce = tot / torch.clamp(cnt, min=1.0)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux, "tokens": cnt}


def _mask_pad_logits(cfg, logits):
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
    return logits.masked_fill(pad, -1e30)


def _unembed_weight(cfg, params):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _logits(cfg, params, h_last):
    # The reference takes an fp32 product of the upcast operands
    # (lm.py:568-569).  K1 with an fp32 output computes the same sums: a
    # product of two bf16 values is exact in fp32.  Unlike a library GEMM,
    # which picks its algorithm by M, K1 sums every row in the same order
    # at any batch of up to 16 rows, so a request's logits do not depend on
    # how many slots decode beside it.
    w = _unembed_weight(cfg, params)
    return _mask_pad_logits(cfg, ops.matmul(h_last, w, out_dtype=torch.float32))


# --------------------------------------------------------------------------
# KV-cache decode
# --------------------------------------------------------------------------

def _mamba_state(cfg: ModelConfig, rows: int, dev):
    """Zeroed per-row mamba state: the last conv-1 inputs in the compute
    dtype and the SSM state in fp32."""
    return {"conv": torch.zeros(rows, cfg.ssm_conv - 1, cfg.d_inner,
                                dtype=B.compute_dtype(cfg), device=dev),
            "h": torch.zeros(rows, cfg.d_inner, cfg.ssm_state,
                             dtype=torch.float32, device=dev)}


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
               ring_local: bool = False, *, device=None):
    """Per layer, a zeroed ``{"k", "v"}`` pair of (B, Hk, S, hd) for
    attention, or ``{"conv", "h"}`` mamba state for B rows.  S is
    ``max_seq``, except that ``ring_local=True`` bounds each sliding-window
    ("local") layer to a ring of ``min(max_seq, sliding_window)``
    positions, as ``repro/models/lm.py::init_cache`` does: the memory of
    5/6 of gemma3's layers then grows with the window, not the sequence.
    ``blocks.attention_apply`` writes such a cache at ``pos % S``; it
    refuses a prompt or chunk that would cross the ring's end."""
    dev = resolve_device(device)
    dt = B.compute_dtype(cfg)

    def attn_cache(kind):
        smax = max_seq
        if ring_local and kind == "local" and cfg.sliding_window:
            smax = min(max_seq, cfg.sliding_window)
        shape = (batch_size, cfg.num_kv_heads, smax, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}

    return [_mamba_state(cfg, batch_size, dev) if kind == "mamba" else attn_cache(kind)
            for kind in layer_kinds(cfg)]


def init_paged_cache(cfg: ModelConfig, num_slots: int, num_pages: int,
                     page_size: int, *, device=None):
    """The serving engine's caches: per attention layer, zeroed token-major
    K and V pools (num_pages + 1, page_size, Hk, hd) shared by all slots
    through a page table.  The last row is the trash page: table entries of
    empty or retired slots point at it, so their writes land outside every
    live request's pages (reads are length-masked).  Mamba state is O(1)
    per slot, so a mamba layer holds ``{"conv", "h"}`` for ``num_slots``
    rows, as ``init_cache`` does; a config without attention layers has no
    pools."""
    dev = resolve_device(device)
    shape = (num_pages + 1, page_size, cfg.num_kv_heads, cfg.head_dim)
    dt = B.compute_dtype(cfg)
    return [_mamba_state(cfg, num_slots, dev) if kind == "mamba" else
            {"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
            for kind in layer_kinds(cfg)]


def prefill(cfg: ModelConfig, params, caches, batch, *, page_table=None,
            page_size=0, logit_index=None):
    """Process the prompt, writing the caches from position 0; →
    (last-token logits (B, V) fp32, caches).  ``logit_index`` ((B,)
    integer tensor) reads each row's logits at its own position instead of
    the last one: the engine right-pads prompts to a shape bucket.  It
    doubles as the mamba layers' valid length (``logit_index + 1``), so
    their state is exact despite the padding."""
    seq_lengths = logit_index.long() + 1 if logit_index is not None else None
    h, caches, _ = forward_hidden(cfg, params, batch, caches=caches, cache_pos=0,
                                  page_table=page_table, page_size=page_size,
                                  seq_lengths=seq_lengths)
    if logit_index is None:
        h_last = h[:, -1]
    else:
        h_last = h[torch.arange(h.shape[0], device=h.device), logit_index.long()]
    return _logits(cfg, params, h_last), caches


def decode_step(cfg: ModelConfig, params, caches, tokens, pos, *,
                page_table=None, page_size=0):
    """One decode step: tokens (B,) at position ``pos``, a scalar or
    per-slot (B,) positions (continuous batching); → (logits (B, V) fp32,
    caches)."""
    h, caches, _ = forward_hidden(cfg, params, {"tokens": tokens[:, None]},
                                  caches=caches, cache_pos=pos,
                                  page_table=page_table, page_size=page_size)
    return _logits(cfg, params, h[:, -1]), caches


def finite_logits(logits):
    """(B, V) → (B,) bool: True where every logit is finite."""
    return torch.isfinite(logits).all(dim=-1)
