"""Dense decoder LM: init, forward, loss, dense KV-cache prefill and decode.

Ported from ``repro/models/lm.py``.  The reference stacks each layer group's
parameters on a leading axis and runs ``lax.scan`` over it; here
``params["layers"]`` is a list with one dictionary per layer and the scan is
a Python loop.  ``models.convert.params_from_numpy`` builds that list from
the reference's stacked pytree.

Dense caches are a list with one ``{"k", "v"}`` dictionary of
(B, Hk, S_max, hd) tensors per layer; the serving engine's paged caches
(``init_paged_cache``) are a list with one ``{"k", "v"}`` dictionary of
token-major page pools (num_pages + 1, page_size, Hk, hd) per layer.  Both
are updated in place by ``prefill`` and ``decode_step``.

Training (``lm_loss``) takes fp32 master parameters (``init_params(...,
dtype=torch.float32)``), cast to the compute dtype at use.  Only dense
decoders run here; MoE, MLA, SSM, encoder-decoder, VLM and
``use_fusion`` configs raise ``NotImplementedError`` (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.fusion import rng
from repro_torch.kernels import ops
from repro_torch.models import blocks as B

__all__ = [
    "LayerGroup", "derive_groups", "layer_kinds", "init_params",
    "forward_hidden", "lm_loss", "init_cache", "init_paged_cache", "prefill",
    "decode_step", "finite_logits",
]


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    kinds: tuple[tuple[str, bool], ...]   # (block kind, is_moe) per position
    repeat: int


def _check_dense(cfg: ModelConfig) -> None:
    unsupported = {
        "MoE layers": cfg.is_moe, "MLA attention": cfg.use_mla,
        "encoder-decoder models": cfg.is_encdec,
        "modality frontends": cfg.frontend is not None,
        "fused TppGraph layers (use_fusion=True)": cfg.use_fusion,
        "mamba layers": "mamba" in cfg.layer_pattern,
        "bidirectional decoder layers": "bidir" in cfg.layer_pattern,
    }
    for what, present in unsupported.items():
        if present:
            raise B._later(what)


def derive_groups(cfg: ModelConfig) -> list[LayerGroup]:
    """The reference's layer groups for a dense decoder: one group, its
    period the config's layer pattern."""
    _check_dense(cfg)
    sigs = cfg._layer_kinds()
    period = cfg.pattern_period
    if len(sigs) % period:
        raise ValueError(f"{cfg.name}: {len(sigs)} layers, pattern period {period}")
    return [LayerGroup(tuple(sigs[:period]), len(sigs) // period)]


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """Block kind of every layer, in order."""
    return [kind for g in derive_groups(cfg) for _ in range(g.repeat)
            for kind, _ in g.kinds]


# --------------------------------------------------------------------------
# Blocks and parameters
# --------------------------------------------------------------------------

def init_block(cfg: ModelConfig, gen, dtype=None):
    p = {"norm1": B.init_norm(cfg, gen.device),
         "attn": B.init_attention(cfg, gen, dtype)}
    if cfg.d_ff > 0:
        p["norm2"] = B.init_norm(cfg, gen.device)
        p["mlp"] = B.init_mlp(cfg, gen, dtype)
    return p


def block_apply(cfg: ModelConfig, p, x, *, kind: str, cache=None,
                cache_pos=0, positions=None, page_table=None, page_size=0,
                dropout_seed=None):
    """Pre-norm residual block → (x, cache).  ``dropout_seed`` (training
    only, already folded per layer) enables the attention-output dropout."""
    h = B._norm(cfg, p["norm1"], x)
    out, cache = B.attention_apply(cfg, p["attn"], h, kind=kind,
                                   positions=positions, cache=cache,
                                   cache_pos=cache_pos, page_table=page_table,
                                   page_size=page_size, dropout_seed=dropout_seed)
    x = x + out
    if "mlp" in p:
        h = B._norm(cfg, p["norm2"], x)
        b, s, d = h.shape
        x = x + B.mlp_apply(cfg, p["mlp"], h.reshape(b * s, d)).view(b, s, d)
    return x, cache


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None, dtype=None):
    """Random weights from a seeded ``torch.Generator`` on ``device`` (CUDA
    unless given), with the reference's scales: N(0, 0.02) embeddings and
    LM head, N(0, 1/fan_in) projections, unit norm scales, zero biases.
    Embeddings, projections and biases are stored in ``dtype``: the compute
    dtype by default (serving), or ``torch.float32`` for the fp32 masters
    training updates (the reference's storage).  Norms are fp32 either way.
    The draws differ from ``jax.random``'s; tests load the reference's
    weights through ``models.convert.params_from_numpy`` instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = dtype or B.compute_dtype(cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    params = {
        "embed": B._init(gen, (v, d), 0.02, dtype=dt),
        "final_norm": B.init_norm(cfg, gen.device),
        "layers": [init_block(cfg, gen, dt) for _ in layer_kinds(cfg)],
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
                   dropout_seed=None):
    """→ (hidden (B, S, d) in the compute dtype, caches).  ``batch`` holds
    ``tokens`` (B, S) at positions ``cache_pos ..``; ``cache_pos`` may be a
    per-slot (B,) tensor, and ``page_table``/``page_size`` switch the
    caches to the paged pool layout (see ``init_paged_cache``).

    Training (no caches, gradients on): with ``remat`` each block runs under
    ``torch.utils.checkpoint``, which keeps only its input and recomputes
    the rest in the backward (the reference's ``jax.checkpoint`` with
    ``nothing_saveable``).  ``dropout_seed`` is folded with each layer's
    index (``fusion.rng.fold_in``) into that layer's dropout seed."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = _positions_from(cache_pos, b, s, tokens.device)
    remat = remat and caches is None and torch.is_grad_enabled()
    for i, (kind, p) in enumerate(zip(layer_kinds(cfg), params["layers"])):
        seed_i = rng.fold_in(dropout_seed, i) if dropout_seed is not None else None
        kw = dict(kind=kind, cache=caches[i] if caches is not None else None,
                  cache_pos=cache_pos, positions=positions, page_table=page_table,
                  page_size=page_size, dropout_seed=seed_i)
        if remat:
            # the blocks draw no torch random numbers: nothing to replay
            x, _ = checkpoint(block_apply, cfg, p, x, use_reentrant=False,
                              preserve_rng_state=False, **kw)
        else:
            x, _ = block_apply(cfg, p, x, **kw)
    return B._norm(cfg, params["final_norm"], x), caches


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
    Dense models have no auxiliary loss (aux = 0).  Counterpart of
    ``repro/models/lm.py::lm_loss``."""
    h, _ = forward_hidden(cfg, params, batch, remat=remat, dropout_seed=dropout_seed)
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
    aux = torch.zeros((), device=h.device)
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

def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, *,
               device=None):
    """One zeroed ``{"k", "v"}`` pair of (B, Hk, max_seq, hd) per layer."""
    dev = resolve_device(device)
    shape = (batch_size, cfg.num_kv_heads, max_seq, cfg.head_dim)
    dt = B.compute_dtype(cfg)
    return [{"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
            for _ in layer_kinds(cfg)]


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int, *,
                     device=None):
    """The serving engine's caches: per layer, zeroed token-major K and V
    pools (num_pages + 1, page_size, Hk, hd) shared by all slots through a
    page table.  The last row is the trash page: table entries of empty or
    retired slots point at it, so their writes land outside every live
    request's pages (reads are length-masked).  The reference also takes
    ``num_slots``, which sizes per-slot mamba state; mamba layers raise
    here."""
    dev = resolve_device(device)
    shape = (num_pages + 1, page_size, cfg.num_kv_heads, cfg.head_dim)
    dt = B.compute_dtype(cfg)
    return [{"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
            for _ in layer_kinds(cfg)]


def prefill(cfg: ModelConfig, params, caches, batch, *, page_table=None,
            page_size=0, logit_index=None):
    """Process the prompt, writing the caches from position 0; →
    (last-token logits (B, V) fp32, caches).  ``logit_index`` ((B,)
    integer tensor) reads each row's logits at its own position instead of
    the last one: the engine right-pads prompts to a shape bucket."""
    h, caches = forward_hidden(cfg, params, batch, caches=caches, cache_pos=0,
                               page_table=page_table, page_size=page_size)
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
    h, caches = forward_hidden(cfg, params, {"tokens": tokens[:, None]},
                               caches=caches, cache_pos=pos,
                               page_table=page_table, page_size=page_size)
    return _logits(cfg, params, h[:, -1]), caches


def finite_logits(logits):
    """(B, V) → (B,) bool: True where every logit is finite."""
    return torch.isfinite(logits).all(dim=-1)
