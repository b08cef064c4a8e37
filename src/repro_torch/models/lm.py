"""Dense decoder LM: init, forward, dense KV-cache prefill and decode.

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

Only dense decoders run here; MoE, MLA, SSM, encoder-decoder, VLM and
``use_fusion`` configs raise ``NotImplementedError`` (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import blocks as B

__all__ = [
    "LayerGroup", "derive_groups", "layer_kinds", "init_params",
    "forward_hidden", "init_cache", "init_paged_cache", "prefill",
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

def init_block(cfg: ModelConfig, gen):
    p = {"norm1": B.init_norm(cfg, gen.device),
         "attn": B.init_attention(cfg, gen)}
    if cfg.d_ff > 0:
        p["norm2"] = B.init_norm(cfg, gen.device)
        p["mlp"] = B.init_mlp(cfg, gen)
    return p


def block_apply(cfg: ModelConfig, p, x, *, kind: str, cache=None,
                cache_pos=0, positions=None, page_table=None, page_size=0):
    """Pre-norm residual block → (x, cache)."""
    h = B._norm(cfg, p["norm1"], x)
    out, cache = B.attention_apply(cfg, p["attn"], h, kind=kind,
                                   positions=positions, cache=cache,
                                   cache_pos=cache_pos, page_table=page_table,
                                   page_size=page_size)
    x = x + out
    if "mlp" in p:
        h = B._norm(cfg, p["norm2"], x)
        b, s, d = h.shape
        x = x + B.mlp_apply(cfg, p["mlp"], h.reshape(b * s, d)).view(b, s, d)
    return x, cache


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None):
    """Random weights from a seeded ``torch.Generator`` on ``device`` (CUDA
    unless given), with the reference's scales: N(0, 0.02) embeddings and
    LM head, N(0, 1/fan_in) projections, unit norm scales, zero biases.
    The draws differ from ``jax.random``'s; tests load the reference's
    weights through ``models.convert.params_from_numpy`` instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = B.compute_dtype(cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    params = {
        "embed": B._init(gen, (v, d), 0.02, dtype=dt),
        "final_norm": B.init_norm(cfg, gen.device),
        "layers": [init_block(cfg, gen) for _ in layer_kinds(cfg)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = B._init(gen, (d, v), 0.02, dtype=dt)
    return params


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _embed(cfg, params, tokens):
    return params["embed"][tokens]


def _positions_from(pos0, b, s, device):
    """(B, S) positions: ``pos0 + j``, with ``pos0`` a scalar or per-slot
    (B,) positions."""
    steps = torch.arange(s, device=device)
    if isinstance(pos0, torch.Tensor) and pos0.dim() == 1:
        return pos0[:, None] + steps[None, :]
    return int(pos0) + steps.expand(b, s)


def forward_hidden(cfg: ModelConfig, params, batch, *, caches=None,
                   cache_pos=0, page_table=None, page_size=0):
    """→ (hidden (B, S, d) in the compute dtype, caches).  ``batch`` holds
    ``tokens`` (B, S) at positions ``cache_pos ..``; ``cache_pos`` may be a
    per-slot (B,) tensor, and ``page_table``/``page_size`` switch the
    caches to the paged pool layout (see ``init_paged_cache``)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = _positions_from(cache_pos, b, s, tokens.device)
    for i, (kind, p) in enumerate(zip(layer_kinds(cfg), params["layers"])):
        x, _ = block_apply(cfg, p, x, kind=kind,
                           cache=caches[i] if caches is not None else None,
                           cache_pos=cache_pos, positions=positions,
                           page_table=page_table, page_size=page_size)
    return B._norm(cfg, params["final_norm"], x), caches


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
