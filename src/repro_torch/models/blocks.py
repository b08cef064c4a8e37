"""Dense transformer blocks, ported from ``repro/models/blocks.py``.

Every contraction goes through ``repro_torch.kernels.ops`` (plain PyTorch on
the CPU, the CUDA kernels on the GPU); every elementwise or normalisation op
is a TPP from ``repro_torch.core.tpp``.  Parameters are dictionaries of
tensors in the reference's layouts: projection weights (d_in, d_out), used
as ``x @ w``.  Projection weights and biases are stored in the compute dtype
for serving, or as fp32 masters for training, as the reference keeps them;
either way ``ops.matmul`` casts them to the activations' dtype at use (the
reference's ``_cast``).  Norm scales and biases stay fp32.

Ported so far: the dense decoder's attention (no cache, with the training
path's output-projection dropout; the dense cache at a scalar position or at
per-slot positions, and its ring-buffer form for sliding-window layers; the
paged pools of the serving engine) and MLP (gated and plain).  With
``cfg.use_fusion`` the output projection (with the
block's residual and the training path's dropout), the MLP's up projection
and the no-cache attention (the chained root) are fused TppGraphs
(``repro_torch.fusion``: K5 on the card) with derived backward graphs, as
in ``repro``.  The Mamba-1 block (``mamba_apply``: the selective scan, K8
on the card) serves with the dense and the paged caches and trains.  The
token-choice top-k mixture of experts (``moe_apply``, single device) serves
and trains: its router is K1, its experts' three products K9
(``ops.grouped_matmul``, whose backward is K9's dX and dW kernels) over the
(E, cap, d) dispatch buffer.  The MLA and cross-attention branches and
expert parallelism are still to be ported (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tpp
from repro_torch.fusion import library as fusion_lib
from repro_torch.fusion import rng
from repro_torch.kernels import ops

__all__ = ["compute_dtype", "init_norm", "init_attention", "init_mlp", "init_moe",
           "init_mamba", "apply_rope", "attention_apply", "mlp_apply", "moe_apply",
           "mamba_apply",
           "ATTN_OUT_DROPOUT_SALT"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_CAUSAL_KINDS = ("attn", "local", "global")
# Salt of the attention output-projection dropout: the one the fused and
# unfused paths share.
ATTN_OUT_DROPOUT_SALT = fusion_lib.ATTN_OUT_DROPOUT_SALT


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; see ROADMAP.md, Queue 1")


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


class ShapesOnly:
    """Stands in for a ``torch.Generator`` on the ``meta`` device, where
    none exists: ``lm.init_params(..., device="meta")`` then builds every
    parameter's shape and dtype and allocates nothing (``serve.probe``
    counts their bytes)."""
    device = torch.device("meta")


def _init(gen, shape, scale=None, *, dtype):
    """N(0, 1) * scale (default 1/sqrt(fan_in)), drawn in fp32 on the
    generator's device, stored in ``dtype``; on the ``meta`` device only
    the shape and dtype."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def _norm(cfg: ModelConfig, p, x):
    if cfg.norm == "layernorm":
        return tpp.layernorm(x, p["scale"], p["bias"])
    return tpp.rmsnorm(x, p["scale"])


def init_norm(cfg: ModelConfig, device):
    p = {"scale": torch.ones(cfg.d_model, dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(cfg.d_model, dtype=torch.float32, device=device)
    return p


# --------------------------------------------------------------------------
# RoPE (full / partial-fraction variants)
# --------------------------------------------------------------------------

def apply_rope(x, positions, *, theta: float, fraction: float = 1.0):
    """x (B, S, H, D); positions (B, S).  Rotates the first
    ``even(D*fraction)`` dims by half-split rotation, passes the rest."""
    d = x.shape[-1]
    rot = int(d * fraction) // 2 * 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs  # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = xr[..., :half].float(), xr[..., half:].float()
    xr = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([xr.to(x.dtype), xp], dim=-1)


# --------------------------------------------------------------------------
# Paged-cache indexing (serving engine; see serve/kvcache.py)
# --------------------------------------------------------------------------

def _page_lookup(page_table, idx):
    """page_table (B, maxp) → page ids for per-token page indices ``idx``
    (B, T).  Out-of-range indices clip to the last column, which the
    allocator fills with the trash-page sentinel: writes for padding or
    retired slots land in the trash page, and reads are length-masked."""
    idx = idx.clamp(0, page_table.shape[-1] - 1)
    return torch.gather(page_table.long(), 1, idx.long())


# --------------------------------------------------------------------------
# GQA attention (causal / sliding-window / bidirectional) with a KV cache
# --------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, gen, dtype=None):
    d, h, hk, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = dtype or compute_dtype(cfg)
    return {
        "wq": _init(gen, (d, h * hd), dtype=dt),
        "wk": _init(gen, (d, hk * hd), dtype=dt),
        "wv": _init(gen, (d, hk * hd), dtype=dt),
        "wo": _init(gen, (h * hd, d), scale=1.0 / math.sqrt(h * hd), dtype=dt),
    }


def attention_apply(cfg: ModelConfig, p, x, *, kind: str = "attn",
                    positions=None, cache=None, cache_pos=0,
                    page_table=None, page_size: int = 0, dropout_seed=None,
                    residual=None):
    """x (B, S, d) → (out (B, S, d), cache).  kind ∈ {attn, local, global,
    bidir}.

    Without a cache: prefill/training attention over the S tokens.  With a
    dense cache ``{"k", "v"}`` of (B, Hk, S_max, hd): ``cache_pos`` is a
    scalar write position (S == 1 decodes against the cache up to
    ``cache_pos + 1``, S > 1 attends over ``[0, cache_pos + S)``), or a
    (B,) tensor of per-slot positions for a one-token decode (continuous
    batching: each slot attends up to its own ``pos + 1``).  A ``"local"``
    layer's cache no longer than ``cfg.sliding_window`` is a ring
    (``lm.init_cache(..., ring_local=True)``): position ``p`` is written at
    ``p % S_max`` and attended over the ``min(p + 1, S_max)`` entries
    without a window mask; a chunk of S > 1 tokens must end inside the
    ring, else ``ValueError``.

    Paged mode (``page_table`` (B, maxp) and ``page_size``): the cache holds
    token-major page pools (P + 1, page_size, Hk, hd) shared by all slots.
    Decode (S == 1, per-slot ``cache_pos``) scatters the new K/V into
    (page, offset) and attends through the page table; prefill (S > 1, from
    position 0) attends over the in-flight K/V and only records them in the
    slot's pages.

    ``dropout_seed`` (training only, already folded per step and layer)
    enables the output-projection dropout at ``cfg.dropout_rate``: the
    reference's counter-based bits (``fusion.rng.dropout``) over the same
    (B·S, d) index space and salt.

    ``residual`` (B, S, d) is added to the output (the block's residual).
    With ``cfg.use_fusion`` the output projection, its dropout and that add
    are one fused graph (``repro/models/blocks.py``'s
    ``fused_attn_out_apply``: in-kernel counter bits, regenerated by the
    derived backward), and attention without a cache runs the chained-root
    graph (``fused_attention_apply``), as the reference routes them.

    The reference returns new caches; here every cache write lands in place
    in the caller's tensors (the dense buffers or the pools), and the same
    dictionary is returned."""
    if kind not in _CAUSAL_KINDS + ("bidir",):
        raise _later(f"attention kind {kind!r}")
    b, s, d = x.shape
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)

    x2 = x.reshape(b * s, d)
    xq = ops.matmul(x2, p["wq"]).view(b, s, h, hd)
    xk = ops.matmul(x2, p["wk"]).view(b, s, hk, hd)
    xv = ops.matmul(x2, p["wv"]).view(b, s, hk, hd)
    xq = apply_rope(xq, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
    xk = apply_rope(xk, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
    q = xq.transpose(1, 2)  # (B, H, S, hd), a strided view
    k = xk.transpose(1, 2)
    v = xv.transpose(1, 2)

    window = cfg.sliding_window if kind == "local" else None
    causal = kind in _CAUSAL_KINDS
    per_slot = isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 1
    if cache is None:
        if cfg.use_fusion:
            o = fusion_lib.fused_attention_apply(q, k, v, causal=causal, window=window)
        else:
            o = ops.attention(q, k, v, causal=causal, window=window)
    elif page_table is not None:
        if page_size < 1:
            raise ValueError("a paged cache needs page_size >= 1")
        if s == 1:
            if not per_slot:
                raise ValueError("paged decode takes per-slot (B,) positions")
            pos = cache_pos
            pg = _page_lookup(page_table, (pos // page_size)[:, None])[:, 0]
            off = pos % page_size
            cache["k"][pg, off] = k[:, :, 0]
            cache["v"][pg, off] = v[:, :, 0]
            o = ops.paged_decode_attention(
                q[:, :, 0], cache["k"], cache["v"], page_table,
                page_size=page_size, length=pos + 1, window=window)[:, :, None]
        else:
            # whole-prompt prefill from position 0: attention runs on the
            # in-flight K/V; the pages only record them for later decode.
            # Positions past the slot's pages clip into the trash page.
            if per_slot or cache_pos != 0:
                raise ValueError("paged prefill starts at position 0")
            tpos = torch.arange(s, device=x.device)
            pg = _page_lookup(page_table, (tpos // page_size).expand(b, s))
            off = (tpos % page_size).expand(b, s)
            cache["k"][pg, off] = xk
            cache["v"][pg, off] = xv
            o = ops.attention(q, k, v, causal=causal, window=window)
    else:
        smax = cache["k"].shape[2]
        # A local layer's cache no longer than the window is a ring
        # (init_cache ring_local), written at pos % smax.  Once full, its
        # smax entries are the window, so no window mask is needed: keys
        # carry absolute RoPE and softmax does not depend on their order.
        ring = kind == "local" and cfg.sliding_window is not None and smax <= cfg.sliding_window
        if ring:
            window = None
        if per_slot:
            if s != 1:
                raise ValueError("per-slot cache positions are decode-only (S == 1)")
            pos = cache_pos
            wpos = pos % smax if ring else pos
            bidx = torch.arange(b, device=x.device)
            cache["k"][bidx, :, wpos] = k[:, :, 0]
            cache["v"][bidx, :, wpos] = v[:, :, 0]
            length = (pos + 1).clamp(max=smax) if ring else pos + 1
            o = ops.decode_attention(q[:, :, 0], cache["k"], cache["v"],
                                     length=length, window=window)[:, :, None]
        else:
            cache_pos = int(cache_pos)
            if ring and s > 1 and cache_pos + s > smax:
                _refuse_ring_chunk(smax, cache_pos, s)
            wpos = cache_pos % smax if ring else cache_pos
            cache["k"][:, :, wpos:wpos + s] = k
            cache["v"][:, :, wpos:wpos + s] = v
            if s == 1:
                length = torch.full((b,), min(cache_pos + 1, smax) if ring else cache_pos + 1,
                                    dtype=torch.int32, device=x.device)
                o = ops.decode_attention(q[:, :, 0], cache["k"], cache["v"],
                                         length=length, window=window)[:, :, None]
            else:
                end = cache_pos + s
                o = ops.attention(q, cache["k"][:, :, :end], cache["v"][:, :, :end],
                                  causal=causal, window=window)
    o = o.transpose(1, 2).reshape(b * s, h * hd)
    dropping = dropout_seed is not None and cfg.dropout_rate > 0.0
    if cfg.use_fusion:
        res2d = residual.reshape(b * s, d) if residual is not None else None
        out = fusion_lib.fused_attn_out_apply(
            o, p["wo"].to(o.dtype), residual=res2d,
            dropout_rate=cfg.dropout_rate if dropping else 0.0,
            dropout_seed=dropout_seed if dropping else None)
        return out.view(b, s, d), cache
    out = ops.matmul(o, p["wo"])
    if dropping:
        out = rng.dropout(out, dropout_seed, ATTN_OUT_DROPOUT_SALT, cfg.dropout_rate)
    out = out.view(b, s, d)
    if residual is not None:
        out = residual + out
    return out, cache


def _refuse_ring_chunk(smax, cache_pos, s):
    """A chunk of ``s`` > 1 tokens at ``cache_pos`` that does not fit in a
    ring of ``smax`` positions: a prompt longer than the ring (the
    reference raises ``TypeError`` there), or a chunk that would cross the
    ring's end (the reference clamps its write and attends over the wrong
    keys).  Decode one token at a time past the ring's end instead."""
    if cache_pos == 0:
        raise ValueError(
            f"a prompt of {s} tokens is longer than the ring of {smax} positions of a local"
            f" layer (init_cache ring_local=True): prefill at most {smax} tokens into it")
    raise ValueError(
        f"a chunk of {s} tokens at position {cache_pos} would cross the end of the ring of"
        f" {smax} positions of a local layer (init_cache ring_local=True): a chunk must end"
        f" by position {smax}; decode past it one token at a time")


# --------------------------------------------------------------------------
# MLP (gated / plain)
# --------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen, dtype=None, *, d_ff=None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype or compute_dtype(cfg)
    if cfg.gated_mlp:
        return {"wg": _init(gen, (d, ff), dtype=dt),
                "wu": _init(gen, (d, ff), dtype=dt),
                "wd": _init(gen, (ff, d), scale=1.0 / math.sqrt(ff), dtype=dt)}
    return {"wu": _init(gen, (d, ff), dtype=dt),
            "wd": _init(gen, (ff, d), scale=1.0 / math.sqrt(ff), dtype=dt),
            "bu": torch.zeros(ff, dtype=dt, device=gen.device),
            "bd": torch.zeros(d, dtype=dt, device=gen.device)}


def mlp_apply(cfg: ModelConfig, p, x2d):
    """x2d (T, d) → (T, d): GEMM with the activation fused in its epilogue.
    With ``cfg.use_fusion`` the up projection is one fused graph:
    ``fused_gated_mlp`` (both roots on one lhs) or ``fused_mlp`` (bias and
    activation); the down projection stays K1."""
    act = cfg.mlp_activation
    dt = x2d.dtype
    if cfg.use_fusion:
        if cfg.gated_mlp:
            h = fusion_lib.fused_gated_mlp_apply(x2d, p["wg"].to(dt), p["wu"].to(dt),
                                                 activation=act)
            return ops.matmul(h, p["wd"])
        h = fusion_lib.fused_mlp_apply(x2d, p["wu"].to(dt), p["bu"].to(dt), activation=act)
        return ops.matmul(h, p["wd"], bias=p["bd"])
    if cfg.gated_mlp:
        g = ops.matmul(x2d, p["wg"], activation=act)
        u = ops.matmul(x2d, p["wu"])
        return ops.matmul(tpp.mul(g, u), p["wd"])
    hid = ops.matmul(x2d, p["wu"], bias=p["bu"], activation=act)
    return ops.matmul(hid, p["wd"], bias=p["bd"])


# --------------------------------------------------------------------------
# Mixture of experts (token-choice top-k, capacity-bounded dispatch)
# --------------------------------------------------------------------------

def init_moe(cfg: ModelConfig, gen, dtype=None):
    """The router (d, E) at scale 0.02 and the experts' gated FFN, ``wg``
    and ``wu`` (E, d, f) and ``wd`` (E, f, d), at the reference's scales
    (``wg`` and ``wu`` at 1/sqrt of their leading axis, as its ``_init``);
    ``"shared"``, a dense gated MLP of ``moe_d_ff · num_shared_experts``,
    where the config has shared experts."""
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dt = dtype or compute_dtype(cfg)
    p = {"router": _init(gen, (d, e), 0.02, dtype=dt),
         "wg": _init(gen, (e, d, ff), dtype=dt),
         "wu": _init(gen, (e, d, ff), dtype=dt),
         "wd": _init(gen, (e, ff, d), 1.0 / math.sqrt(ff), dtype=dt)}
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(cfg, gen, dtype, d_ff=cfg.moe_d_ff * cfg.num_shared_experts)
    return p


def _expert_ffn(cfg: ModelConfig, wg, wu, wd, xe):
    """xe (E, C, d) → (E, C, d): the gated FFN of every expert over its C
    slots.  The three products run on ``ops.grouped_matmul`` (K9 on the
    card; its backward K9's dX and dW kernels): xe viewed as E row tiles of
    C rows, tile i on expert i, each product accumulated and returned in
    fp32, as the reference's einsums are.  The weights go in as they are
    stored (fp32 masters when training) and are cast to xe's dtype inside
    the product, so their gradients come back in fp32.  With
    ``cfg.use_fusion`` each expert's gated up projection is
    ``fused_gated_mlp_apply`` (K5 on the card, with its derived backward
    graphs), one call an expert, as the reference's loop; the down product
    stays on K9."""
    e, cap, d = xe.shape
    dt = xe.dtype
    gid = torch.arange(e, dtype=torch.int32, device=xe.device)
    if cfg.use_fusion:
        wg, wu = wg.to(dt), wu.to(dt)
        h = torch.stack([fusion_lib.fused_gated_mlp_apply(xe[i], wg[i], wu[i],
                                                          activation=cfg.mlp_activation)
                         for i in range(e)]).to(dt)
    else:
        x2 = xe.reshape(e * cap, d)
        g = ops.grouped_matmul(x2, gid, wg, out_dtype=torch.float32)
        u = ops.grouped_matmul(x2, gid, wu, out_dtype=torch.float32)
        h = (tpp.ACTIVATIONS[cfg.mlp_activation](g) * u).to(dt)
    y = ops.grouped_matmul(h.reshape(e * cap, -1), gid, wd, out_dtype=torch.float32)
    return y.to(dt).view(e, cap, d)


def _top_k(probs, k):
    """The k largest of each row, ties to the lower index (``lax.top_k``'s
    order; ``torch.topk`` promises none): a stable descending sort."""
    w, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[:, :k], i[:, :k]


def moe_apply(cfg: ModelConfig, p, x2d):
    """Token-choice top-k MoE with capacity-bounded dispatch, x2d (T, d) →
    (y (T, d), aux): the reference's single-device ``moe_apply``.

    The router's logits come from K1 in fp32; top k of the softmax,
    renormalised.  Each expert holds ``cap = min(T, max(1, ceil(capacity ·
    T · k / E)))`` slots, filled in (token, k) order (a stable sort of the
    expert ids ranks them); a slot ranked past ``cap`` is dropped into a
    trash row, read back as zeros.  So, by the reference's design, a
    token's output depends on the batch it shares once drops occur;
    dropless (``cap = T``) it does not.  The buffer (E, cap, d) goes
    through ``_expert_ffn`` (K9), each slot comes back scaled by its weight
    in the compute dtype, and the k slots of a token are summed in fp32,
    one after another.  The softmax
    and the renormalisation sum each row in a fixed order
    (``tpp._row_sum``), so a decoded row does not depend on its batch.
    ``aux`` is the Switch load-balance loss (fp32 scalar).

    Training differentiates it as the reference's ``jax.grad`` does: the
    experts' products through K9's backward, the router through the top-k
    weights (the softmax's shift held constant, as ``jax.nn.softmax``'s)
    and the aux loss, the dispatch and gather through their index ops; a
    dropped slot and the trash row take no gradient, and the expert ids
    none."""
    dt = x2d.dtype
    t, d = x2d.shape
    e, k = cfg.num_experts, cfg.experts_per_tok

    logits = ops.matmul(x2d, p["router"], out_dtype=torch.float32)
    ex = torch.exp(logits - logits.amax(-1, keepdim=True).detach())
    probs = ex / tpp._row_sum(ex)
    topw, topi = _top_k(probs, k)                                  # (T, k)
    topw = topw / torch.clamp(tpp._row_sum(topw), min=1e-9)

    # a token takes at most one slot of an expert: T is the dropless bound
    cap = int(min(t, max(1, math.ceil(cfg.capacity_factor * t * k / e))))
    flat_e = topi.reshape(-1)                                       # (T·k,)
    sorted_e, order = torch.sort(flat_e, stable=True)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.empty_like(flat_e).scatter_(
        0, order, torch.arange(t * k, device=x2d.device) - first)
    kept = rank < cap
    slot = torch.where(kept, flat_e * cap + rank, e * cap)          # e·cap: the trash row

    xe = x2d.new_zeros(e * cap + 1, d)
    xe[slot] = x2d.repeat_interleave(k, dim=0)
    ye = _expert_ffn(cfg, p["wg"], p["wu"], p["wd"], xe[:e * cap].view(e, cap, d))
    ye = torch.cat([ye.reshape(e * cap, d), ye.new_zeros(1, d)])
    contrib = (ye[slot] * topw.reshape(-1, 1).to(dt)).view(t, k, d)
    y = contrib[:, 0].float()
    for j in range(1, k):
        y = y + contrib[:, j].float()
    y = y.to(dt)
    if cfg.num_shared_experts:
        y = y + mlp_apply(cfg, p["shared"], x2d)
    return y, _moe_aux_loss(probs, topi, e)


def _moe_aux_loss(probs, topi, e):
    """Switch-style load-balance loss, fp32: E · Σ_e mean prob(e) · share of
    the T·k slots routed to e."""
    t, k = topi.shape
    counts = torch.bincount(topi.reshape(-1), minlength=e).float()
    return e * torch.sum(probs.mean(0) * (counts / (t * k)))


# --------------------------------------------------------------------------
# Mamba-1 block (selective SSM)
# --------------------------------------------------------------------------

def init_mamba(cfg: ModelConfig, gen, dtype=None):
    """The reference's initialisation: S4D-real A (``a_log`` = log 1..N per
    channel), dt bias -2 (softplus about 0.12), unit skip ``d_skip``.
    ``dt_bias``, ``a_log`` and ``d_skip`` stay fp32 (the reference reads
    them uncast); the rest is stored in ``dtype``."""
    d, di, n, dr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_dt_rank
    dt = dtype or compute_dtype(cfg)
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "w_in": _init(gen, (d, 2 * di), dtype=dt),
        "conv_w": _init(gen, (cfg.ssm_conv, di), 0.5, dtype=dt),
        "conv_b": torch.zeros(di, dtype=dt, device=dev),
        "w_x": _init(gen, (di, dr + 2 * n), dtype=dt),
        "w_dt": _init(gen, (dr, di), 1.0 / math.sqrt(dr), dtype=dt),
        "dt_bias": torch.full((di,), -2.0, **f32),
        "a_log": torch.log(torch.arange(1, n + 1, **f32)).expand(di, n).contiguous(),
        "d_skip": torch.ones(di, **f32),
        "w_out": _init(gen, (di, d), 1.0 / math.sqrt(di), dtype=dt),
    }


def _causal_conv(w, b, x, state=None):
    """Depthwise causal convolution of window c = len(w) over x (B, S, di),
    continuing from ``state`` (B, c-1, di), the previous c-1 inputs (zeros
    when None); → (y in x's dtype, the last c-1 inputs)."""
    c = w.shape[0]
    if state is None:
        state = x.new_zeros(x.shape[0], c - 1, x.shape[2])
    xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i] for i in range(c)) + b
    new_state = xp[:, s:] if c > 1 else state
    return y.to(x.dtype), new_state


def mamba_apply(cfg: ModelConfig, p, x, *, cache=None, length=None):
    """x (B, S, d) → out (B, S, d).  ``cache`` ``{"conv": (B, c-1, di),
    "h": (B, di, N) fp32}`` carries the decode context and is updated in
    place (the reference returns a new one).  ``length`` ((B,) integer
    tensor) marks positions >= length[i] as padding: their update is the
    identity (dt = 0, x = 0) and the conv state is taken at the true
    boundary, so a bucket-padded prefill leaves the state of a
    length[i]-token prompt.  Counterpart of ``repro/models/blocks.py``'s
    ``mamba_apply``; the scan is ``ops.mamba_scan`` (K8 on the card)."""
    dt_ = x.dtype
    b, s, d = x.shape
    di, n, dr = cfg.d_inner, cfg.ssm_state, cfg.ssm_dt_rank
    conv_w, conv_b = p["conv_w"].to(dt_), p["conv_b"].to(dt_)

    xz = ops.matmul(x.reshape(b * s, d), p["w_in"]).view(b, s, 2 * di)
    xi, z = xz[..., :di], xz[..., di:]
    conv_state = cache["conv"] if cache is not None else None
    boundary = None
    if length is not None:
        pad_keep = (torch.arange(s, device=x.device)[None, :] < length[:, None])[..., None]
        c = conv_w.shape[0]
        if c > 1:
            # the conv window ends at the valid length, not at S
            st = conv_state if conv_state is not None else xi.new_zeros(b, c - 1, di)
            xp = torch.cat([st, xi], dim=1)                        # (B, S+c-1, di)
            idx = length[:, None] + torch.arange(c - 1, device=x.device)[None, :]
            boundary = torch.gather(xp, 1, idx[..., None].expand(b, c - 1, di))
    xi, new_conv = _causal_conv(conv_w, conv_b, xi, conv_state)
    if boundary is not None:
        new_conv = boundary
    xi = tpp.silu(xi)

    proj = ops.matmul(xi.reshape(b * s, di), p["w_x"])             # (B·S, dr + 2N)
    dt_raw = ops.matmul(proj[:, :dr], p["w_dt"])
    dt_v = torch.logaddexp(dt_raw.float() + p["dt_bias"],
                           torch.zeros((), device=x.device)).to(dt_).view(b, s, di)
    proj = proj.view(b, s, dr + 2 * n)
    b_in, c_in = proj[..., dr:dr + n], proj[..., dr + n:]
    if length is not None:
        # dt = 0 makes the state update the identity; x = 0 adds nothing
        dt_v = torch.where(pad_keep, dt_v, 0)
        xi = torch.where(pad_keep, xi, 0)

    a = -torch.exp(p["a_log"])                                      # (di, N) fp32
    h = cache["h"] if cache is not None else None
    y, _ = ops.mamba_scan(xi, dt_v, a, b_in, c_in, p["d_skip"], h0=h, h_out=h)
    y = tpp.mul(y, tpp.silu(z))
    out = ops.matmul(y.reshape(b * s, di), p["w_out"]).view(b, s, d)
    if cache is not None:
        cache["conv"].copy_(new_conv)
    return out
