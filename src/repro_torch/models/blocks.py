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
per-slot positions; the paged pools of the serving engine) and MLP (gated
and plain).  The ring-buffer local cache, MLA, MoE,
mamba and cross-attention branches are still to be ported (ROADMAP.md,
Queue 1).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tpp
from repro_torch.fusion import rng
from repro_torch.kernels import ops

__all__ = ["compute_dtype", "init_norm", "init_attention", "init_mlp",
           "apply_rope", "attention_apply", "mlp_apply", "ATTN_OUT_DROPOUT_SALT"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_CAUSAL_KINDS = ("attn", "local", "global")
# Salt of the attention output-projection dropout: the one the reference's
# fused and unfused paths share (repro/fusion/library.py).
ATTN_OUT_DROPOUT_SALT = rng.derive_salt("fused_attn_out/dropout")


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; see ROADMAP.md, Queue 1")


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _init(gen, shape, scale=None, *, dtype):
    """N(0, 1) * scale (default 1/sqrt(fan_in)), drawn in fp32 on the
    generator's device, stored in ``dtype``."""
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
                    page_table=None, page_size: int = 0, dropout_seed=None):
    """x (B, S, d) → (out (B, S, d), cache).  kind ∈ {attn, local, global,
    bidir}.

    Without a cache: prefill/training attention over the S tokens.  With a
    dense cache ``{"k", "v"}`` of (B, Hk, S_max, hd): ``cache_pos`` is a
    scalar write position (S == 1 decodes against the cache up to
    ``cache_pos + 1``, S > 1 attends over ``[0, cache_pos + S)``), or a
    (B,) tensor of per-slot positions for a one-token decode (continuous
    batching: each slot attends up to its own ``pos + 1``).

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
        if kind == "local" and cfg.sliding_window is not None and smax <= cfg.sliding_window:
            raise _later("the ring-buffer local cache")
        if per_slot:
            if s != 1:
                raise ValueError("per-slot cache positions are decode-only (S == 1)")
            pos = cache_pos
            bidx = torch.arange(b, device=x.device)
            cache["k"][bidx, :, pos] = k[:, :, 0]
            cache["v"][bidx, :, pos] = v[:, :, 0]
            o = ops.decode_attention(q[:, :, 0], cache["k"], cache["v"],
                                     length=pos + 1, window=window)[:, :, None]
        else:
            cache_pos = int(cache_pos)
            cache["k"][:, :, cache_pos:cache_pos + s] = k
            cache["v"][:, :, cache_pos:cache_pos + s] = v
            if s == 1:
                length = torch.full((b,), cache_pos + 1, dtype=torch.int32,
                                    device=x.device)
                o = ops.decode_attention(q[:, :, 0], cache["k"], cache["v"],
                                         length=length, window=window)[:, :, None]
            else:
                end = cache_pos + s
                o = ops.attention(q, cache["k"][:, :, :end], cache["v"][:, :, :end],
                                  causal=causal, window=window)
    o = o.transpose(1, 2).reshape(b * s, h * hd)
    out = ops.matmul(o, p["wo"])
    if dropout_seed is not None and cfg.dropout_rate > 0.0:
        out = rng.dropout(out, dropout_seed, ATTN_OUT_DROPOUT_SALT, cfg.dropout_rate)
    return out.view(b, s, d), cache


# --------------------------------------------------------------------------
# MLP (gated / plain)
# --------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen, dtype=None):
    d, ff = cfg.d_model, cfg.d_ff
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
    """x2d (T, d) → (T, d): GEMM with the activation fused in its epilogue."""
    act = cfg.mlp_activation
    if cfg.gated_mlp:
        g = ops.matmul(x2d, p["wg"], activation=act)
        u = ops.matmul(x2d, p["wu"])
        return ops.matmul(tpp.mul(g, u), p["wd"])
    hid = ops.matmul(x2d, p["wu"], bias=p["bu"], activation=act)
    return ops.matmul(hid, p["wd"], bias=p["bd"])
