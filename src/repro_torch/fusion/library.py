"""The library's fused-layer TppGraphs, ported from
``repro/fusion/library.py``: the same builders, graph names, node names and
operand names.

Single-root graphs: ``fused_output_graph`` (Listing 6: GEMM → bias →
dropout → residual → layernorm), ``fused_mlp_graph`` (GEMM → bias →
activation) and ``fused_attn_out_graph`` (GEMM [→ dropout] [→ +residual]
[→ layernorm/rmsnorm]).  Multi-root graphs: ``fused_gated_mlp_graph``
(act(x @ wg) * (x @ wu), two roots sharing the lhs) and ``fused_qkv_graph``
(one lhs, three rhs, stacked; GQA's k/v at their own width).  A
chained-root graph: ``fused_attention_graph`` (flash attention as IR).

The ``fused_*_apply`` helpers run the graph through
``autodiff.compile_with_vjp``, as the reference's ``_dispatch`` does: the
forward is ``lowering.compile_for_device`` (the composed reference on CPU
tensors, K5's generated kernel on CUDA tensors) and a gradient runs the
derived backward graphs the same way.  They take no ``backend=``: the
device decides.  As the reference's, they take ``vjp`` (False: the forward
alone, ``compile_for_device``) and pass any other keyword on: the schedule
(``spec_string``, ``tiles``, ``block_steps``, ``hw_prng``).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.fusion import rng
from repro_torch.fusion.autodiff import compile_with_vjp
from repro_torch.fusion.lowering import compile_for_device
from repro_torch.fusion.graph import (ContractionRoot, FusionLegalityError, Node,
                                      OperandSpec, TppGraph)

__all__ = [
    "fused_output_graph", "fused_mlp_graph", "fused_gated_mlp_graph",
    "fused_qkv_graph", "fused_attn_out_graph", "fused_attention_graph",
    "fused_output_apply", "fused_mlp_apply", "fused_gated_mlp_apply", "fused_qkv_apply",
    "fused_attn_out_apply", "fused_attention_apply", "OUTPUT_DROPOUT_SALT",
    "ATTN_OUT_DROPOUT_SALT",
]

def _dispatch(graph, vjp, kw):
    return compile_with_vjp(graph, **kw) if vjp else compile_for_device(graph, **kw)


# Per-site PRNG salts, shared with the unfused paths that reproduce a fused
# draw (the same stable strings as the reference).
OUTPUT_DROPOUT_SALT = rng.derive_salt("fused_output/dropout")
ATTN_OUT_DROPOUT_SALT = rng.derive_salt("fused_attn_out/dropout")

@functools.lru_cache(maxsize=None)
def fused_output_graph(dropout_rate: float = 0.0, eps: float = 1e-5,
                       rng_dropout: bool = True,
                       dropout_salt: int = OUTPUT_DROPOUT_SALT) -> TppGraph:
    """x (M,K) @ w (K,N) + bias → dropout → + residual → layernorm(gamma,
    beta): paper Listing 6.  Dropout draws counter-PRNG bits
    (``dropout_rng`` + a scalar ``seed``); ``rng_dropout=False`` builds the
    keep-mask form.  At rate 0 simplification removes the dropout node and
    its operand."""
    if rng_dropout:
        drop = ("dropout_rng", ("seed",),
                {"rate": dropout_rate, "salt": dropout_salt})
        drop_operand = ("seed", "scalar")
    else:
        drop = ("dropout", ("keep_mask",), {"rate": dropout_rate})
        drop_operand = ("keep_mask", "mask")
    return TppGraph.chain(
        "fused_output" if rng_dropout else "fused_output_mask",
        [
            ("bias_add", ("bias",), {}),
            drop,
            ("residual_add", ("residual",), {}),
            ("layernorm", ("gamma", "beta"), {"eps": eps}),
        ],
        [
            ("x", "lhs"), ("w", "rhs"), ("bias", "rowvec"),
            drop_operand, ("residual", "tile"),
            ("gamma", "rowvec"), ("beta", "rowvec"),
        ],
    )


@functools.lru_cache(maxsize=None)
def fused_mlp_graph(activation: str = "gelu") -> TppGraph:
    """x (M,K) @ w (K,N) + bias → activation."""
    return TppGraph.chain(
        f"fused_mlp_{activation}",
        [("bias_add", ("bias",), {}), (activation, (), {})],
        [("x", "lhs"), ("w", "rhs"), ("bias", "rowvec")],
    )


@functools.lru_cache(maxsize=None)
def fused_gated_mlp_graph(activation: str = "silu") -> TppGraph:
    """act(x @ wg) * (x @ wu): two roots sharing the activation lhs."""
    return TppGraph(
        name=f"fused_gated_mlp_{activation}",
        operands=(OperandSpec("x", "lhs"), OperandSpec("wg", "rhs"),
                  OperandSpec("wu", "rhs")),
        roots=(ContractionRoot("g", "x", "wg"),
               ContractionRoot("u", "x", "wu")),
        nodes=(Node("n0_act", activation, ("g",)),
               Node("n1_mul", "mul", ("n0_act", "u"))),
    )


@functools.lru_cache(maxsize=None)
def fused_qkv_graph() -> TppGraph:
    """x @ wq, x @ wk, x @ wv: one lhs, three rhs, stacked (3, M, Nmax);
    narrower k/v (GQA) run at their own width, zero-padded in the stack."""
    return TppGraph(
        name="fused_qkv",
        operands=(OperandSpec("x", "lhs"), OperandSpec("wq", "rhs"),
                  OperandSpec("wk", "rhs"), OperandSpec("wv", "rhs")),
        roots=(ContractionRoot("q", "x", "wq"),
               ContractionRoot("k", "x", "wk"),
               ContractionRoot("v", "x", "wv")),
        outputs=("q", "k", "v"),
    )


@functools.lru_cache(maxsize=None)
def fused_attention_graph(*, causal: bool = True, window: int = 0,
                          scale: float = 1.0, offset: int = 0) -> TppGraph:
    """softmax_online(attn_mask(scale(q @ kᵀ))) @ v as a chained root over
    q (Sq, D), k (Skv, D) stored transposed and v (Skv, D); ``offset`` =
    S_kv - S_q end-aligns the causal diagonal.  Without a mask the mask node
    is omitted."""
    nodes = [Node("n0_scale", "scale", ("s",), (("s", float(scale)),))]
    prev = "n0_scale"
    if causal or window:
        nodes.append(Node("n1_mask", "attn_mask", (prev,),
                          tuple(sorted({"causal": bool(causal),
                                        "offset": int(offset),
                                        "window": int(window)}.items()))))
        prev = "n1_mask"
    nodes.append(Node("n2_softmax", "softmax_online", (prev,)))
    name = ("fused_attention" + ("_causal" if causal else "")
            + (f"_w{window}" if window else "")
            + (f"_off{offset}" if offset else ""))
    return TppGraph(
        name=name,
        operands=(OperandSpec("q", "lhs"), OperandSpec("k", "rhs", trans=True),
                  OperandSpec("v", "crhs")),
        roots=(ContractionRoot("s", "q", "k"),
               ContractionRoot("o", "n2_softmax", "v", chained=True)),
        nodes=tuple(nodes),
        outputs=("o",),
    )


@functools.lru_cache(maxsize=None)
def fused_attn_out_graph(residual: bool = False, norm: str = "",
                         eps: float = 1e-5, dropout_rate: float = 0.0,
                         dropout_salt: int = ATTN_OUT_DROPOUT_SALT
                         ) -> TppGraph:
    """o (M,K) @ wo (K,N) [→ dropout] [+ residual] [→ layernorm/rmsnorm]:
    the attention output projection with its tail fused in."""
    ops, operands = [], [("o", "lhs"), ("wo", "rhs")]
    if dropout_rate > 0.0:
        ops.append(("dropout_rng", ("seed",),
                    {"rate": dropout_rate, "salt": dropout_salt}))
        operands.append(("seed", "scalar"))
    if residual:
        ops.append(("residual_add", ("residual",), {}))
        operands.append(("residual", "tile"))
    if norm == "layernorm":
        ops.append(("layernorm", ("gamma", "beta"), {"eps": eps}))
        operands += [("gamma", "rowvec"), ("beta", "rowvec")]
    elif norm == "rmsnorm":
        ops.append(("rmsnorm", ("gamma",), {"eps": eps}))
        operands.append(("gamma", "rowvec"))
    elif norm:
        raise ValueError(f"unknown norm {norm!r}; use 'layernorm'/'rmsnorm'")
    name = "fused_attn_out" + ("_do" if dropout_rate > 0.0 else "") + \
        ("_res" if residual else "") + (f"_{norm}" if norm else "")
    return TppGraph.chain(name, ops, operands)


def fused_output_apply(x, w, bias, residual, gamma, beta, *, keep_mask=None,
                       dropout_rate: float = 0.0, dropout_seed=None,
                       dropout_salt: int = OUTPUT_DROPOUT_SALT,
                       deterministic: bool = False, eps: float = 1e-5, vjp: bool = True,
                       **kw):
    """Listing 6 in one kernel: layernorm(dropout(x @ w + bias) + residual).
    Dropout draws in-kernel counter bits from a scalar ``dropout_seed``;
    ``deterministic=True`` disables it; a ``keep_mask`` takes the mask
    graph instead.  At rate 0 the simplified graph has neither."""
    rate = 0.0 if deterministic else dropout_rate
    operands = dict(x=x, w=w, bias=bias, residual=residual, gamma=gamma, beta=beta)
    if rate > 0.0 and keep_mask is not None:
        g = fused_output_graph(rate, eps, rng_dropout=False)
        operands["keep_mask"] = keep_mask
    else:
        g = fused_output_graph(rate, eps, dropout_salt=dropout_salt)
        if rate > 0.0:
            if dropout_seed is None:
                raise ValueError(
                    f"fused_output_apply: dropout_rate={dropout_rate} needs a dropout_seed "
                    "for the in-kernel PRNG (or deterministic=True to disable dropout; a "
                    "keep_mask is also accepted)")
            operands["seed"] = dropout_seed
    return _dispatch(g, vjp, kw)(**operands)


def fused_mlp_apply(x, w, bias, *, activation: str = "gelu", vjp: bool = True, **kw):
    """act(x @ w + bias) in one kernel."""
    return _dispatch(fused_mlp_graph(activation), vjp, kw)(x=x, w=w, bias=bias)


def fused_gated_mlp_apply(x, wg, wu, *, activation: str = "silu", vjp: bool = True, **kw):
    """act(x @ wg) * (x @ wu) in one two-root kernel."""
    return _dispatch(fused_gated_mlp_graph(activation), vjp, kw)(x=x, wg=wg, wu=wu)


def fused_qkv_apply(x, wq, wk, wv, *, vjp: bool = True, **kw):
    """``(x @ wq, x @ wk, x @ wv)`` in one three-root kernel, each at its
    projection's own width (GQA: k and v narrower than q).  Weight shapes
    are checked first (one input width K, k and v matching, q's width a
    positive multiple of theirs), with the stable ``TPP214``."""
    shapes = {nm: tuple(w.shape) for nm, w in (("wq", wq), ("wk", wk), ("wv", wv))}
    bad = [nm for nm, s in shapes.items() if len(s) != 2]
    if bad:
        raise FusionLegalityError(
            f"fused_qkv_apply: projection weights must be 2D (K, N); got "
            f"{ {nm: shapes[nm] for nm in bad} }", code="TPP214")
    (kq, nq), (kk, nk), (kv_, nv) = shapes["wq"], shapes["wk"], shapes["wv"]
    if not (kq == kk == kv_) or nk != nv or nk <= 0 or nq % nk:
        raise FusionLegalityError(
            "fused_qkv_apply: inconsistent projection widths — wq "
            f"{shapes['wq']}, wk {shapes['wk']}, wv {shapes['wv']}: q/k/v "
            "must share the input (K) width, k and v must match, and the q "
            "width must be a positive multiple of the kv width (GQA)",
            code="TPP214")
    out = _dispatch(fused_qkv_graph(), vjp, kw)(x=x, wq=wq, wk=wk, wv=wv)
    return out[0], out[1][:, :nk], out[2][:, :nv]


def fused_attention_apply(q, k, v, *, causal: bool = True, window=None, scale=None,
                          vjp: bool = True, **kw):
    """Attention through the chained-root graph, a drop-in for
    ``kernels.ops.attention``: q (B, H, Sq, D), k and v (B, Hk, Skv, D) with
    H % Hk == 0 (GQA kv heads repeated on dim 1, as ``jnp.repeat``).  Every
    (batch, head) pair is one 2-D problem of the graph, as under the
    reference's vmap; a gradient runs the six derived graphs of
    ``autodiff.ChainedBackwardPlan``."""
    b, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    if h % hk:
        raise FusionLegalityError(
            f"fused_attention_apply: query heads ({h}) must be a multiple of kv heads "
            f"({hk})", code="TPP214")
    if hk != h:
        k = torch.repeat_interleave(k, h // hk, dim=1)
        v = torch.repeat_interleave(v, h // hk, dim=1)
    g = fused_attention_graph(
        causal=bool(causal), window=int(window or 0),
        scale=float(scale) if scale is not None else 1.0 / math.sqrt(d), offset=skv - sq)
    return _dispatch(g, vjp, kw)(q=q, k=k, v=v)


def fused_attn_out_apply(o, wo, *, residual=None, gamma=None, beta=None,
                         norm: str = "", eps: float = 1e-5,
                         dropout_rate: float = 0.0, dropout_seed=None,
                         dropout_salt: int = ATTN_OUT_DROPOUT_SALT,
                         deterministic: bool = False, vjp: bool = True, **kw):
    """The attention output projection [+ dropout] [+ residual] [+ norm] in
    one kernel.  Dropout takes a scalar ``dropout_seed`` for the counter
    PRNG, whose bits the derived backward regenerates; ``deterministic=True``
    disables it."""
    need = {"layernorm": ("gamma", "beta"), "rmsnorm": ("gamma",)}.get(norm, ())
    given = {"gamma": gamma, "beta": beta}
    missing = [p for p in need if given[p] is None]
    stray = [p for p, v in given.items() if v is not None and p not in need]
    if missing or stray:
        raise ValueError(
            f"fused_attn_out_apply: norm={norm!r} takes parameters "
            f"{list(need)}; missing {missing}, unused {stray}")
    rate = 0.0 if deterministic else dropout_rate
    if rate > 0.0 and dropout_seed is None:
        raise ValueError(
            f"fused_attn_out_apply: dropout_rate={dropout_rate} needs a "
            "dropout_seed for the in-kernel PRNG (or deterministic=True)")
    g = fused_attn_out_graph(residual is not None, norm, eps, rate, dropout_salt)
    operands = dict(o=o, wo=wo)
    if rate > 0.0:
        operands["seed"] = dropout_seed
    if residual is not None:
        operands["residual"] = residual
    operands.update({p: given[p] for p in need})
    return _dispatch(g, vjp, kw)(**operands)
