"""TppGraph: the declarative IR of TPP-chain fusion (paper §IV-A, Listing 6).

Ported from ``repro/fusion/graph.py``.  A graph is a tuple of **contraction
roots** (GEMMs over flat 2-D operands; roots may share an ``lhs`` operand)
plus an **epilogue DAG** of unary, binary and normalisation TPPs applied to
the roots' fp32 accumulators before anything is written out:

  * ``OperandSpec``: a named graph input whose *kind* fixes its shape role
    against the contraction ``C[M,N] = A[M,K] @ B[K,N]``: ``lhs`` (M, K),
    ``rhs`` (K, N), ``tile`` (M, N), ``mask`` (M, N) bool, ``rowvec`` (N,),
    ``scalar`` () (the ``dropout_rng`` seed) and ``crhs`` (N, N2), a
    chained root's rhs.  ``lhs``/``rhs`` may set ``trans=True``: the array
    is stored transposed and read in place.
  * ``ContractionRoot``: one GEMM ``name = lhs @ rhs``.  All roots share the
    problem shape (M, K, N); a *chained* root consumes the graph's online
    reducer as its lhs (flash attention as IR).
  * ``Node``: one epilogue TPP; its inputs name a root (``"acc"`` is the
    alias of a sole root), an earlier node or an operand.
  * ``TppGraph``: operands + roots + topologically ordered nodes +
    ``outputs``; R > 1 outputs stack to (R, M, N).

Epilogue TPPs come from the registry ``EPILOGUE_OPS``; each ``apply`` is a
torch function on fp32 tensors with the reference's semantics.  The
composed reference path (``fusion.lowering``) runs them on full arrays; the
CUDA code generator (``kernels.fused_gemm``) emits one C++ expression per
op (pointwise ones inline, reducing ones as a row-panel close).  ``grad``
keeps each op's derivative rule as data, the name of a registered op or a
callable rule, which ``fusion.autodiff`` reads to derive backward graphs.

``simplify_graph`` drops ``identity`` and rate-0 dropout nodes and the
operands nothing references any more.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.core import tpp
from repro_torch.core.legality import LegalityError

__all__ = [
    "FusionLegalityError", "OperandSpec", "ContractionRoot", "Node",
    "TppGraph", "EpilogueOp", "EPILOGUE_OPS", "ONLINE_REDUCERS",
    "register_epilogue", "simplify_graph",
]

OPERAND_KINDS = ("lhs", "rhs", "crhs", "tile", "mask", "rowvec", "scalar")


class FusionLegalityError(LegalityError):
    """A TppGraph is malformed or cannot be lowered.  Carries a stable
    ``.code`` (``TPP2xx``, the reference's catalog) so tests pin the
    diagnostic, not the message."""


@dataclasses.dataclass(frozen=True)
class OperandSpec:
    name: str
    kind: str
    trans: bool = False     # lhs/rhs only: array stored transposed

    def __post_init__(self):
        if self.kind not in OPERAND_KINDS:
            raise FusionLegalityError(
                f"operand {self.name!r}: unknown kind {self.kind!r}; "
                f"expected one of {OPERAND_KINDS}", code="TPP210")
        if self.trans and self.kind not in ("lhs", "rhs"):
            raise FusionLegalityError(
                f"operand {self.name!r}: trans=True only applies to "
                f"contraction operands (lhs/rhs), not {self.kind!r}",
                code="TPP210")


@dataclasses.dataclass(frozen=True)
class ContractionRoot:
    """One GEMM root ``name = lhs @ rhs``.  A chained root (``chained=True``)
    takes the graph's online reducer as its lhs and a ``crhs`` operand
    (N, N2) as its rhs."""

    name: str
    lhs: str
    rhs: str
    chained: bool = False


@dataclasses.dataclass(frozen=True)
class Node:
    """One epilogue TPP application: ``inputs`` are value names, ``attrs``
    static parameters as a sorted key/value tuple."""

    name: str
    op: str
    inputs: tuple[str, ...]
    attrs: tuple[tuple[str, Any], ...] = ()

    def attr_dict(self) -> dict:
        return dict(self.attrs)


# ---------------------------------------------------------------------------
# Epilogue op registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EpilogueOp:
    """A registered epilogue TPP.

    ``value_arity``    how many leading inputs are values (roots, nodes,
                       ``tile``/``mask`` operands);
    ``operand_kinds``  kinds of the trailing inputs, which must be operands;
    ``reduces``        None for pointwise ops, ``"n"`` for a reduction over
                       the feature axis (needs the whole row);
    ``apply``          fp32 semantics on torch tensors;
    ``flops_per_elem`` rough flop count per output element;
    ``grad``           None, the name of a registered derivative op, or a
                       callable rule ``rule(sweep, node, dv)``;
    ``stats_input``    for reducing ops, the value input whose row
                       (sum, sum-of-squares) a row-panel lowering streams;
    ``wants_offsets``  ``apply`` takes ``_offsets=(row0, col0)``, the global
                       coordinates of the tile it runs on.

    A named grad op takes the forward op's operand kinds and either its
    value arity (dv replaces the primal value) or one more (dv first);
    ``register_epilogue`` checks that whichever side registers second.
    """

    name: str
    value_arity: int
    operand_kinds: tuple[str, ...]
    apply: Callable
    reduces: Optional[str] = None
    flops_per_elem: float = 1.0
    grad: Any = None
    stats_input: Optional[int] = None
    wants_offsets: bool = False


EPILOGUE_OPS: dict[str, EpilogueOp] = {}


def _check_grad_arity(fwd: EpilogueOp, gop: EpilogueOp):
    ok_arity = gop.value_arity in (fwd.value_arity, fwd.value_arity + 1)
    if not ok_arity or gop.operand_kinds != fwd.operand_kinds:
        raise FusionLegalityError(
            f"epilogue op {fwd.name!r}: grad op {gop.name!r} disagrees with "
            f"its forward op — expected value_arity {fwd.value_arity} "
            f"(dv substitution) or {fwd.value_arity + 1} (dv prepended) with "
            f"operand_kinds {fwd.operand_kinds}, got value_arity "
            f"{gop.value_arity} / operand_kinds {gop.operand_kinds}",
            code="TPP204")


def register_epilogue(op: EpilogueOp, *, override: bool = False):
    """Register ``op`` under its name; re-registering a name needs
    ``override=True``.  Every check runs before the registry changes."""
    if op.name in EPILOGUE_OPS and not override:
        raise FusionLegalityError(
            f"epilogue op {op.name!r} is already registered; pass "
            "override=True to replace it deliberately")
    if isinstance(op.grad, str) and op.grad in EPILOGUE_OPS:
        _check_grad_arity(op, EPILOGUE_OPS[op.grad])
    for other in EPILOGUE_OPS.values():
        if isinstance(other.grad, str) and other.grad == op.name:
            _check_grad_arity(other, op)
    EPILOGUE_OPS[op.name] = op
    return op


def _f32(x):
    return x.float()


def _fp32_scale(rate: float) -> float:
    """1 / (1 - rate) rounded to fp32, as the reference's
    ``jnp.float32(1.0 / (1.0 - rate))``."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def _dropout_apply(v, mask, *, rate: float = 0.0):
    # the rescale runs in fp32 whatever the value's dtype
    if rate <= 0.0:
        return v
    return torch.where(mask.bool(), v.float() * _fp32_scale(rate),
                       torch.zeros((), device=v.device))


def _dropout_rng_apply(v, seed, *, rate: float = 0.0, salt: int = 0,
                       _offsets=(0, 0), _impl: str = "counter", _tile=None):
    """Counter-based dropout: keep bits regenerated from (seed, salt,
    element coordinates), no mask operand; exact integer threshold, fp32
    rescale.  ``_impl="hw"`` draws K13's per-tile Philox bits instead
    (``rng.hw_tile_bits``): ``v`` is one tile at ``_offsets``, or, with
    ``_tile`` (rows, columns), a whole problem cut into such tiles from
    (0, 0), as a plan cuts it."""
    from repro_torch.fusion import rng
    if rate <= 0.0:
        return v
    if _impl not in ("counter", "hw"):
        raise ValueError(f"dropout_rng: unknown _impl {_impl!r}")
    if isinstance(seed, torch.Tensor):
        seed = seed.reshape(())
    # a batched value keys each 2-D problem on its own coordinates
    shape = tuple(v.shape[-2:])
    if _impl == "counter":
        bits = rng.tile_bits(seed, salt, shape, offsets=_offsets, device=v.device)
    elif _tile is None:
        bits = rng.hw_tile_bits(seed, salt, shape, offsets=_offsets, device=v.device)
    else:
        bits = rng.hw_bits(seed, salt, shape, _tile, device=v.device)
    keep = bits < rng.keep_threshold(rate)
    return torch.where(keep, v.float() * _fp32_scale(rate),
                       torch.zeros((), device=v.device))


def _mean(v):
    return v.mean(dim=-1, keepdim=True)


def _layernorm_apply(v, gamma, beta, *, eps: float = 1e-5):
    mu = _mean(v)
    var = _mean((v - mu).square())
    y = (v - mu) * torch.rsqrt(var + eps)
    return y * _f32(gamma) + _f32(beta)


def _rmsnorm_apply(v, gamma, *, eps: float = 1e-6):
    ms = _mean(v.square())
    return v * torch.rsqrt(ms + eps) * _f32(gamma)


def _softmax_apply(v):
    m = v.amax(dim=-1, keepdim=True)
    e = torch.exp(v - m)
    return e / e.sum(dim=-1, keepdim=True)


# Masked-out attention scores: a large negative finite value (exp(-inf -
# -inf) would be NaN on a fully masked row); a streaming lowering treats
# anything below the floor as masked.
_NEG_INF = -1e30
_MASK_FLOOR = -1e29


def _attn_keep(shape, device, *, causal, window, offset, offsets):
    r0, c0 = offsets
    rows = r0 + offset + torch.arange(shape[-2], device=device)[:, None]
    cols = c0 + torch.arange(shape[-1], device=device)[None, :]
    keep = torch.ones(tuple(shape[-2:]), dtype=torch.bool, device=device)
    if causal:
        keep = keep & (cols <= rows)
    if window:
        keep = keep & (cols > rows - window)
    return keep


def _attn_mask_apply(v, *, causal: bool = True, window: int = 0,
                     offset: int = 0, _offsets=(0, 0)):
    """Causal / sliding-window score mask on global coordinates: row i
    (shifted by ``offset`` = S_kv - S_q) keeps column j iff j <= i + offset
    (causal) and j > i + offset - window (window > 0).  Leading batch axes
    share the mask of the last two."""
    keep = _attn_keep(v.shape, v.device, causal=causal, window=window,
                      offset=offset, offsets=_offsets)
    return torch.where(keep, v, torch.full((), _NEG_INF, device=v.device))


def _attn_mask_grad_apply(dv, *, causal: bool = True, window: int = 0,
                          offset: int = 0, _offsets=(0, 0)):
    keep = _attn_keep(dv.shape, dv.device, causal=causal, window=window,
                      offset=offset, offsets=_offsets)
    return torch.where(keep, dv, torch.zeros((), device=dv.device))


# --- derivative TPP semantics (fp32, full-row for the reducing ones) -------

def _relu_grad_apply(dv, x):
    return dv * (x > 0.0)


def _gelu_grad_apply(dv, x):
    return tpp.activation_grad("gelu", dv, x).to(dv.dtype)


def _silu_grad_apply(dv, x):
    s = torch.sigmoid(x)
    return dv * s * (1.0 + x * (1.0 - s))


def _sigmoid_grad_apply(dv, x):
    s = torch.sigmoid(x)
    return dv * s * (1.0 - s)


def _layernorm_grad_apply(dv, z, gamma, *, eps: float = 1e-5):
    mu = _mean(z)
    var = _mean((z - mu).square())
    rstd = torch.rsqrt(var + eps)
    xhat = (z - mu) * rstd
    g = dv * _f32(gamma)
    return rstd * (g - _mean(g) - xhat * _mean(g * xhat))


def _layernorm_gamma_grad_apply(dv, z, *, eps: float = 1e-5):
    mu = _mean(z)
    var = _mean((z - mu).square())
    return dv * (z - mu) * torch.rsqrt(var + eps)


def _rmsnorm_grad_apply(dv, z, gamma, *, eps: float = 1e-6):
    r = torch.rsqrt(_mean(z.square()) + eps)
    g = dv * _f32(gamma)
    n = z.shape[-1]
    return r * g - (r ** 3) * z * ((g * z).sum(dim=-1, keepdim=True) / n)


def _rmsnorm_gamma_grad_apply(dv, z, *, eps: float = 1e-6):
    return dv * z * torch.rsqrt(_mean(z.square()) + eps)


def _softmax_grad_apply(dv, z):
    p = _softmax_apply(z)
    return p * (dv - (dv * p).sum(dim=-1, keepdim=True))


# --- callable grad rules (kept as data for the autodiff port) --------------
# A rule returns [(input_ref, cotangent_value_name), ...]; the sweep object
# exposes ``emit(op, inputs, attrs) -> name`` for new backward nodes.

def _grad_add(sweep, node, dv):
    return [(node.inputs[0], dv), (node.inputs[1], dv)]


def _grad_sub(sweep, node, dv):
    neg = sweep.emit("scale", (dv,), {"s": -1.0})
    return [(node.inputs[0], dv), (node.inputs[1], neg)]


def _grad_mul(sweep, node, dv):
    a, b = node.inputs
    return [(a, sweep.emit("mul", (dv, b))),
            (b, sweep.emit("mul", (dv, a)))]


def _grad_residual_add(sweep, node, dv):
    return [(node.inputs[0], dv), (node.inputs[1], dv)]


def _grad_bias_add(sweep, node, dv):
    return [(node.inputs[0], dv), (node.inputs[1], dv)]


def _grad_scale_rowvec(sweep, node, dv):
    v, s = node.inputs
    return [(v, sweep.emit("scale_rowvec", (dv, s))),
            (s, sweep.emit("mul", (dv, v)))]


def _grad_layernorm(sweep, node, dv):
    v, gamma, beta = node.inputs
    attrs = node.attr_dict()
    dz = sweep.emit("layernorm_grad", (dv, v, gamma), attrs)
    dgamma = sweep.emit("layernorm_gamma_grad", (dv, v), attrs)
    return [(v, dz), (gamma, dgamma), (beta, dv)]


def _grad_rmsnorm(sweep, node, dv):
    v, gamma = node.inputs
    attrs = node.attr_dict()
    return [(v, sweep.emit("rmsnorm_grad", (dv, v, gamma), attrs)),
            (gamma, sweep.emit("rmsnorm_gamma_grad", (dv, v), attrs))]


def _grad_softmax(sweep, node, dv):
    v = node.inputs[0]
    return [(v, sweep.emit("softmax_grad", (dv, v)))]


# Pointwise unary TPPs.
register_epilogue(EpilogueOp("identity", 1, (), lambda v: v,
                             flops_per_elem=0.0, grad="identity"))
register_epilogue(EpilogueOp("relu", 1, (), lambda v: torch.clamp_min(v, 0.0),
                             grad="relu_grad"))
register_epilogue(EpilogueOp("gelu", 1, (), tpp.gelu, flops_per_elem=10.0,
                             grad="gelu_grad"))
register_epilogue(EpilogueOp("silu", 1, (), tpp.silu, flops_per_elem=5.0,
                             grad="silu_grad"))
register_epilogue(EpilogueOp("sigmoid", 1, (), torch.sigmoid, flops_per_elem=4.0,
                             grad="sigmoid_grad"))
register_epilogue(EpilogueOp(
    "scale", 1, (), lambda v, *, s: v * s, flops_per_elem=1.0, grad="scale"))

# Binary TPPs over two (M, N) values.
register_epilogue(EpilogueOp("add", 2, (), lambda a, b: a + b, grad=_grad_add))
register_epilogue(EpilogueOp("sub", 2, (), lambda a, b: a - b, grad=_grad_sub))
register_epilogue(EpilogueOp("mul", 2, (), lambda a, b: a * b, grad=_grad_mul))
register_epilogue(EpilogueOp(
    "residual_add", 1, ("tile",), lambda v, r: v + _f32(r),
    grad=_grad_residual_add))

# Row-broadcast vector TPPs.
register_epilogue(EpilogueOp(
    "bias_add", 1, ("rowvec",), lambda v, b: v + _f32(b), grad=_grad_bias_add))
register_epilogue(EpilogueOp(
    "scale_rowvec", 1, ("rowvec",), lambda v, s: v * _f32(s),
    grad=_grad_scale_rowvec))

# Masked dropout (a keep-mask operand); self-adjoint.
register_epilogue(EpilogueOp(
    "dropout", 1, ("mask",), _dropout_apply, flops_per_elem=2.0,
    grad="dropout_grad"))

# Counter-based dropout: a scalar seed operand, bits from (seed, salt,
# element coordinates).
register_epilogue(EpilogueOp(
    "dropout_rng", 1, ("scalar",), _dropout_rng_apply, flops_per_elem=28.0,
    grad="dropout_rng_grad", wants_offsets=True))

# Normalisations over the feature axis: row-panel epilogues.
register_epilogue(EpilogueOp(
    "layernorm", 1, ("rowvec", "rowvec"), _layernorm_apply,
    reduces="n", flops_per_elem=6.0, grad=_grad_layernorm, stats_input=0))
register_epilogue(EpilogueOp(
    "rmsnorm", 1, ("rowvec",), _rmsnorm_apply, reduces="n",
    flops_per_elem=4.0, grad=_grad_rmsnorm, stats_input=0))
register_epilogue(EpilogueOp(
    "softmax", 1, (), _softmax_apply, reduces="n", flops_per_elem=7.0,
    grad=_grad_softmax))

# Online softmax: the reducer a chained root consumes (same full-row
# semantics as ``softmax``).
register_epilogue(EpilogueOp(
    "softmax_online", 1, (), _softmax_apply, reduces="n", flops_per_elem=9.0,
    grad=_grad_softmax, stats_input=0))

# Coordinate-keyed attention score mask (causal / sliding window).
register_epilogue(EpilogueOp(
    "attn_mask", 1, (), _attn_mask_apply, flops_per_elem=4.0,
    grad="attn_mask_grad", wants_offsets=True))
register_epilogue(EpilogueOp(
    "attn_mask_grad", 1, (), _attn_mask_grad_apply, flops_per_elem=4.0,
    wants_offsets=True))

#: Reducing ops whose recurrence a chained lowering streams.
ONLINE_REDUCERS = frozenset({"softmax_online"})

# Derivative TPPs: the pointwise ones take (dv, primal input); the reducing
# ones recompute the row statistics of their primal input.
register_epilogue(EpilogueOp("relu_grad", 2, (), _relu_grad_apply,
                             flops_per_elem=2.0))
register_epilogue(EpilogueOp("gelu_grad", 2, (), _gelu_grad_apply,
                             flops_per_elem=14.0))
register_epilogue(EpilogueOp("silu_grad", 2, (), _silu_grad_apply,
                             flops_per_elem=8.0))
register_epilogue(EpilogueOp("sigmoid_grad", 2, (), _sigmoid_grad_apply,
                             flops_per_elem=6.0))
register_epilogue(EpilogueOp("dropout_grad", 1, ("mask",), _dropout_apply,
                             flops_per_elem=2.0))
register_epilogue(EpilogueOp(
    "dropout_rng_grad", 1, ("scalar",), _dropout_rng_apply,
    flops_per_elem=28.0, wants_offsets=True))
register_epilogue(EpilogueOp(
    "layernorm_grad", 2, ("rowvec",), _layernorm_grad_apply, reduces="n",
    flops_per_elem=12.0, stats_input=1))
register_epilogue(EpilogueOp(
    "layernorm_gamma_grad", 2, (), _layernorm_gamma_grad_apply, reduces="n",
    flops_per_elem=8.0, stats_input=1))
register_epilogue(EpilogueOp(
    "rmsnorm_grad", 2, ("rowvec",), _rmsnorm_grad_apply, reduces="n",
    flops_per_elem=10.0, stats_input=1))
register_epilogue(EpilogueOp(
    "rmsnorm_gamma_grad", 2, (), _rmsnorm_gamma_grad_apply, reduces="n",
    flops_per_elem=6.0, stats_input=1))
register_epilogue(EpilogueOp(
    "softmax_grad", 2, (), _softmax_grad_apply, reduces="n",
    flops_per_elem=10.0))


# ---------------------------------------------------------------------------
# The graph
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TppGraph:
    """Contraction roots + an epilogue DAG of TPP nodes.

    ``roots`` defaults to the single root ``acc = lhs @ rhs`` of the unique
    lhs/rhs operands; ``outputs`` defaults to the last node's value (or the
    sole root); several outputs stack on a leading axis.
    """

    name: str
    operands: tuple[OperandSpec, ...]
    nodes: tuple[Node, ...] = ()
    roots: tuple[ContractionRoot, ...] = ()
    outputs: tuple[str, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "operands", tuple(self.operands))
        object.__setattr__(self, "nodes", tuple(self.nodes))
        if not self.roots:
            lhs = [o.name for o in self.operands if o.kind == "lhs"]
            rhs = [o.name for o in self.operands if o.kind == "rhs"]
            if len(lhs) != 1 or len(rhs) != 1:
                raise FusionLegalityError(
                    f"graph {self.name!r}: without explicit roots the graph "
                    f"needs exactly one lhs and one rhs operand, got "
                    f"{len(lhs)} lhs / {len(rhs)} rhs — declare roots=",
                    code="TPP201")
            object.__setattr__(
                self, "roots", (ContractionRoot("acc", lhs[0], rhs[0]),))
        else:
            object.__setattr__(self, "roots", tuple(self.roots))
        if not self.outputs:
            last = self.nodes[-1].name if self.nodes else self.roots[0].name
            object.__setattr__(self, "outputs", (last,))
        else:
            object.__setattr__(self, "outputs", tuple(self.outputs))
        self.validate()

    # -- views ----------------------------------------------------------
    def operand(self, name: str) -> OperandSpec:
        for o in self.operands:
            if o.name == name:
                return o
        raise KeyError(name)

    def root(self, name: str) -> ContractionRoot:
        for r in self.roots:
            if r.name == name:
                return r
        raise KeyError(name)

    @property
    def lhs(self) -> OperandSpec:
        """The first root's lhs operand."""
        return self.operand(self.roots[0].lhs)

    @property
    def rhs(self) -> OperandSpec:
        """The first root's rhs operand."""
        return self.operand(self.roots[0].rhs)

    @property
    def contraction_operands(self) -> tuple[OperandSpec, ...]:
        """lhs/rhs/crhs operands in root-declaration order, each shared
        operand once (a chained root contributes only its rhs)."""
        seen: dict[str, OperandSpec] = {}
        for r in self.roots:
            for nm in ((r.rhs,) if r.chained else (r.lhs, r.rhs)):
                if nm not in seen:
                    seen[nm] = self.operand(nm)
        return tuple(seen.values())

    @property
    def epilogue_operands(self) -> tuple[OperandSpec, ...]:
        return tuple(o for o in self.operands
                     if o.kind not in ("lhs", "rhs", "crhs"))

    def chained_root(self) -> Optional[ContractionRoot]:
        for r in self.roots:
            if r.chained:
                return r
        return None

    @property
    def base_roots(self) -> tuple[ContractionRoot, ...]:
        """The non-chained roots, which the shared (M, K, N) nest carries."""
        return tuple(r for r in self.roots if not r.chained)

    def reducing_node(self) -> Optional[Node]:
        for nd in self.nodes:
            if EPILOGUE_OPS[nd.op].reduces is not None:
                return nd
        return None

    def post_reduce_nodes(self) -> tuple[Node, ...]:
        """Pointwise nodes after the reducing node (empty without one)."""
        red = self.reducing_node()
        if red is None:
            return ()
        idx = self.nodes.index(red)
        return self.nodes[idx + 1:]

    def staged_values(self) -> tuple[str, ...]:
        """Computed value inputs of the reducing node: the row panels a
        row-panel lowering stages so the reduction sees whole rows."""
        red = self.reducing_node()
        if red is None:
            return ()
        return self.staged_values_of(red, self.nodes.index(red))

    def staged_values_of(self, red: Node, idx: int) -> tuple[str, ...]:
        op = EPILOGUE_OPS[red.op]
        computed = set(self.root_names) | {nd.name for nd in self.nodes[:idx]}
        if len(self.roots) == 1:
            computed.add("acc")
        return tuple(dict.fromkeys(
            r for r in red.inputs[:op.value_arity] if r in computed))

    def row_resident_operands(self) -> frozenset[str]:
        """tile/mask operands read by the reducing node or a post-reduce
        node: they must be visible as whole rows."""
        red = self.reducing_node()
        if red is None:
            return frozenset()
        names = set()
        idx = self.nodes.index(red)
        for nd in self.nodes[idx:]:
            for ref in nd.inputs:
                try:
                    spec = self.operand(ref)
                except KeyError:
                    continue
                if spec.kind in ("tile", "mask"):
                    names.add(ref)
        return frozenset(names)

    @property
    def operand_names(self) -> tuple[str, ...]:
        return tuple(o.name for o in self.operands)

    @property
    def root_names(self) -> tuple[str, ...]:
        return tuple(r.name for r in self.roots)

    def resolve_acc(self, ref: str) -> str:
        """Map the ``"acc"`` alias to the sole root's name."""
        if ref == "acc" and len(self.roots) == 1:
            return self.roots[0].name
        return ref

    def epilogue_flops_per_elem(self) -> float:
        return float(sum(EPILOGUE_OPS[nd.op].flops_per_elem for nd in self.nodes))

    # -- validation ------------------------------------------------------
    def validate(self):
        names = [o.name for o in self.operands]
        if len(set(names)) != len(names):
            raise FusionLegalityError(
                f"graph {self.name!r}: duplicate operand names",
                code="TPP211")

        root_names = [r.name for r in self.roots]
        if len(set(root_names)) != len(root_names):
            raise FusionLegalityError(
                f"graph {self.name!r}: duplicate root names {root_names}",
                code="TPP211")
        chained = [r for r in self.roots if r.chained]
        for r in self.roots:
            if r.name in names or (r.name == "acc" and len(self.roots) > 1):
                raise FusionLegalityError(
                    f"graph {self.name!r}: root name {r.name!r} shadows an "
                    "operand or the single-root 'acc' alias", code="TPP211")
            sides = ((("rhs", r.rhs, "crhs"),) if r.chained
                     else (("lhs", r.lhs, "lhs"), ("rhs", r.rhs, "rhs")))
            for side, nm, kind in sides:
                try:
                    spec = self.operand(nm)
                except KeyError:
                    raise FusionLegalityError(
                        f"graph {self.name!r}: root {r.name!r} {side} operand "
                        f"{nm!r} is not declared", code="TPP201") from None
                if spec.kind != kind:
                    raise FusionLegalityError(
                        f"graph {self.name!r}: root {r.name!r} {side} operand "
                        f"{nm!r} must have kind {kind!r}, got {spec.kind!r}",
                        code="TPP213" if kind == "crhs" else "TPP210")
        if len(chained) > 1:
            raise FusionLegalityError(
                f"graph {self.name!r}: at most one chained root per graph "
                f"(one chain accumulator + statistics strip), got "
                f"{[r.name for r in chained]}", code="TPP212")
        if chained and len(self.roots) == len(chained):
            raise FusionLegalityError(
                f"graph {self.name!r}: a chained root needs at least one "
                "base root to consume — nothing produces the reduced panel",
                code="TPP212")
        rooted = {nm for r in self.roots
                  for nm in ((r.rhs,) if r.chained else (r.lhs, r.rhs))}
        for o in self.operands:
            if o.kind in ("lhs", "rhs") and o.name not in rooted:
                raise FusionLegalityError(
                    f"graph {self.name!r}: {o.kind} operand {o.name!r} is not "
                    "referenced by any contraction root", code="TPP201")
            if o.kind == "crhs" and o.name not in rooted:
                raise FusionLegalityError(
                    f"graph {self.name!r}: crhs operand {o.name!r} is not "
                    "consumed by any chained root — crhs operands exist only "
                    "as chained-contraction rhs", code="TPP213")

        visible = set(names) | set(root_names)
        if len(self.roots) == 1:
            visible.add("acc")
        reduce_node: Optional[Node] = None
        post_visible: set[str] = set()   # values a post-reduce node may read
        for i, nd in enumerate(self.nodes):
            op = EPILOGUE_OPS.get(nd.op)
            if op is None:
                raise FusionLegalityError(
                    f"graph {self.name!r}: node {nd.name!r} uses unregistered "
                    f"epilogue op {nd.op!r}", code="TPP209")
            want = op.value_arity + len(op.operand_kinds)
            if len(nd.inputs) != want:
                raise FusionLegalityError(
                    f"graph {self.name!r}: node {nd.name!r} ({nd.op}) takes "
                    f"{want} inputs, got {len(nd.inputs)}", code="TPP204")
            for ref in nd.inputs:
                if ref not in visible:
                    raise FusionLegalityError(
                        f"graph {self.name!r}: node {nd.name!r} references "
                        f"unknown value {ref!r} (nodes must be topologically "
                        "ordered)", code="TPP201")
            for ref, kind in zip(nd.inputs[op.value_arity:], op.operand_kinds):
                try:
                    spec = self.operand(ref)
                except KeyError:
                    raise FusionLegalityError(
                        f"graph {self.name!r}: node {nd.name!r} ({nd.op}) "
                        f"input {ref!r} must be a graph operand of kind "
                        f"{kind!r}", code="TPP210") from None
                if spec.kind != kind:
                    raise FusionLegalityError(
                        f"graph {self.name!r}: node {nd.name!r} ({nd.op}) "
                        f"expects a {kind!r} operand, {ref!r} is "
                        f"{spec.kind!r}", code="TPP210")
            if reduce_node is not None:
                # post-reduce band: pointwise nodes on the finished rows may
                # read operands, the reducing value, its staged inputs and
                # later post-reduce values only
                if op.reduces is not None:
                    raise FusionLegalityError(
                        f"graph {self.name!r}: node {nd.name!r} ({nd.op}) — "
                        "at most one reducing epilogue per graph (one row "
                        "panel + statistics strip)", code="TPP202")
                for ref in nd.inputs[:op.value_arity]:
                    if ref not in post_visible and ref not in names:
                        raise FusionLegalityError(
                            f"graph {self.name!r}: post-reduce node "
                            f"{nd.name!r} ({nd.op}) references {ref!r}, "
                            "which is not full-row resident after the "
                            f"reducing node ({reduce_node.op}) closes — only "
                            "operands, the reducing value, its staged "
                            "inputs, and later post-reduce values are",
                            code="TPP206")
                post_visible.add(nd.name)
            elif op.reduces is not None:
                reduce_node = nd
                post_visible = {nd.name, *self.staged_values_of(nd, i)}
            if nd.name in visible:
                raise FusionLegalityError(
                    f"graph {self.name!r}: node name {nd.name!r} shadows an "
                    "earlier value", code="TPP211")
            visible.add(nd.name)

        # crhs operands feed chained roots only
        for nd in self.nodes:
            op = EPILOGUE_OPS[nd.op]
            for ref in nd.inputs[:op.value_arity]:
                try:
                    spec = self.operand(ref)
                except KeyError:
                    continue
                if spec.kind == "crhs":
                    raise FusionLegalityError(
                        f"graph {self.name!r}: node {nd.name!r} consumes "
                        f"crhs operand {ref!r} as a value — crhs operands "
                        "are chained-contraction rhs only", code="TPP213")

        ch = chained[0] if chained else None
        if ch is not None:
            if self.roots[-1] is not ch:
                raise FusionLegalityError(
                    f"graph {self.name!r}: chained root {ch.name!r} must be "
                    "declared after every base root — it consumes their "
                    "reduced panel", code="TPP212")
            if reduce_node is None or ch.lhs != reduce_node.name:
                raise FusionLegalityError(
                    f"graph {self.name!r}: chained root {ch.name!r} lhs "
                    f"{ch.lhs!r} must name the graph's reducing node"
                    + (f" ({reduce_node.name!r})" if reduce_node is not None
                       else " — the graph has none"), code="TPP212")
            if reduce_node.op not in ONLINE_REDUCERS:
                raise FusionLegalityError(
                    f"graph {self.name!r}: chained root {ch.name!r} consumes "
                    f"reducer {reduce_node.op!r}, which has no streaming "
                    f"(running max, running sum) recurrence — online "
                    f"reducers: {sorted(ONLINE_REDUCERS)}", code="TPP212")
            if self.nodes[-1] is not reduce_node:
                raise FusionLegalityError(
                    f"graph {self.name!r}: chained root {ch.name!r} — no "
                    "post-reduce nodes allowed: the reduced panel is never "
                    "materialized, it streams straight into the chain "
                    "accumulator", code="TPP212")
            if self.outputs != (ch.name,):
                raise FusionLegalityError(
                    f"graph {self.name!r}: a chained graph's only output is "
                    f"the chained root ({ch.name!r}); base accumulators and "
                    f"the reduced panel are never materialized — got outputs "
                    f"{self.outputs}", code="TPP212")
            for nd in self.nodes:
                if ch.name in nd.inputs:
                    raise FusionLegalityError(
                        f"graph {self.name!r}: node {nd.name!r} reads chained "
                        f"root {ch.name!r} — the chain accumulator closes "
                        "only at the final N visit, after every node has "
                        "run", code="TPP212")

        # outputs: computed values only; in a reducing graph, the reducing
        # value or post-reduce values
        if len(set(self.outputs)) != len(self.outputs):
            raise FusionLegalityError(
                f"graph {self.name!r}: duplicate outputs {self.outputs}",
                code="TPP211")
        computed = visible - set(names)
        for ref in self.outputs:
            if ref not in computed:
                raise FusionLegalityError(
                    f"graph {self.name!r}: output {ref!r} names no root, "
                    "node, or the 'acc' alias", code="TPP208")
            if ch is not None and ref == ch.name:
                continue
            if reduce_node is not None and ref not in post_visible:
                raise FusionLegalityError(
                    f"graph {self.name!r}: output {ref!r} is not full-row "
                    f"resident when the reducing epilogue "
                    f"({reduce_node.op}) closes — outputs of a reducing "
                    "graph must be the reducing value or post-reduce values",
                    code="TPP208")

    # -- convenience builder --------------------------------------------
    @classmethod
    def chain(cls, name: str, ops: list, operands: list) -> "TppGraph":
        """A straight-line graph: each entry of ``ops`` is ``(op_name,
        extra_input_names, attrs_dict)`` (or just the op name), chained on
        the previous value starting from ``"acc"``."""
        specs = tuple(OperandSpec(n, k) for n, k in operands)
        nodes, prev = [], "acc"
        for i, entry in enumerate(ops):
            if isinstance(entry, str):
                op_name, extra, attrs = entry, (), {}
            else:
                op_name, extra, attrs = entry
            nd = Node(name=f"n{i}_{op_name}", op=op_name, inputs=(prev, *extra),
                      attrs=tuple(sorted(attrs.items())))
            nodes.append(nd)
            prev = nd.name
        return cls(name=name, operands=specs, nodes=tuple(nodes))

    def describe(self) -> str:
        out = [f"TppGraph {self.name!r}:"]
        for r in self.roots:
            def t(nm):
                try:
                    return nm + "^T" if self.operand(nm).trans else nm
                except KeyError:
                    return nm   # chained lhs: a computed value
            kind = "chain_gemm" if r.chained else "gemm"
            out.append(f"  {r.name} = {kind}({t(r.lhs)}, {t(r.rhs)})")
        for nd in self.nodes:
            attrs = ", ".join(f"{k}={v}" for k, v in nd.attrs)
            out.append(
                f"  {nd.name} = {nd.op}({', '.join(nd.inputs)}"
                + (f"; {attrs}" if attrs else "") + ")")
        ret = ", ".join(self.outputs)
        out.append(f"  return {'stack(' + ret + ')' if len(self.outputs) > 1 else ret}")
        return "\n".join(out)


# ---------------------------------------------------------------------------
# Graph simplification, run by ``fusion.compile`` before lowering
# ---------------------------------------------------------------------------

def _node_is_noop(nd: Node) -> bool:
    if nd.op == "identity":
        return True
    if nd.op in ("dropout", "dropout_rng"):
        return float(nd.attr_dict().get("rate", 0.0)) <= 0.0
    return False


def simplify_graph(graph: TppGraph) -> TppGraph:
    """Drop no-op nodes (``identity``, rate-0 ``dropout``/``dropout_rng``)
    and operands no node, root or output references any more; a dropped
    node forwards its value input.  A no-op that is itself an output stays.
    Returns ``graph`` itself when there is nothing to do."""
    repl: dict[str, str] = {}
    kept: list[Node] = []
    for nd in graph.nodes:
        inputs = tuple(repl.get(r, r) for r in nd.inputs)
        if _node_is_noop(nd) and nd.name not in graph.outputs:
            repl[nd.name] = inputs[0]
            continue
        kept.append(nd if inputs == nd.inputs
                    else dataclasses.replace(nd, inputs=inputs))
    outputs = tuple(repl.get(r, r) for r in graph.outputs)

    referenced = {nm for r in graph.roots for nm in (r.lhs, r.rhs)}
    referenced.update(outputs)
    for nd in kept:
        referenced.update(nd.inputs)
    operands = tuple(o for o in graph.operands if o.name in referenced)

    if (len(kept) == len(graph.nodes) and operands == graph.operands
            and outputs == graph.outputs):
        return graph
    return TppGraph(name=graph.name, operands=operands, nodes=tuple(kept),
                    roots=graph.roots, outputs=outputs)
