"""Tensor Processing Primitives (TPP): the paper's 2D-tile operator
collection, in PyTorch.

A port of ``repro/core/tpp.py``, whole.  As there, every primitive is
precision-aware (paper §II-C): low-precision inputs accumulate and
normalize in fp32 and cast on the way out, so the same layer code serves
fp32 and bf16.  Two differences: ``dropout`` draws from a
``torch.Generator``, whose bits cannot equal ``jax.random.bernoulli``'s;
and the norms take their means through ``_row_mean``, a pairwise sum in an
order fixed per row (see there).
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "brgemm", "gemm", "zero", "identity",
    "relu", "relu_grad", "gelu", "gelu_grad", "silu", "sigmoid",
    "add", "sub", "mul", "scale", "bias_add", "residual_add",
    "reduce_sum", "reduce_max",
    "softmax", "layernorm", "rmsnorm", "dropout",
    "transpose", "vnni_pack", "vnni_unpack", "cast",
    "quantize_int8", "dequantize_int8",
    "UNARY_TPPS", "BINARY_TPPS", "ACTIVATIONS", "activation_grad",
]

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


# --------------------------------------------------------------------------
# Contractions
# --------------------------------------------------------------------------

def brgemm(a, b, c=None, *, beta: float = 1.0, accum_dtype=torch.float32,
           out_dtype=None):
    """Batch-Reduce GEMM TPP:  C = beta*C + sum_i A_i @ B_i   (paper §II-A).

    ``a``: (br, bm, bk)   ``b``: (br, bk, bn)   ``c``: (bm, bn) or None.
    Accumulates in ``accum_dtype`` whatever the input precision.
    """
    if a.dim() == 2:
        a = a[None]
    if b.dim() == 2:
        b = b[None]
    if a.shape[0] == 1 and b.shape[0] == 1:
        acc = torch.matmul(a[0].to(accum_dtype), b[0].to(accum_dtype))
    else:
        acc = torch.bmm(a.to(accum_dtype), b.to(accum_dtype)).sum(0)
    if c is not None and beta != 0.0:
        acc = acc + beta * c.to(accum_dtype)
    out_dtype = out_dtype or (c.dtype if c is not None else a.dtype)
    return acc.to(out_dtype)


def gemm(a, b, c=None, *, beta: float = 1.0, accum_dtype=torch.float32,
         out_dtype=None):
    """Plain GEMM TPP: BRGEMM with batch-reduce count 1."""
    return brgemm(a[None], b[None], c, beta=beta, accum_dtype=accum_dtype,
                  out_dtype=out_dtype)


# --------------------------------------------------------------------------
# Initialization / copy
# --------------------------------------------------------------------------

def zero(shape, dtype=torch.float32, device=None):
    return torch.zeros(shape, dtype=dtype, device=device)


def identity(x, out_dtype=None):
    return x.to(out_dtype or x.dtype)


def cast(x, dtype):
    return x.to(dtype)


# --------------------------------------------------------------------------
# Unary / activation TPPs (fp32 internal math)
# --------------------------------------------------------------------------

def relu(x):
    return torch.clamp_min(x.float(), 0.0).to(x.dtype)


def relu_grad(g, x):
    return torch.where(x > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))


def gelu(x):
    """tanh-approximation GELU (the paper's Bert-Intermediate TPP)."""
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (xf + 0.044715 * xf ** 3)))
    return y.to(x.dtype)


def gelu_grad(g, x):
    xf = x.float()
    t = torch.tanh(_SQRT_2_OVER_PI * (xf + 0.044715 * xf ** 3))
    dt = (1.0 - t ** 2) * _SQRT_2_OVER_PI * (1.0 + 3 * 0.044715 * xf ** 2)
    return (g.float() * (0.5 * (1.0 + t) + 0.5 * xf * dt)).to(g.dtype)


def sigmoid(x):
    return torch.sigmoid(x.float()).to(x.dtype)


def silu(x):
    xf = x.float()
    return (xf * torch.sigmoid(xf)).to(x.dtype)


# --------------------------------------------------------------------------
# Binary TPPs
# --------------------------------------------------------------------------

def add(x, y):
    return x + y


def sub(x, y):
    return x - y


def mul(x, y):
    return x * y


def scale(x, s):
    return (x.float() * s).to(x.dtype)


def bias_add(x, bias):
    """Row-broadcast bias add on a 2D tile: (m, n) + (n,)."""
    return (x.float() + bias.float()).to(x.dtype)


def residual_add(x, res):
    return (x.float() + res.float()).to(x.dtype)


# --------------------------------------------------------------------------
# Reductions / normalizations (fp32 statistics)
# --------------------------------------------------------------------------

def reduce_sum(x, axis=-1, keepdims=True):
    return torch.sum(x.float(), dim=axis, keepdim=keepdims)


def reduce_max(x, axis=-1, keepdims=True):
    return torch.amax(x.float(), dim=axis, keepdim=keepdims)


def softmax(x, axis=-1):
    xf = x.float()
    e = torch.exp(xf - torch.amax(xf, dim=axis, keepdim=True))
    return (e / torch.sum(e, dim=axis, keepdim=True)).to(x.dtype)


def _row_sum(x):
    """Sum over the last dim (kept), in an order fixed per row: the row is
    zero-padded to a power-of-two width and halved pairwise.  A library
    reduction on the GPU picks how to split a row by the number of rows, so
    its sums, and a decoded token with them, could change with how many
    requests share a batch."""
    d = x.shape[-1]
    n = 1 << (d - 1).bit_length()
    s = torch.nn.functional.pad(x, (0, n - d))
    while n > 1:
        n //= 2
        s = s[..., :n] + s[..., n:]
    return s


def _row_mean(x):
    """Mean over the last dim, summed as :func:`_row_sum` sums."""
    return _row_sum(x) / x.shape[-1]


def layernorm(x, gamma, beta, *, eps: float = 1e-5):
    """Layernorm over the last dim, fp32 statistics."""
    xf = x.float()
    mu = _row_mean(xf)
    var = _row_mean((xf - mu).square())
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def rmsnorm(x, gamma, *, eps: float = 1e-6):
    xf = x.float()
    ms = _row_mean(xf.square())
    return (xf * torch.rsqrt(ms + eps) * gamma.float()).to(x.dtype)


def dropout(x, generator, rate: float, *, deterministic: bool = False):
    """Inverted dropout: keep each element with probability 1 - ``rate``
    (uniforms from ``generator``, a ``torch.Generator`` on x's device) and
    scale the kept ones by 1 / (1 - rate).  The reference takes a jax key;
    the kept elements differ, their scale does not."""
    if deterministic or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


# --------------------------------------------------------------------------
# Layout transformation TPPs
# --------------------------------------------------------------------------

def transpose(x):
    return torch.swapaxes(x, -1, -2)


def vnni_pack(x, lanes: int = 2):
    """(K, N) → (K//lanes, N, lanes): the CPU VNNI packing TPP, kept for API
    parity with the paper and for tests that round-trip layouts."""
    k, n = x.shape
    assert k % lanes == 0, (k, lanes)
    return x.reshape(k // lanes, lanes, n).swapaxes(1, 2)


def vnni_unpack(x):
    kp, n, lanes = x.shape
    return x.swapaxes(1, 2).reshape(kp * lanes, n)


# --------------------------------------------------------------------------
# Quantization TPPs (for the gradient-compression path)
# --------------------------------------------------------------------------

def quantize_int8(x, axis=-1):
    """Symmetric per-slice int8 quantization: returns (q, scale)."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones((), device=x.device))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


# Registries used by dtype-sweep tests -------------------------------------
UNARY_TPPS = {
    "relu": relu, "gelu": gelu, "silu": silu, "sigmoid": sigmoid,
    "identity": identity, "softmax": softmax, "transpose": transpose,
}
BINARY_TPPS = {"add": add, "sub": sub, "mul": mul, "residual_add": residual_add}

# Epilogue activations of the GEMM kernel, by the names ``ops.matmul`` takes.
ACTIVATIONS = {"relu": relu, "gelu": gelu, "silu": silu, "sigmoid": sigmoid}


def activation_grad(activation, dy, z):
    """dy * act'(z) in fp32 at the fp32 pre-activation ``z``: the derivative
    XLA takes of each activation above (``repro/core/tpp.py``'s
    ``relu_grad`` and ``gelu_grad``, and the chain rule through
    ``sigmoid`` and ``x * sigmoid(x)``)."""
    dy, z = dy.float(), z.float()
    if activation is None:
        return dy
    if activation == "relu":
        return torch.where(z > 0, dy, torch.zeros((), dtype=dy.dtype, device=dy.device))
    if activation == "gelu":
        t = torch.tanh(_SQRT_2_OVER_PI * (z + 0.044715 * z ** 3))
        dt = (1.0 - t ** 2) * _SQRT_2_OVER_PI * (1.0 + 3 * 0.044715 * z ** 2)
        return dy * (0.5 * (1.0 + t) + 0.5 * z * dt)
    sig = torch.sigmoid(z)
    if activation == "sigmoid":
        return dy * sig * (1.0 - sig)
    if activation == "silu":
        return dy * (sig + z * sig * (1.0 - sig))
    raise ValueError(f"unknown activation {activation!r}")
