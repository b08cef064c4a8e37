"""Tensor Processing Primitives used by the dense decoder, in PyTorch.

The subset of ``repro/core/tpp.py`` that the dense decoder runs, serving
and training.  As there,
every primitive is precision-aware: low-precision inputs compute in fp32 and
cast back on the way out.
"""
from __future__ import annotations

import math

import torch

__all__ = ["relu", "gelu", "silu", "sigmoid", "mul", "bias_add",
           "layernorm", "rmsnorm", "ACTIVATIONS", "activation_grad"]

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def relu(x):
    return torch.clamp_min(x.float(), 0.0).to(x.dtype)


def gelu(x):
    """tanh-approximation GELU (the paper's Bert-Intermediate TPP)."""
    xf = x.float()
    y = 0.5 * xf * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (xf + 0.044715 * xf ** 3)))
    return y.to(x.dtype)


def sigmoid(x):
    return torch.sigmoid(x.float()).to(x.dtype)


def silu(x):
    xf = x.float()
    return (xf * torch.sigmoid(xf)).to(x.dtype)


def mul(x, y):
    return x * y


def bias_add(x, bias):
    """Row-broadcast bias add on a 2D tile: (m, n) + (n,)."""
    return (x.float() + bias.float()).to(x.dtype)


def _row_mean(x):
    """Mean over the last dim, summed in an order fixed per row: the row is
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
    return s / d


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
