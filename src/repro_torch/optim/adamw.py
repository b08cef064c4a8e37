"""AdamW with global-norm clipping, ported from ``repro/optim/adamw.py``.

Same semantics: the global norm over every leaf in fp32, clipping to
``clip_norm``, ``count`` as an int32, bias corrections ``1 - b**count`` in
fp32, weight decay on every leaf (norm scales and embeddings included), and
moments stored in ``moment_dtype`` (cast up, updated in fp32, cast back).
Trees are the port's parameter trees: dictionaries and lists of tensors.

Unlike the reference, which returns new arrays, ``apply_updates`` updates
the parameters and moments in place, one leaf at a time, so a step holds no
second copy of the fp32 masters or moments (about 33 GB at minicpm-2b's
2.7 B parameters); it returns the same objects.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["AdamWConfig", "init_state", "apply_updates", "global_norm", "tree_leaves"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    # Moments may be stored bf16 to halve the optimizer state; the math
    # stays fp32 (moments cast up, updated, cast back).
    moment_dtype: str = "float32"


def tree_leaves(tree):
    """The tensors of a tree of dictionaries and lists, in the reference's
    order (dictionary keys sorted, as ``jax.tree.leaves`` takes them)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def init_state(params, cfg: AdamWConfig = None):
    md = _DTYPES[(cfg or AdamWConfig()).moment_dtype]
    zeros = lambda p: torch.zeros_like(p, dtype=md, requires_grad=False)
    dev = tree_leaves(params)[0].device
    return {"mu": _tree_map(zeros, params), "nu": _tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, state, *, lr, cfg: AdamWConfig = AdamWConfig()):
    """→ (params, state, metrics {"grad_norm"}), params and moments updated
    in place (see the module docstring).  ``lr`` is a float or a 0-d
    tensor; ``grads`` has the parameters' tree structure, or is the list of
    their leaves in ``tree_leaves`` order."""
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = state["count"] + 1
    c = count.to(device="cpu", dtype=torch.float32)
    b1c = float(1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32), c))
    b2c = float(1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32), c))
    lr = float(lr)
    for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["mu"]),
                            tree_leaves(state["nu"])):
        if scale is not None:
            g = g * scale
        g = g.float()
        m32, v32 = mu.float(), nu.float()
        m32.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v32.mul_(cfg.b2).add_(g.square(), alpha=1 - cfg.b2)
        step = (m32 / b1c).div_((v32 / b2c).sqrt_().add_(cfg.eps))
        if cfg.weight_decay:
            step.add_(p.float(), alpha=cfg.weight_decay)
        p.sub_((lr * step).to(p.dtype))
        if m32 is not mu:
            mu.copy_(m32)
            nu.copy_(v32)
    state["count"] = count
    return params, state, {"grad_norm": gnorm}
