"""Load the reference package's parameters into the port.

``params_from_numpy`` takes the pytree of ``repro.models.lm.init_params``
with every leaf already turned into a numpy array (``jax.tree.map(np.asarray,
params)``, done by the caller: this package never imports jax) and returns
the port's parameter dictionary.  The reference stacks each group's layers on
a leading axis (``groups[g][pos][...][i]``); here they become one dictionary
per layer.  Embeddings, projection weights and biases are stored in
``dtype``: the compute dtype by default (serving), or ``torch.float32`` to
keep the reference's fp32 masters bit for bit (training).  Norm scales and
biases stay fp32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models import lm

__all__ = ["params_from_numpy"]


def _is_norm(key: str) -> bool:
    return key.startswith("norm") or key == "final_norm"


def _convert(node, dev, dt):
    """Dict tree of arrays → dict tree of tensors; subtrees under a norm key
    keep fp32."""
    out = {}
    for key, val in node.items():
        if isinstance(val, dict):
            out[key] = _convert(val, dev, torch.float32 if _is_norm(key) else dt)
        else:
            t = torch.from_numpy(np.array(val, np.float32))
            out[key] = t.to(device=dev, dtype=torch.float32 if _is_norm(key) else dt)
    return out


def _index(node, i):
    return {k: _index(v, i) if isinstance(v, dict) else v[i] for k, v in node.items()}


def params_from_numpy(cfg: ModelConfig, tree, device=None, *, dtype=None):
    """Reference parameter pytree (numpy leaves) → the port's parameters on
    ``device`` (CUDA unless given), stored in ``dtype`` (default: the
    compute dtype)."""
    dev = resolve_device(device)
    dt = dtype or B.compute_dtype(cfg)
    layers = []
    for gtree, group in zip(tree["groups"], lm.derive_groups(cfg)):
        for r in range(group.repeat):
            for pos in range(len(group.kinds)):
                layers.append(_convert(_index(gtree[pos], r), dev, dt))
    params = _convert({k: tree[k] for k in ("embed", "final_norm", "lm_head")
                       if k in tree}, dev, dt)
    params["layers"] = layers
    return params
