"""Checkpoints of tensor trees (npz + JSON), ported from
``repro/checkpoint/checkpoint.py``.

Layout of one checkpoint, as in the reference::

    <dir>/step_<N>/
        manifest.json      # leaf paths, shapes, dtypes, step, extra state
        arrays.npz         # one entry per leaf, on the host

Writes are atomic (a temporary directory, then a rename), so a preemption
mid-write never leaves a partial ``step_<N>``; ``keep`` bounds how many
stay.  numpy has no bfloat16, so a bf16 leaf is stored as its raw 16-bit
words (uint16) with ``"bfloat16"`` in the manifest, and restored bit for
bit.  A tree is dictionaries, lists and tuples of tensors; leaf paths join
keys and indices with ``/``.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "all_steps"]

_SEP = "/"


def _flatten(tree, prefix=()):
    """→ [(path, leaf)] in the reference's order (dictionary keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flatten(v, prefix + (str(i),))]
    return [(_SEP.join(prefix), tree)]


def _unflatten(template, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(template)


def _to_numpy(t: torch.Tensor):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"checkpoint leaves must be tensors, got {type(t).__name__}")
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save_checkpoint(directory: str, step: int, tree: Any, *,
                    extra: Optional[dict] = None, keep: int = 3) -> str:
    """Atomically persist ``tree`` (+ JSON-serializable ``extra``)."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        arrays, dtypes = {}, {}
        for key, leaf in _flatten(tree):
            arrays[key], dtypes[key] = _to_numpy(leaf)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "extra": extra or {},
            "leaves": {k: {"shape": list(a.shape), "dtype": dtypes[k]}
                       for k, a in arrays.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _cleanup(directory, keep)
    return final


def _cleanup(directory: str, keep: int):
    for s in all_steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"), ignore_errors=True)


def all_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                out.append(int(name[len("step_"):]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, template: Any, *,
                       step: Optional[int] = None) -> tuple[Any, int, dict]:
    """Restore into the structure of ``template``: each leaf takes its
    template leaf's device and dtype.  A leaf whose stored shape differs
    from the template's raises ``ValueError``.  → (tree, step, extra)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for key, tmpl in _flatten(template):
            a = data[key]
            if tuple(a.shape) != tuple(tmpl.shape):
                raise ValueError(f"{key}: checkpoint shape {a.shape} != {tuple(tmpl.shape)}")
            if manifest["leaves"][key]["dtype"] == "bfloat16":
                t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(a))
            out.append(t.to(device=tmpl.device, dtype=tmpl.dtype)
                       .requires_grad_(tmpl.requires_grad))
    return _unflatten(template, out), manifest["step"], manifest["extra"]
