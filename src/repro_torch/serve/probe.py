"""BatchSpec probe: size the serving engine before serving.

Ported from ``repro/serve/probe.py``.  Rather than trusting a memory model
alone, try a candidate (num_slots, pages) engine shape and see whether it
fits, then binary-search the largest feasible spec.  Two probe levels:

- ``trial(..., execute=False)`` (default): count the bytes of the weights
  and the paged caches from their shapes, with nothing allocated
  (``lm.init_params`` and ``lm.init_paged_cache`` on the ``meta``
  device), and compare them with the budget;
- ``trial(..., execute=True)``: also build that engine's weights and paged
  caches on the device and run one paged ``decode_step`` at the candidate
  shape.  It allocates a second copy of the weights beside the caller's.

The bytes are what the port would allocate: the reference's count at the
fp32 ``reduced()`` configs; at full width the port's bf16 serving weights,
where the reference counts its fp32 ones.

Unlike the reference, which takes any ``Exception`` of the trial run for
"does not fit", ``trial(execute=True)`` catches only
``torch.cuda.OutOfMemoryError``: it then frees what it allocated and
returns ``False``.  Any other error (a kernel that fails to build or
launch, a shape a plan refuses) propagates.

The binary search assumes monotonicity (if B slots fit, so do B - 1), which
holds for both probe levels.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm

__all__ = ["BatchSpec", "tree_bytes", "trial", "max_feasible_slots"]


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """One candidate engine shape."""
    num_slots: int
    num_pages: int
    page_size: int
    max_seq: int                 # per-request token capacity

    @property
    def max_pages_per_slot(self) -> int:
        return max(1, math.ceil(self.max_seq / self.page_size))


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a tree of dicts and lists."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _abstract_bytes(cfg: ModelConfig, spec: BatchSpec) -> int:
    params = lm.init_params(cfg, 0, device="meta")
    caches = lm.init_paged_cache(cfg, spec.num_slots, spec.num_pages, spec.page_size,
                                 device="meta")
    return tree_bytes(params) + tree_bytes(caches)


def _one_step(cfg: ModelConfig, spec: BatchSpec, dev) -> None:
    """Weights, paged caches and one paged decode step at ``spec``'s shape;
    everything it allocates goes with its frame."""
    params = lm.init_params(cfg, 0, device=dev)
    caches = lm.init_paged_cache(cfg, spec.num_slots, spec.num_pages, spec.page_size,
                                 device=dev)
    table = torch.zeros((spec.num_slots, spec.max_pages_per_slot), dtype=torch.int32,
                        device=dev)
    tokens = torch.zeros(spec.num_slots, dtype=torch.int64, device=dev)
    pos = torch.zeros(spec.num_slots, dtype=torch.int64, device=dev)
    lm.decode_step(cfg, params, caches, tokens, pos, page_table=table,
                   page_size=spec.page_size)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def trial(cfg: ModelConfig, spec: BatchSpec, *,
          budget_bytes: Optional[int] = None,
          execute: bool = False,
          min_pages: Optional[int] = None,
          device=None) -> bool:
    """Is ``spec`` feasible?  Bytes against the budget (with 1.25x slack
    for activations and workspaces), and with ``execute`` one decode step
    run at that shape on ``device`` (CUDA unless given).  ``min_pages``
    relaxes the pool floor below one slot's worst case, for
    optimistic-admission pools that undersize and preempt under pressure."""
    floor = spec.max_pages_per_slot if min_pages is None else min_pages
    if spec.num_slots < 1 or spec.num_pages < floor:
        return False
    if budget_bytes is not None:
        if _abstract_bytes(cfg, spec) * 1.25 > budget_bytes:
            return False
    if not execute:
        return True
    dev = resolve_device(device)
    fits = False
    try:
        _one_step(cfg, spec, dev)
        fits = True
    except torch.cuda.OutOfMemoryError:
        pass
    # past the handler the failed step's frame, and its tensors, are gone
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return fits


def max_feasible_slots(cfg: ModelConfig, *, page_size: int, max_seq: int,
                       budget_bytes: Optional[int] = None,
                       execute: bool = False, hi: int = 256,
                       pages_per_slot: Optional[int] = None,
                       device=None) -> BatchSpec:
    """Binary-search the largest feasible ``num_slots``.  By default each
    slot carries its full ``max_seq`` page reservation; ``pages_per_slot``
    overrides that per-slot count to size an optimistic-admission pool
    (``EngineConfig(admission="optimistic")``) below the worst case.
    Raises ``ValueError`` if even one slot does not fit."""
    worst = max(1, math.ceil(max_seq / page_size))
    ppr = worst if pages_per_slot is None else int(pages_per_slot)
    if not 1 <= ppr <= worst:
        raise ValueError(f"pages_per_slot must be in [1, {worst}] "
                         f"(worst case for max_seq={max_seq})")

    def spec(b):
        return BatchSpec(num_slots=b, num_pages=b * ppr,
                         page_size=page_size, max_seq=max_seq)

    def ok(b):
        return trial(cfg, spec(b), budget_bytes=budget_bytes,
                     execute=execute, min_pages=ppr, device=device)

    if not ok(1):
        raise ValueError(
            f"no feasible batch: one slot at max_seq={max_seq} "
            f"(page_size={page_size}) exceeds the budget")
    if ok(hi):
        return spec(hi)
    lo = 1
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if ok(mid):
            lo = mid
        else:
            hi = mid
    return spec(lo)
