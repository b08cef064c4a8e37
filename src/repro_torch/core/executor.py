"""The executor for PARLOOPER nests: the analogue of the paper's JITed C++
loop nests (Listings 2/3), as plain Python loops.

``body(ind, carry) -> carry`` receives the *logical* indices (one per
logical loop, in the order of the letters, each offset by its loop's
``start``: the paper's ``int *ind``) and a carry, the tensors the body
writes.  A port of ``repro/core/executor.py``, with these differences:

  * the modes ``"auto"``, ``"unroll"`` and ``"lax"`` are all accepted and
    run the same Python loops: eager PyTorch has no trace to keep small, so
    there is nothing for a rolled loop to save;
  * a ``|`` barrier does nothing, since eager PyTorch already runs the body
    calls in program order;
  * a mesh level (``{axis:N}``) raises: the reference runs it inside a
    ``shard_map``, and one card has no mesh (ROADMAP.md, Queue 1 item 12).

A body may update the carry's tensors in place and return them, which saves
the copy a functional update would make.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.legality import LegalityError

__all__ = ["run_nest", "require_no_mesh"]

MODES = ("auto", "unroll", "lax")


def require_no_mesh(nest) -> None:
    """Raise when the nest has a mesh level: nothing here runs one."""
    if nest.mesh_levels:
        raise LegalityError(
            f"spec {nest.spec.raw!r} splits loops over mesh axes {nest.mesh_axes}: the "
            "port plans mesh levels but runs none until distributed execution is ported "
            "(ROADMAP.md, Queue 1 item 12)")


def run_nest(
    nest,
    body: Callable,
    carry=None,
    *,
    init_func: Optional[Callable] = None,
    term_func: Optional[Callable] = None,
    mode: str = "auto",
    unroll_limit: int = 512,
):
    """Execute ``body`` over the instantiated nest (a ``LoopNest``),
    threading ``carry``.  ``unroll_limit`` is accepted for the reference's
    signature; every mode runs the same loops."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    require_no_mesh(nest)
    if init_func is not None:
        carry = init_func(carry)
    levels = nest.levels
    starts = [loop.start for loop in nest.loops]
    slot = {letter: i for i, letter in enumerate(nest.letters)}

    def descend(depth: int, offsets: list, carry):
        if depth == len(levels):
            return body(tuple(o + s for o, s in zip(offsets, starts)), carry)
        lvl = levels[depth]
        i = slot[lvl.letter]
        base = offsets[i]
        for t in range(lvl.trip_count):
            offsets[i] = base + t * lvl.step
            carry = descend(depth + 1, offsets, carry)
        offsets[i] = base
        return carry

    carry = descend(0, [0] * len(nest.letters), carry)
    if term_func is not None:
        carry = term_func(carry)
    return carry
