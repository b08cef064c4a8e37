"""The threefry2x32-20 counter-based generator of ``repro/fusion/rng.py``.

A pure function ``(key0, key1, ctr0, ctr1) -> (word0, word1)`` of 32-bit
adds, xors and rotates, so the port draws the reference's bits exactly.
torch has no unsigned 32-bit arithmetic, so every word is held in int64 in
[0, 2^32) and each add and shift is masked with ``& 0xFFFFFFFF``.  Works on
tensors of any shape and device (broadcasting) and on Python ints.

Ported so far: ``threefry2x32``, ``derive_salt`` and ``fold_in`` (what the
sampler needs).  ``tile_bits``, ``keep_mask`` and ``dropout`` come with
training; ``hw_tile_bits`` (K13) later (ROADMAP.md).
"""
from __future__ import annotations

import zlib

import torch

__all__ = ["SCHEME", "threefry2x32", "derive_salt", "fold_in"]

SCHEME = "threefry2x32-20"

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA          # Threefish key-schedule parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_GOLDEN = 0x9E3779B9          # fold_in key word (golden-ratio constant)


def _u32(x, device):
    """A uint32 word (or tensor of them) as int64 in [0, 2^32)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64) & _MASK
    return torch.tensor(int(x) & _MASK, dtype=torch.int64, device=device)


def _rotl(x, d: int):
    return ((x << d) & _MASK) | (x >> (32 - d))


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 block cipher on uint32 words held as int64
    tensors (broadcasting); → both output words as int64 in [0, 2^32)."""
    dev = next((t.device for t in (k0, k1, x0, x1) if isinstance(t, torch.Tensor)),
               torch.device("cpu"))
    k0, k1, x0, x1 = (_u32(v, dev) for v in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for d in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, d) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def derive_salt(name: str) -> int:
    """Static per-site key word from a stable name (crc32)."""
    return zlib.crc32(name.encode("utf-8")) & _MASK


def fold_in(seed, data):
    """Fold ``data`` into ``seed``: one threefry call keyed on the
    golden-ratio constant; → the new seed word (int64 tensor)."""
    x0, _ = threefry2x32(seed, _GOLDEN, data, 0)
    return x0
