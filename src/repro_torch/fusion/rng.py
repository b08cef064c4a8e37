"""The threefry2x32-20 counter-based generator of ``repro/fusion/rng.py``.

A pure function ``(key0, key1, ctr0, ctr1) -> (word0, word1)`` of 32-bit
adds, xors and rotates, so the port draws the reference's bits exactly.
torch has no unsigned 32-bit arithmetic, so every word is held in int64 in
[0, 2^32) and each add and shift is masked with ``& 0xFFFFFFFF``.  Works on
tensors of any shape and device (broadcasting) and on Python ints.

Ported so far: ``threefry2x32``, ``derive_salt`` and ``fold_in`` (what the
sampler needs), and ``tile_bits``, ``keep_threshold``, ``keep_mask`` and
``dropout`` (training).  ``hw_tile_bits`` (K13) comes later (ROADMAP.md).
"""
from __future__ import annotations

import zlib

import torch

__all__ = ["SCHEME", "threefry2x32", "derive_salt", "fold_in", "tile_bits",
           "keep_threshold", "keep_mask", "dropout"]

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


def tile_bits(seed, salt, shape, *, offsets=(0, 0), device=None):
    """uint32 bits (as int64) for a 2-D tile of ``shape`` whose element
    (r, c) sits at global coordinates (offsets[0] + r, offsets[1] + c), the
    counter words; computed on ``device`` (default: the CPU)."""
    if len(shape) != 2:
        raise ValueError(f"tile_bits takes a 2-D shape, got {shape}")
    dev = torch.device(device) if device is not None else torch.device("cpu")
    rows = torch.arange(shape[0], dtype=torch.int64, device=dev)[:, None] + int(offsets[0])
    cols = torch.arange(shape[1], dtype=torch.int64, device=dev)[None, :] + int(offsets[1])
    bits, _ = threefry2x32(_u32(seed, dev), _u32(salt, dev), rows, cols)
    return bits


def keep_threshold(rate: float) -> int:
    """``bits < threshold`` keeps an element with probability ``1 - rate``
    (an exact integer compare)."""
    t = int((1.0 - float(rate)) * 4294967296.0)
    return max(0, min(t, 4294967295))


def keep_mask(seed, salt, shape, *, rate: float, offsets=(0, 0), device=None):
    """Boolean keep decisions for a tile (True = keep)."""
    return tile_bits(seed, salt, shape, offsets=offsets, device=device) < keep_threshold(rate)


def dropout(x, seed, salt, rate: float, *, offsets=(0, 0)):
    """Dropout over a 2-D tensor with the reference's draw: kept elements
    scaled by 1 / (1 - rate) in fp32, output in ``x``'s dtype."""
    if rate <= 0.0:
        return x
    keep = keep_mask(seed, salt, x.shape, rate=rate, offsets=offsets, device=x.device)
    scaled = x.float() * float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))
    return torch.where(keep, scaled, torch.zeros((), device=x.device)).to(x.dtype)
