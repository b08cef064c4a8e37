"""The threefry2x32-20 counter-based generator of ``repro/fusion/rng.py``.

A pure function ``(key0, key1, ctr0, ctr1) -> (word0, word1)`` of 32-bit
adds, xors and rotates, so the port draws the reference's bits exactly.
torch has no unsigned 32-bit arithmetic, so every word is held in int64 in
[0, 2^32) and each add and shift is masked with ``& 0xFFFFFFFF``.  Works on
tensors of any shape and device (broadcasting) and on Python ints.

Ported: ``threefry2x32``, ``derive_salt`` and ``fold_in`` (what the
sampler needs), ``tile_bits``, ``keep_threshold``, ``keep_mask`` and
``dropout`` (training), the compile-time salt guard of the fusion compiler
(``collect_salt_sites``, ``salt_collisions``, ``assert_unique_salts``), and
``hw_tile_bits``, K13's plain version.

K13 replaces ``repro/fusion/rng.py:212 hw_tile_bits``, the TPU's hardware
generator re-seeded per tile on ``(seed, salt, row0, col0)``, behind the
lowering's ``hw_prng=True``.  A GPU has no such generator, so the port
draws **Philox4x32-10** (Salmon et al., SC'11; Random123's constants),
written by hand in ``kernels/csrc/philox.cuh`` for K5 and here in masked
int64 for the plain version (``philox4x32``): key = (seed, salt), counter
= (row0, col0, q, 0), and element (r, c) of a tile of width ``tile_w``
takes word ``local % 4`` of block ``q = local // 4``, ``local = r * tile_w
+ c``.  As the reference's contract says, the bits depend on the tile (its
origin and shape): they are not schedule-invariant and not the counter
path's bits.  They are the same on the CPU and the card.
"""
from __future__ import annotations

import zlib

import torch

__all__ = ["SCHEME", "HW_SCHEME", "threefry2x32", "philox4x32", "derive_salt", "fold_in",
           "tile_bits", "hw_tile_bits", "hw_bits", "keep_threshold", "keep_mask", "dropout",
           "collect_salt_sites", "salt_collisions", "assert_unique_salts"]

SCHEME = "threefry2x32-20"
HW_SCHEME = "philox4x32-10"

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


# Philox4x32's round multipliers and Weyl key increments (Random123).
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b):
    """(hi, lo) words of the 64-bit product of the constant ``a`` and the
    uint32 words ``b``.  The product does not fit a signed int64, so ``b``
    is split into 16-bit halves: each partial product is below 2^48."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    t = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (t >> 32), t & _MASK


def philox4x32(ctr, key, rounds: int = 10):
    """Philox4x32-``rounds`` on uint32 words held as int64 tensors
    (broadcasting): ``ctr`` four words, ``key`` two; → the four output
    words as int64 in [0, 2^32)."""
    dev = next((t.device for t in (*ctr, *key) if isinstance(t, torch.Tensor)),
               torch.device("cpu"))
    c0, c1, c2, c3 = (_u32(v, dev) for v in ctr)
    k0, k1 = (_u32(v, dev) for v in key)
    for r in range(rounds):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK
            k1 = (k1 + _PHILOX_W[1]) & _MASK
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


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


def hw_bits(seed, salt, shape, tile, *, device=None):
    """K13's bits for a 2-D array of ``shape`` cut into tiles of ``tile``
    (rows, columns) from (0, 0): each element draws from its tile's stream
    (``hw_tile_bits`` of that tile), as K5 draws them under a plan whose
    PRNG tile is ``tile``.  uint32 as int64 on ``device`` (default CPU)."""
    if len(shape) != 2 or len(tile) != 2:
        raise ValueError(f"hw_bits takes 2-D shapes, got {shape} and tile {tile}")
    dev = torch.device(device) if device is not None else torch.device("cpu")
    tm, tn = int(tile[0]), int(tile[1])
    rows = torch.arange(shape[0], dtype=torch.int64, device=dev)[:, None]
    cols = torch.arange(shape[1], dtype=torch.int64, device=dev)[None, :]
    return _tile_stream(seed, salt, rows - rows % tm, cols - cols % tn,
                        (rows % tm) * tn + cols % tn, dev)


def hw_tile_bits(seed, salt, shape, *, offsets=(0, 0), device=None):
    """K13's plain version: uint32 bits (as int64) of one tile of ``shape``
    whose origin is ``offsets`` (row0, col0): Philox4x32-10 keyed on
    (seed, salt) with counter (row0, col0, local // 4, 0), element (r, c)
    taking word ``local % 4``, ``local = r * shape[1] + c``.  Depends on
    the tile's origin and shape, and on nothing else."""
    if len(shape) != 2:
        raise ValueError(f"hw_tile_bits takes a 2-D shape, got {shape}")
    dev = torch.device(device) if device is not None else torch.device("cpu")
    rows = torch.arange(shape[0], dtype=torch.int64, device=dev)[:, None]
    cols = torch.arange(shape[1], dtype=torch.int64, device=dev)[None, :]
    return _tile_stream(seed, salt, _u32(offsets[0], dev), _u32(offsets[1], dev),
                        rows * int(shape[1]) + cols, dev)


def _tile_stream(seed, salt, row0, col0, local, dev):
    words = philox4x32((row0, col0, local >> 2, 0), (_u32(seed, dev), _u32(salt, dev)))
    lane = local & 3
    return torch.where(lane == 0, words[0], torch.where(
        lane == 1, words[1], torch.where(lane == 2, words[2], words[3])))


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


def collect_salt_sites(graph):
    """``[(node_name, op, salt, rate)]`` for every node of ``graph`` whose
    attrs carry a static PRNG ``salt``."""
    out = []
    for nd in graph.nodes:
        attrs = nd.attr_dict()
        if "salt" in attrs:
            out.append((nd.name, nd.op, attrs["salt"], attrs.get("rate")))
    return out


def salt_collisions(graph):
    """``[(site_a, site_b, message)]`` for every illegal salt sharing: two
    nodes of one op on one salt (identical masks at both sites), or a
    forward/grad pair on one salt with different rates.  One
    ``dropout_rng`` and one ``dropout_rng_grad`` on one salt and rate is the
    recompute contract, not a fault."""
    by_salt: dict = {}
    for name, op, salt, rate in collect_salt_sites(graph):
        by_salt.setdefault(salt, []).append((name, op, rate))
    out = []
    for salt, sites in sorted(by_salt.items()):
        seen_op: dict = {}
        for name, op, rate in sites:
            if op in seen_op:
                other = seen_op[op]
                out.append((other, name, (
                    f"graph {graph.name!r}: nodes {other!r} and {name!r} "
                    f"both draw {op!r} bits with salt {salt:#010x} — the "
                    "two sites would apply identical masks. Derive a "
                    "distinct salt per site (rng.derive_salt of a unique "
                    "stable name).")))
            else:
                seen_op[op] = name
        rates = {rate for _n, _o, rate in sites}
        if len(sites) > 1 and len(rates) > 1:
            a, b = sites[0][0], sites[1][0]
            out.append((a, b, (
                f"graph {graph.name!r}: nodes sharing salt {salt:#010x} "
                f"disagree on rate ({sorted(map(str, rates))}) — a "
                "backward regeneration would keep a different element set "
                "than the forward applied.")))
    return out


def assert_unique_salts(graph) -> None:
    """Raise ``FusionLegalityError`` (code ``TPP203``) on the first illegal
    salt sharing, naming both sites."""
    collisions = salt_collisions(graph)
    if collisions:
        from repro_torch.fusion.graph import FusionLegalityError
        _a, _b, msg = collisions[0]
        raise FusionLegalityError("TPP203 duplicate-prng-salt: " + msg,
                                  code="TPP203")
