"""K3's launch plan and its split-and-combine arithmetic on the CPU (no GPU,
no nvcc needed).

``flash_attention.decode_plan`` is what the wrapper hands the CUDA entry
point (``csrc/flash_decode.cu``): the key axis is cut into fixed chunks of
``DECODE_CHUNK`` keys, the source's ``kChunk``, a constant that never
depends on B, so a decoded row has the same bits in any batch; a cache the
kernel's 16-byte loads cannot read raises.
``split_decode`` below repeats the kernel's arithmetic in torch fp32: each
chunk's softmax over its live keys (m, l, acc), then the combine in chunk
order; it is held against the reference's ``flash_decode_pallas`` in
interpret mode and against the port's plain ``decode_attention_ref``, at
fp32 tolerance 1e-4 and bf16 rtol 2e-2 / atol 2e-1 (those of
``tests/test_kernels.py``: one bf16 rounding of the output, and the
reference rounds p to bf16 before p @ V where the kernel does not).  A row
with no live key gives 0 (the kernel's and the Pallas kernel's l floor);
the plain version's softmax has no key there, so those rows are held
against the Pallas kernel only.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_decode_pallas
from repro_torch.configs.base import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as tref
from repro_torch.models import lm

TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-1)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _caches(b, h, hk, s, d, dtype=torch.bfloat16):
    q = torch.zeros(b, h, d, dtype=dtype)
    k = torch.zeros(b, hk, s, d, dtype=dtype)
    return q, k, k.clone()


def split_decode(q, k, v, length, window, chunk):
    """The split kernel's arithmetic in fp32: for each (batch row, kv head)
    and each chunk of ``chunk`` keys, the live keys' scores s, m_c = max s,
    p = e^(s - m_c), l_c = sum p, acc_c = p @ V (an empty chunk: m_c =
    -1e30, l_c = 0); then, in chunk order, m* = max m_c, l = sum l_c
    e^(m_c - m*), o = sum acc_c e^(m_c - m*) / max(l, 1e-30)."""
    b, h, d = q.shape
    hk, s = k.shape[1], k.shape[2]
    g = h // hk
    qg, kf, vf = q.float().reshape(b, hk, g, d), k.float(), v.float()
    scale = 1.0 / math.sqrt(d)
    chunks = max(1, -(-s // chunk))
    out = torch.zeros(b, hk, g, d)
    for bi in range(b):
        n = min(max(int(length[bi]), 0), s)
        lo = max(n - window, 0) if window else 0
        for kh in range(hk):
            parts = []
            for c in range(chunks):
                c0 = c * chunk
                beg, end = max(lo - c0, 0), min(n - c0, chunk)
                if beg >= end:
                    parts.append((torch.full((g,), -1e30), torch.zeros(g), torch.zeros(g, d)))
                    continue
                keys = slice(c0 + beg, c0 + end)
                sc = qg[bi, kh] @ kf[bi, kh, keys].T * scale
                m = sc.max(-1).values
                p = torch.exp(sc - m[:, None])
                parts.append((m, p.sum(-1), p @ vf[bi, kh, keys]))
            mstar = torch.stack([m for m, _, _ in parts]).max(0).values
            l, o = torch.zeros(g), torch.zeros(g, d)
            for m, lc, acc in parts:
                w = torch.where(lc > 0, torch.exp(m - mstar), torch.zeros(g))
                l = l + lc * w
                o = o + acc * w[:, None]
            out[bi, kh] = o / torch.clamp(l, min=1e-30)[:, None]
    return out.reshape(b, h, d)


# --- the plan ---------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 2, 3, 4, 8])
def test_the_chunk_does_not_depend_on_the_batch(b):
    plan = fa.decode_plan(*_caches(b, 40, 40, 528, 128))
    one = fa.decode_plan(*_caches(1, 40, 40, 528, 128))
    assert plan.kernel == one.kernel == "flash_decode_split_kernel"
    assert plan.chunk == one.chunk == fa.DECODE_CHUNK
    assert plan.chunks == one.chunks and plan.smem_bytes == one.smem_bytes
    assert plan.grid == (one.chunks, 40, b)


def test_the_plan_chunk_is_the_source_chunk():
    """The wrapper sizes the workspace by DECODE_CHUNK; the kernel cuts the
    keys by its own constant (checked again against the library on the
    card)."""
    src = (Path(fa.__file__).resolve().parent / "csrc" / "flash_decode.cu").read_text()
    assert re.findall(r"constexpr int kChunk = (\d+);", src) == [str(fa.DECODE_CHUNK)]


@pytest.mark.parametrize("s, chunks", [(528, 9), (100, 2), (64, 1), (65, 2), (37, 1), (0, 1)])
def test_chunk_count_and_workspace(s, chunks):
    b, h, hk, d = 4, 40, 8, 128
    plan = fa.decode_plan(*_caches(b, h, hk, s, d))
    assert fa.DECODE_CHUNK == 64
    assert plan.chunks == chunks
    # fp32 (m, l, acc) a (batch row, query head, chunk); one chunk is written directly
    assert plan.workspace_bytes == (4 * b * h * chunks * (d + 2) if chunks > 1 else 0)
    assert plan.grid == (chunks, hk, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_shared_memory_fits_at_the_largest_group(d, dtype):
    g = min(16, 2048 // d)
    plan = fa.decode_plan(*_caches(2, g, 1, 300, d, dtype))
    size = torch.finfo(dtype).bits // 8
    chunk = plan.chunk
    assert plan.smem_bytes == size * (g * d + 2 * chunk * d) + 4 * (2 * g * chunk + 2 * g)
    assert plan.smem_bytes <= fa.SMEM_LIMIT


def test_group_and_head_dim_limits():
    with pytest.raises(ValueError, match="head dim"):
        fa.decode_plan(*_caches(1, 2, 1, 64, 48))
    with pytest.raises(ValueError, match="exceeds one block"):
        fa.decode_plan(*_caches(1, 32, 1, 64, 64))
    with pytest.raises(ValueError, match="exceeds one block"):
        fa.decode_plan(*_caches(1, 16, 1, 64, 256))
    assert fa.decode_plan(*_caches(1, 8, 1, 64, 256)).chunks == 1


def _misaligned(which, dtype):
    """A (2, 2, 64, 16) cache of ``dtype`` that is off by 8 bytes or by two
    elements where ``which`` says, or read along a transposed last axis."""
    b, hk, s, d = 2, 2, 64, 16
    n = b * hk * s * d
    if which == "base":
        off = 64 // torch.finfo(dtype).bits     # 8 bytes
        return torch.zeros(n + off, dtype=dtype)[off:].view(b, hk, s, d)
    if which == "seq stride":
        return torch.zeros(b, hk, s, d + 2, dtype=dtype)[..., :d]
    if which == "head stride":
        return torch.zeros(b, hk, s * d + 2, dtype=dtype)[..., :s * d].view(b, hk, s, d)
    if which == "batch stride":
        return torch.zeros(b, hk * s * d + 2, dtype=dtype)[:, :hk * s * d].view(b, hk, s, d)
    return torch.zeros(b, hk, d, s, dtype=dtype).transpose(2, 3)   # last stride s


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("which", ["base", "seq stride", "head stride", "batch stride",
                                   "last stride"])
def test_a_cache_the_16_byte_loads_cannot_read_is_refused(which, dtype):
    bad = _misaligned(which, dtype)
    good = torch.zeros(bad.shape, dtype=dtype)
    q = torch.zeros(2, 4, 16, dtype=dtype)
    assert fa.decode_plan(q, good, good).chunks == 1
    for k, v in ((bad, good), (good, bad)):
        with pytest.raises(ValueError, match="16-byte loads"):
            fa.decode_plan(q, k, v)


def test_the_model_caches_and_their_prefixes_are_read_in_place():
    cfg = get_config("llama2_13b").reduced()
    cache = lm.init_cache(cfg, 3, 100, device="cpu")[0]
    q = torch.zeros(3, cfg.num_heads, cfg.head_dim, dtype=cache["k"].dtype)
    assert fa.decode_plan(q, cache["k"], cache["v"]).chunks == 2
    # a batch row or a prefix of the keys is a view with the same strides
    assert fa.decode_plan(q[1:2], cache["k"][1:2], cache["v"][1:2]).chunks == 2
    assert fa.decode_plan(q, cache["k"][:, :, :40], cache["v"][:, :, :40]).chunks == 1


# --- the split-and-combine arithmetic ---------------------------------------

# label: (B, H, Hk, S, D, lengths, window, Pallas block_kv)
CASES = {
    "lengths 0, 1, S and above S": (4, 4, 2, 100, 16, [0, 1, 100, 150], None, 20),
    "window edges inside chunks": (3, 4, 2, 100, 16, [100, 70, 30], 20, 20),
    "every chunk empty": (2, 4, 2, 100, 16, [0, 0], None, 20),
    "G 16": (2, 16, 1, 100, 32, [100, 61], None, 25),
    "S 128 two whole chunks": (2, 2, 2, 128, 16, [128, 64], 100, 32),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_the_split_matches_pallas_and_the_plain_version(case, dtype):
    b, h, hk, s, d, lens, window, block_kv = CASES[case]
    rng = np.random.default_rng(25)
    jdt, tdt = DTYPES[dtype]
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(b, hk, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hk, s, d)).astype(np.float32)
    length = np.asarray(lens, np.int32)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    tl = torch.from_numpy(length)
    pallas = np.asarray(flash_decode_pallas(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), length=jnp.asarray(length),
        window=window, block_kv=block_kv, interpret=True), np.float32)
    live = length > 0
    plain = tref.decode_attention_ref(tq[live], tk[live], tv[live], length=tl[live],
                                      window=window).float().numpy()
    # the kernel's chunk, and a smaller one so that S = 100 spans several
    for chunk in (fa.DECODE_CHUNK, 16):
        got = split_decode(tq, tk, tv, tl, window, chunk).numpy()
        np.testing.assert_allclose(got, pallas, **TOL[dtype], err_msg=f"pallas, chunk {chunk}")
        np.testing.assert_allclose(got[live], plain, **TOL[dtype], err_msg=f"plain, chunk {chunk}")
        assert not got[~live].any(), "a row with no live key is not 0"


def test_the_combine_does_not_depend_on_the_batch():
    """Each row's partials and their combine see only that row: the model
    at B 1 gives the B 4 rows bit for bit."""
    rng = np.random.default_rng(26)
    b, h, hk, s, d = 4, 8, 2, 200, 32
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((b, h, d), (b, hk, s, d), (b, hk, s, d)))
    length = torch.tensor([200, 3, 129, 64], dtype=torch.int32)
    full = split_decode(q, k, v, length, None, fa.DECODE_CHUNK)
    for i in range(b):
        one = split_decode(q[i:i + 1], k[i:i + 1], v[i:i + 1], length[i:i + 1], None,
                           fa.DECODE_CHUNK)
        assert torch.equal(one, full[i:i + 1])
