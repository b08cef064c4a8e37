"""K4's launch plan and its split-and-combine arithmetic over the page table
on the CPU (no GPU, no nvcc needed).

``flash_attention.paged_decode_plan`` is what the wrapper hands the CUDA
entry point (``csrc/paged_decode.cu``): the key positions are cut into
fixed chunks of ``DECODE_CHUNK`` positions, the source's ``kChunk``, a
constant that depends neither on B nor on the page size, so a decoded slot
has the same bits in any batch; pools the kernel's 16-byte loads cannot
read in place raise.
``split_paged_decode`` below repeats the kernel's arithmetic in torch fp32:
each chunk of key positions finds its keys' pool rows through the table
(page ids clamped to [0, P]), takes the softmax over its live keys (m, l,
acc), then the chunks are combined in chunk order.  It is held against the
reference's ``paged_decode_attention`` on XLA and on the Pallas kernel in
interpret mode, and against the port's plain ``paged_decode_attention_ref``,
at fp32 tolerance 1e-4 and bf16 rtol 2e-2 / atol 2e-1 (those of
``tests/test_kernels.py``: one bf16 rounding of the output, and the
reference rounds p to bf16 before p @ V where the kernel does not).  A slot
with no live key gives 0 (the kernel's and the Pallas kernel's l floor);
the plain versions' softmax has no key there, so those rows are held
against the Pallas kernel only.  Page ids past the pool are held against
the reference alone: its gather clamps them, the port's plain gather
(torch indexing) refuses them.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as tref

TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-1)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _operands(b, h, hk, d, ps, maxp, pages=20, dtype=torch.bfloat16):
    q = torch.zeros(b, h, d, dtype=dtype)
    pool = torch.zeros(pages + 1, ps, hk, d, dtype=dtype)
    return q, pool, pool.clone(), torch.zeros(b, maxp, dtype=torch.int32)


def _plan(b, h, hk, d, ps, maxp, dtype=torch.bfloat16):
    q, k, v, table = _operands(b, h, hk, d, ps, maxp, dtype=dtype)
    return fa.paged_decode_plan(q, k, v, table, page_size=ps)


def split_paged_decode(q, k_pool, v_pool, table, length, ps, window, chunk):
    """The split kernel's arithmetic in fp32: for each (slot, kv head) and
    each chunk of ``chunk`` key positions, the live keys' rows through the
    table (page id clamped to [0, P]), their scores s, m_c = max s, p =
    e^(s - m_c), l_c = sum p, acc_c = p @ V (an empty chunk: m_c = -1e30,
    l_c = 0); then, in chunk order, m* = max m_c, l = sum l_c e^(m_c - m*),
    o = sum acc_c e^(m_c - m*) / max(l, 1e-30)."""
    b, h, d = q.shape
    last, hk = k_pool.shape[0] - 1, k_pool.shape[2]
    g = h // hk
    keys = table.shape[1] * ps
    qg, kf, vf = q.float().reshape(b, hk, g, d), k_pool.float(), v_pool.float()
    scale = 1.0 / math.sqrt(d)
    chunks = max(1, -(-keys // chunk))
    out = torch.zeros(b, hk, g, d)
    for bi in range(b):
        n = min(max(int(length[bi]), 0), keys)
        lo = max(n - window, 0) if window else 0
        for kh in range(hk):
            parts = []
            for c in range(chunks):
                c0 = c * chunk
                beg, end = max(lo - c0, 0), min(n - c0, chunk)
                if beg >= end:
                    parts.append((torch.full((g,), -1e30), torch.zeros(g), torch.zeros(g, d)))
                    continue
                t = torch.arange(c0 + beg, c0 + end)
                page = table[bi, t // ps].long().clamp(0, last)
                kr, vr = kf[page, t % ps, kh], vf[page, t % ps, kh]
                sc = qg[bi, kh] @ kr.T * scale
                m = sc.max(-1).values
                p = torch.exp(sc - m[:, None])
                parts.append((m, p.sum(-1), p @ vr))
            mstar = torch.stack([m for m, _, _ in parts]).max(0).values
            l, o = torch.zeros(g), torch.zeros(g, d)
            for m, lc, acc in parts:
                w = torch.where(lc > 0, torch.exp(m - mstar), torch.zeros(g))
                l = l + lc * w
                o = o + acc * w[:, None]
            out[bi, kh] = o / torch.clamp(l, min=1e-30)[:, None]
    return out.reshape(b, h, d)


# --- the plan ---------------------------------------------------------------

@pytest.mark.parametrize("ps", [4, 8, 16])
@pytest.mark.parametrize("b", [1, 2, 3, 8])
def test_the_chunk_depends_on_neither_the_batch_nor_the_page_size(b, ps):
    maxp = 1024 // ps
    plan = _plan(b, 40, 40, 128, ps, maxp)
    one = _plan(1, 40, 40, 128, 16, 64)
    assert plan.kernel == one.kernel == "paged_decode_split_kernel"
    assert plan.chunk == one.chunk == fa.DECODE_CHUNK
    assert plan.chunks == one.chunks == 16 and plan.smem_bytes == one.smem_bytes
    assert plan.grid == (16, 40, b)


def test_the_plan_chunk_is_the_source_chunk():
    """The wrapper sizes the workspace by DECODE_CHUNK; the kernel cuts the
    key positions by its own constant (checked again against the library
    on the card)."""
    src = (Path(fa.__file__).resolve().parent / "csrc" / "paged_decode.cu").read_text()
    assert re.findall(r"constexpr int kChunk = (\d+);", src) == [str(fa.DECODE_CHUNK)]


@pytest.mark.parametrize("maxp, ps, chunks", [(64, 16, 16), (8, 4, 1), (17, 4, 2), (13, 8, 2),
                                              (1, 16, 1), (0, 16, 1), (65, 16, 17)])
def test_chunk_count_and_workspace(maxp, ps, chunks):
    b, h, hk, d = 8, 40, 8, 128
    plan = _plan(b, h, hk, d, ps, maxp)
    assert fa.DECODE_CHUNK == 64
    assert plan.chunks == chunks
    # fp32 (m, l, acc) a (slot, query head, chunk); one chunk is written directly
    assert plan.workspace_bytes == (4 * b * h * chunks * (d + 2) if chunks > 1 else 0)
    assert plan.grid == (chunks, hk, b)


def test_the_engine_shape():
    """llama2-13b's engine (8 slots, 40 kv heads, pages of 16, 64 pages a
    slot): 5120 blocks of 64 key positions."""
    plan = _plan(8, 40, 40, 128, 16, 64)
    assert plan.grid == (16, 40, 8) and math.prod(plan.grid) == 5120


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", fa.PAGED_HEAD_DIMS)
def test_shared_memory_fits_at_the_largest_group(d, dtype):
    g = min(16, 2048 // d)
    plan = _plan(2, g, 1, d, 16, 8, dtype)
    size = torch.finfo(dtype).bits // 8
    chunk = plan.chunk
    assert plan.smem_bytes == size * (g * d + 2 * chunk * d) + 4 * (2 * g * chunk + 2 * g)
    assert plan.smem_bytes <= fa.SMEM_LIMIT


def test_group_and_head_dim_limits():
    with pytest.raises(ValueError, match="head dim"):
        _plan(1, 2, 1, 48, 16, 4)
    with pytest.raises(ValueError, match="exceeds one block"):
        _plan(1, 32, 1, 64, 16, 4)
    with pytest.raises(ValueError, match="exceeds one block"):
        _plan(1, 16, 1, 256, 16, 4)
    assert _plan(1, 8, 1, 256, 16, 4).chunks == 1


def _bad_pool(which, dtype):
    """A (21, 4, 2, 16) pool of ``dtype`` off by 8 bytes, or a view whose
    rows are not contiguous."""
    shape = (21, 4, 2, 16)
    n = math.prod(shape)
    if which == "base":
        off = 64 // torch.finfo(dtype).bits     # 8 bytes
        return torch.zeros(n + off, dtype=dtype)[off:].view(shape)
    if which == "head dim sliced":
        return torch.zeros(*shape[:3], 32, dtype=dtype)[..., :16]
    return torch.zeros(4, 21, 2, 16, dtype=dtype).transpose(0, 1)   # pages not outermost


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("which", ["base", "head dim sliced", "transposed"])
def test_pools_the_16_byte_loads_cannot_read_are_refused(which, dtype):
    bad = _bad_pool(which, dtype)
    good = torch.zeros(bad.shape, dtype=dtype)
    q, table = torch.zeros(2, 4, 16, dtype=dtype), torch.zeros(2, 8, dtype=torch.int32)
    assert fa.paged_decode_plan(q, good, good, table, page_size=4).chunks == 1
    for k, v in ((bad, good), (good, bad)):
        with pytest.raises(ValueError, match="16-byte loads"):
            fa.paged_decode_plan(q, k, v, table, page_size=4)


def test_pools_of_another_page_size_are_refused():
    q, k, v, table = _operands(2, 4, 2, 16, 4, 8)
    with pytest.raises(ValueError, match="page_size"):
        fa.paged_decode_plan(q, k, v, table, page_size=8)
    with pytest.raises(ValueError, match="page_size"):
        fa.paged_decode_plan(q, k, v[:, :, :1].contiguous(), table, page_size=4)


# --- the split-and-combine arithmetic ---------------------------------------

# label: (B, H, Hk, D, page size, max pages, pool pages, lengths, window)
CASES = {
    "GQA, ragged lengths over several chunks, ps 4": (4, 4, 2, 16, 4, 40, 100, [150, 1, 64, 97], None),
    "window edges inside chunks, ps 8": (3, 4, 2, 16, 8, 20, 40, [150, 70, 30], 20),
    "a slot of length 0, ps 16": (3, 4, 4, 32, 16, 8, 20, [0, 128, 65], None),
    "G 16": (2, 16, 1, 32, 8, 10, 20, [80, 61], None),
    "D 256, window, ps 4": (2, 2, 2, 256, 4, 12, 20, [45, 6], 16),
}


def _table(lens, ps, maxp, pages, rng, past=None):
    """(B, maxp) int32 table over a shuffled pool of ``pages`` pages: each
    slot owns ceil(len / ps) of them, the rest of its row the trash page
    (``pages``) or, with ``past``, that id (out of the pool)."""
    perm = rng.permutation(pages)
    table = np.full((len(lens), maxp), pages if past is None else past, np.int32)
    used = 0
    for i, n in enumerate(lens):
        k = -(-n // ps)
        table[i, :k] = perm[used:used + k]
        used += k
    return table


def _inputs(case, dtype, seed):
    b, h, hk, d, ps, maxp, pages, lens, window = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(pages + 1, ps, hk, d)).astype(np.float32)
    v = rng.normal(size=(pages + 1, ps, hk, d)).astype(np.float32)
    return q, k, v, _table(lens, ps, maxp, pages, rng), np.asarray(lens, np.int32), ps, window


def _reference(q, k, v, table, length, ps, window, dtype, backend):
    jdt = DTYPES[dtype][0]
    out = jops.paged_decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(table),
        page_size=ps, length=jnp.asarray(length), window=window, backend=backend, block_kv=16)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_the_split_matches_the_reference_and_the_plain_version(case, dtype):
    q, k, v, table, length, ps, window = _inputs(case, dtype, 26)
    tdt = DTYPES[dtype][1]
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    tt, tl = torch.from_numpy(table), torch.from_numpy(length)
    live = length > 0
    plain = tref.paged_decode_attention_ref(tq[live], tk, tv, tt[live], page_size=ps,
                                            length=tl[live], window=window).float().numpy()
    pallas = _reference(q, k, v, table, length, ps, window, dtype, "pallas_interpret")
    xla = _reference(q[live], k, v, table[live], length[live], ps, window, dtype, "xla")
    # the kernel's chunk, and a smaller one so that the tables span more chunks
    for chunk in (fa.DECODE_CHUNK, 16):
        got = split_paged_decode(tq, tk, tv, tt, tl, ps, window, chunk).numpy()
        np.testing.assert_allclose(got, pallas, **TOL[dtype], err_msg=f"pallas, chunk {chunk}")
        np.testing.assert_allclose(got[live], xla, **TOL[dtype], err_msg=f"xla, chunk {chunk}")
        np.testing.assert_allclose(got[live], plain, **TOL[dtype], err_msg=f"plain, chunk {chunk}")
        assert not got[~live].any(), "a slot with no live key is not 0"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_page_ids_past_the_pool_are_clamped(dtype):
    """Live keys whose table entry lies past the pool read the last page
    (the trash page), as the reference's gather clamps; entries past a
    slot's pages are never used."""
    b, h, hk, d, ps, maxp, pages, lens, window = CASES["GQA, ragged lengths over several chunks, ps 4"]
    rng = np.random.default_rng(27)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k = rng.normal(size=(pages + 1, ps, hk, d)).astype(np.float32)
    v = rng.normal(size=(pages + 1, ps, hk, d)).astype(np.float32)
    table = _table(lens, ps, maxp, pages, rng, past=1 << 30)
    table[0, 3] = pages + 7          # a live key's page id past the pool
    length = np.asarray(lens, np.int32)
    tdt = DTYPES[dtype][1]
    got = split_paged_decode(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                             torch.from_numpy(table), torch.from_numpy(length), ps, window,
                             fa.DECODE_CHUNK).numpy()
    for backend in ("xla", "pallas_interpret"):
        want = _reference(q, k, v, table, length, ps, window, dtype, backend)
        np.testing.assert_allclose(got, want, **TOL[dtype], err_msg=backend)


def test_a_slot_does_not_depend_on_the_batch():
    """Each slot's partials and their combine see only that slot: the model
    at B 1 gives the B 4 rows bit for bit."""
    q, k, v, table, length, ps, window = _inputs("GQA, ragged lengths over several chunks, ps 4",
                                                 "float32", 28)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tt, tl = torch.from_numpy(table), torch.from_numpy(length)
    full = split_paged_decode(tq, tk, tv, tt, tl, ps, window, fa.DECODE_CHUNK)
    for i in range(tq.shape[0]):
        one = split_paged_decode(tq[i:i + 1], tk, tv, tt[i:i + 1], tl[i:i + 1], ps, window,
                                 fa.DECODE_CHUNK)
        assert torch.equal(one, full[i:i + 1])
