"""Plain PyTorch versions of the kernels, forward and backward.

Each forward mirrors its oracle in ``repro/kernels/ref.py``; each backward
is what XLA's autodiff of that oracle computes (``matmul_bwd_ref``;
``mamba_scan_bwd_ref``, written out as the CUDA kernel walks it) or what
``repro/fusion/autodiff.py``'s recompute backward derives
(``attention_bwd_ref``, on the flash identity of ``flash_bwd_ref``, the
plain version of the backward mainloop that K6 and K5's chained backward
share); ``mlp_ref``, ``bcsr_to_dense``,
``block_spmm_ref``, ``grouped_matmul_ref``, ``brgemm_blocked_ref`` and
``conv2d_ref`` mirror the oracles of the same names;
``grouped_matmul_dx_ref`` and ``grouped_matmul_dw_ref`` are what XLA's
autodiff of the reference's expert einsums computes, per row tile.  On the CPU they are what ``kernels.ops`` runs (``matmul``'s
backward there runs ``matmul_ref`` on transposed views, as K1 reads them on
the card, and the tests hold it against ``matmul_bwd_ref``); on the GPU
they are what ``chip_smoke.py`` holds each CUDA kernel against.  They
compute in fp32 from the stored inputs.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import tpp

__all__ = ["matmul_ref", "matmul_bwd_ref", "brgemm_blocked_ref", "conv2d_ref", "mlp_ref", "bcsr_to_dense", "block_spmm_ref",
           "grouped_matmul_ref", "grouped_matmul_dx_ref", "grouped_matmul_dw_ref", "attention_ref", "attention_chunked", "attention_fwd_ref", "attention_bwd_ref", "flash_bwd_ref",
           "decode_attention_ref", "paged_decode_attention_ref", "mamba_scan_ref",
           "mamba_scan_chunked", "mamba_scan_bwd_ref"]


def matmul_ref(a, b, *, bias=None, activation=None, out_dtype=None):
    """act(a @ b + bias) with an fp32 accumulator, cast to ``out_dtype``."""
    out_dtype = out_dtype or a.dtype
    acc = torch.matmul(a.float(), b.float())
    if bias is not None:
        acc = acc + bias.float()
    if activation is not None:
        acc = tpp.ACTIVATIONS[activation](acc)
    return acc.to(out_dtype)


def matmul_bwd_ref(a, b, dy, *, bias=None, activation=None):
    """Gradients of :func:`matmul_ref` for the output cotangent ``dy``:
    dZ = dy * act'(Z) at the fp32 pre-activation Z = a @ b + bias, then
    dA = dZ @ b^T, dB = a^T @ dZ and dbias = the sum of dZ's rows (None
    without a bias); all fp32."""
    z = None
    if activation is not None:
        z = torch.matmul(a.float(), b.float())
        if bias is not None:
            z = z + bias.float()
    dz = tpp.activation_grad(activation, dy, z if z is not None else dy)
    da = torch.matmul(dz, b.float().T)
    db = torch.matmul(a.float().T, dz)
    return da, db, dz.sum(0) if bias is not None else None


def brgemm_blocked_ref(a, b, *, out_dtype=None):
    """Blocked-layout BRGEMM (paper Listing 1): A (Mb, Kb, bm, bk) × B (Nb,
    Kb, bk, bn) → C (Nb, Mb, bm, bn), summed over (Kb, bk) in fp32 and cast
    once to ``out_dtype`` (default ``a.dtype``)."""
    acc = torch.einsum("mkab,nkbc->nmac", a.float(), b.float())
    return acc.to(out_dtype or a.dtype)


def conv2d_ref(x, w, *, stride=1, out_dtype=None):
    """Direct convolution, NHWC input x (N, H, W, C), HWIO weights w (R, S,
    C, K), VALID padding, ``stride`` on both axes; in fp32, one product of
    the (R, S) shifted and strided views with w[r, s] after another, cast to
    ``out_dtype`` (default ``x.dtype``).  Plain matrix products only, so it
    runs in full fp32 on the card whatever cuDNN's TF32 setting."""
    n, h, wd, c = x.shape
    r, s, _, k = w.shape
    p = (h - r) // stride + 1
    q = (wd - s) // stride + 1
    xf, wf = x.float(), w.float()
    acc = torch.zeros(n, p, q, k, dtype=torch.float32, device=x.device)
    for dr in range(r):
        for ds in range(s):
            view = xf[:, dr:dr + (p - 1) * stride + 1:stride, ds:ds + (q - 1) * stride + 1:stride]
            acc += torch.matmul(view, wf[dr, ds])
    return acc.to(out_dtype or x.dtype)


def mlp_ref(x, weights, biases, *, activation="gelu", out_dtype=None):
    """Cascading fully-connected layers (paper §III-A): each layer
    act(h @ w + b) with an fp32 accumulator, cast to ``out_dtype`` (default
    ``x.dtype``) before the next."""
    act = tpp.ACTIVATIONS[activation]
    h = x
    for w, b in zip(weights, biases):
        acc = torch.matmul(h.float(), w.float()) + b.float()
        h = act(acc).to(out_dtype or x.dtype)
    return h


# Work items of block_spmm_ref gathered and multiplied at once: bounds the
# (items, bk, N) fp32 gather of B's rows at full width.
_SPMM_ITEMS = 4096


def bcsr_to_dense(blocks, row_id, col_id, nrows_b, ncols_b):
    """The dense (nrows_b·bm, ncols_b·bk) matrix of a BCSR work list, in
    ``blocks``' dtype; repeated coordinates add up."""
    nnzb, bm, bk = blocks.shape
    tiles = blocks.new_zeros(nrows_b, ncols_b, bm, bk)
    tiles.index_put_((row_id.long(), col_id.long()), blocks, accumulate=True)
    return tiles.permute(0, 2, 1, 3).reshape(nrows_b * bm, ncols_b * bk)


def block_spmm_ref(blocks, row_id, col_id, b, *, nrows_b, out_dtype=None):
    """C = A_sparse @ B with A a BCSR work list: ``blocks`` (nnzb, bm, bk),
    ``row_id``/``col_id`` (nnzb,) block coordinates, ``b`` (K, N) dense.
    Each item's block times B's rows ``col_id·bk ..`` in fp32, added into
    its block row (a row without items stays zero); → (nrows_b·bm, N) in
    ``out_dtype`` (default ``b.dtype``)."""
    nnzb, bm, bk = blocks.shape
    n = b.shape[1]
    b_tiles = b.reshape(-1, bk, n)
    out = torch.zeros(nrows_b, bm, n, dtype=torch.float32, device=b.device)
    for t0 in range(0, nnzb, _SPMM_ITEMS):
        sl = slice(t0, t0 + _SPMM_ITEMS)
        part = torch.bmm(blocks[sl].float(), b_tiles[col_id[sl].long()].float())
        out.index_add_(0, row_id[sl].long(), part)
    return out.reshape(nrows_b * bm, n).to(out_dtype or b.dtype)


def grouped_matmul_ref(x, group_id, w, *, out_dtype=None):
    """Per-row-tile expert matmul: x (T, d) in T / len(group_id) row tiles,
    ``group_id`` the expert of each tile, w (E, d, f); → (T, f) in
    ``out_dtype`` (default ``x.dtype``), fp32 accumulator."""
    tiles = group_id.shape[0]
    bm = x.shape[0] // tiles
    out = torch.bmm(x.reshape(tiles, bm, -1).float(), w[group_id.long()].float())
    return out.reshape(x.shape[0], w.shape[-1]).to(out_dtype or x.dtype)


def grouped_matmul_dx_ref(dy, group_id, w, *, out_dtype=None):
    """The gradient of ``grouped_matmul_ref`` with respect to x: dy (T, f)
    in ``len(group_id)`` row tiles, w (E, d, f); tile i times the transpose
    of its expert's slab, → (T, d) in ``out_dtype`` (default ``dy.dtype``),
    fp32 accumulator."""
    tiles = group_id.shape[0]
    bm = dy.shape[0] // tiles
    out = torch.bmm(dy.reshape(tiles, bm, -1).float(),
                    w[group_id.long()].float().transpose(1, 2))
    return out.reshape(dy.shape[0], w.shape[1]).to(out_dtype or dy.dtype)


def grouped_matmul_dw_ref(x, group_id, dy, num_experts):
    """The gradient of ``grouped_matmul_ref`` with respect to w: x (T, d)
    and dy (T, f) in ``len(group_id)`` row tiles; each tile's x_tile^T
    dy_tile in fp32, added into its expert's slab by ``index_add_`` (on the
    CPU one tile after another, in tile order) → (num_experts, d, f) fp32,
    zeros for an expert that owns no tile."""
    tiles = group_id.shape[0]
    bm = x.shape[0] // tiles
    part = torch.bmm(x.reshape(tiles, bm, -1).float().transpose(1, 2),
                     dy.reshape(tiles, bm, -1).float())
    out = torch.zeros(num_experts, x.shape[1], dy.shape[1], dtype=torch.float32, device=x.device)
    return out.index_add_(0, group_id.long(), part)


def _masked_scores(q, k, *, causal, window, scale):
    """Scaled fp32 scores (B, H, Sq, Skv) of q against the group-broadcast k,
    and the (Sq, Skv) keep mask; masked scores are -inf.  Masks align the
    ends of the query and key ranges (row i sits at key position
    i + Skv - Sq); ``window`` keeps keys within [i-window+1, i]."""
    sq, d = q.shape[2], q.shape[3]
    skv = k.shape[2]
    g = q.shape[1] // k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kq = k.repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) * scale
    rows = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    return s.masked_fill(~mask, float("-inf")), mask


def attention_ref(q, k, v, *, causal=True, window=None, scale=None,
                  out_dtype=None):
    """q (B, H, Sq, D); k/v (B, Hk, Skv, D) with H % Hk == 0.  A row with
    every key masked gives NaN here (softmax over -inf), 0 in the kernel."""
    s, _ = _masked_scores(q, k, causal=causal, window=window, scale=scale)
    p = torch.softmax(s, dim=-1)
    vq = v.repeat_interleave(q.shape[1] // k.shape[1], dim=1).float()
    o = torch.einsum("bhqk,bhkd->bhqd", p, vq)
    return o.to(out_dtype or q.dtype)


def attention_chunked(q, k, v, *, causal=True, window=None, scale=None,
                      block_q: int = 256, out_dtype=None):
    """:func:`attention_ref` in query blocks, so that one (B, Hk, g, bq,
    Skv) block of scores is live at a time: the port's copy of
    ``repro/kernels/ref.py::attention_xla_chunked``.  ``bq`` is ``block_q``
    (128 once Skv >= 32768), halved until it divides Sq.  GQA groups each
    kv head's g query heads instead of repeating k and v; v's head dim may
    differ from q's.  Where a gradient is wanted each block runs under
    ``torch.utils.checkpoint``, so the backward recomputes its scores.
    Computes in fp32 from the stored inputs, as every plain version here
    (the reference rounds P to v's dtype: the same at fp32)."""
    b, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    vd, g = v.shape[-1], h // hk
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    bq = min(block_q, 128 if skv >= 32768 else block_q)
    while sq % bq:
        bq //= 2
    off = skv - sq
    qg = q.reshape(b, hk, g, sq, d)
    kf, vf = k.float(), v.float()
    cols = torch.arange(skv, device=q.device)[None, :]

    def block(qb, kf, vf, i0):
        s = torch.einsum("bhgqd,bhkd->bhgqk", qb.float(), kf) * scale
        rows = (i0 + off) + torch.arange(qb.shape[3], device=q.device)[:, None]
        mask = torch.ones(qb.shape[3], skv, dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (cols <= rows)
        if window is not None:
            mask = mask & (cols > rows - window)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        return torch.einsum("bhgqk,bhkd->bhgqd", p, vf).to(out_dtype or q.dtype)

    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    blocks = []
    for i0 in range(0, sq, bq):
        qb = qg[:, :, :, i0:i0 + bq]
        blocks.append(checkpoint(block, qb, kf, vf, i0, use_reentrant=False)
                      if grad else block(qb, kf, vf, i0))
    return torch.cat(blocks, dim=3).reshape(b, h, sq, vd)


def attention_fwd_ref(q, k, v, *, causal=True, window=None, scale=None):
    """:func:`attention_ref` and each row's log-sum-exp of its scaled, masked
    scores, lse (B, H, Sq) fp32 (-inf for a row with every key masked): the
    training forward, whose lse the backward recomputes P from."""
    s, _ = _masked_scores(q, k, causal=causal, window=window, scale=scale)
    o = attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    return o, torch.logsumexp(s, dim=-1)


def attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=None,
                      scale=None):
    """Gradients of the attention for the output cotangent ``do``, from the
    forward's output ``o`` and row log-sum-exp ``lse``: :func:`flash_bwd_ref`
    on K6's epilogue, the scores scaled and masked (-inf) as
    :func:`attention_fwd_ref` masks them, their derivative the scale.
    → (dq, dk, dv) fp32.  A row with every key masked gets zero gradients."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    _, mask = _masked_scores(q[..., :1, :, :], k[..., :1, :, :], causal=causal, window=window,
                             scale=scale)
    return flash_bwd_ref(q, k, v, o, lse, do,
                         pre=lambda s: torch.where(mask, s * scale, float("-inf")),
                         grad=lambda dz, s: dz * scale)


def flash_bwd_ref(q, k, v, o, lse, do, *, pre, grad):
    """The attention backward by the flash identity, from the forward's
    output ``o`` and row log-sum-exp ``lse`` (B, H, Sq): S = q k^T in fp32
    (k and v broadcast over each kv head's group), P = exp(pre(S) - lse)
    where pre leaves a live score (above -1e29, the mask fill's floor) and
    lse is finite, else 0; dP = dO v^T, dZ = P * (dP - D) with D =
    rowsum(dO * O) (the softmax gradient of ``repro/fusion/autodiff.py``'s dz
    graph), dS = grad(dZ, S); dQ = dS k, dK = dS^T q and dV = P^T dO, the
    last two summed over each kv head's group of query heads.  ``pre(S)``
    and ``grad(dZ, S)`` act on fp32 (B, H, Sq, Skv) tensors: the epilogue
    of csrc/attention_bwd.cuh.  → (dq, dk, dv) fp32."""
    b, h, sq, d = q.shape
    hk, skv = k.shape[1], k.shape[2]
    g = h // hk
    qf, dof = q.float(), do.float()
    kq = k.repeat_interleave(g, dim=1).float()
    vq = v.repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kq)
    z = pre(s)
    lse = lse.float()[..., None]
    live = (z > -1e29) & torch.isfinite(lse)
    p = torch.where(live, torch.exp(z - lse), torch.zeros((), device=q.device))
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vq)
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = grad(p * (dp - delta), s)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kq)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return (dq, dk.view(b, hk, g, skv, d).sum(2), dv.view(b, hk, g, skv, d).sum(2))


def decode_attention_ref(q, k_cache, v_cache, *, length=None, window=None,
                         out_dtype=None):
    """One query token: q (B, H, D); caches (B, Hk, S, D); ``length`` (B,)
    valid prefix lengths (None = the whole cache); ``window`` keeps keys in
    [length-window, length).  Like the reference, p is cast to the cache
    dtype before p @ V."""
    b, h, d = q.shape
    hk = k_cache.shape[1]
    g = h // hk
    qg = q.reshape(b, hk, g, d).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.float()) / math.sqrt(d)
    if length is not None:
        cols = torch.arange(k_cache.shape[2], device=q.device)[None, None, None, :]
        lens = length.to(q.device)[:, None, None, None]
        mask = cols < lens
        if window is not None:
            mask = mask & (cols >= lens - window)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(b, h, d).to(out_dtype or q.dtype)


def paged_decode_attention_ref(q, k_pool, v_pool, page_table, *, page_size,
                               length, window=None, out_dtype=None):
    """One query token over token-major page pools: q (B, H, D); pools
    (P, page_size, Hk, D) shared by every slot; ``page_table`` (B, maxp)
    names each slot's pages (the trash page in unused entries); ``length``
    (B,) valid prefix lengths.  Gathers each slot's pages, swaps them to the
    head-major cache layout and calls :func:`decode_attention_ref`, which
    masks the positions past ``length``."""
    b, maxp = page_table.shape
    s = maxp * page_size
    idx = page_table.long()
    k = k_pool[idx].reshape(b, s, k_pool.shape[2], -1).transpose(1, 2)
    v = v_pool[idx].reshape(b, s, v_pool.shape[2], -1).transpose(1, 2)
    return decode_attention_ref(q, k, v, length=length, window=window,
                                out_dtype=out_dtype)


def mamba_scan_ref(x, dt, a, b_in, c_in, d_skip, *, h0=None):
    """Selective state-space scan (Mamba-1): x, dt (B, L, D); a (D, N), the
    negative decay rates; b_in, c_in (B, L, N); d_skip (D,); h0 (B, D, N)
    the state to continue from (zeros when None).  Per step, in fp32:
    h <- h * exp(dt A) + (dt B) x and y = h C; then y + D x, cast to x's
    dtype.  → (y (B, L, D), h_final (B, D, N) fp32).
    A loop over time, one length or another; ``h0`` is not modified."""
    bsz, l, dch = x.shape
    n = a.shape[1]
    xf, dtf = x.float(), dt.float()
    bf, cf = b_in.float(), c_in.float()
    af = a.float()
    h = (torch.zeros(bsz, dch, n, device=x.device) if h0 is None else h0.float())
    ys = []
    for t in range(l):
        dtt = dtf[:, t, :, None]                             # (B, D, 1)
        h = h * torch.exp(dtt * af) + dtt * bf[:, t, None, :] * xf[:, t, :, None]
        ys.append((h * cf[:, t, None, :]).sum(-1))
    y = (torch.stack(ys, 1) if ys else xf.new_zeros(bsz, 0, dch)) + xf * d_skip.float()
    return y.to(x.dtype), h


def mamba_scan_chunked(x, dt, a, b_in, c_in, d_skip, *, h0=None, chunk=64, states=False):
    """The selective scan in chunks of ``chunk`` steps (halved while it
    does not divide L, as the reference's ``mamba_scan_xla_chunked``): an
    outer loop over the chunks, each chunk's body under
    ``torch.utils.checkpoint`` when autograd records it, so that only the
    fp32 (B, D, N) state crosses a chunk boundary and the backward
    recomputes a chunk's steps.  Arguments and result as
    :func:`mamba_scan_ref`; with ``states`` also (B, chunks, D, N) fp32,
    the state entering each chunk (``h0`` or zeros first), and the chunk
    length used."""
    bsz, l, dch = x.shape
    n = a.shape[1]
    while l % chunk:
        chunk //= 2
    af, ds = a.float(), d_skip.float()
    h = torch.zeros(bsz, dch, n, device=x.device) if h0 is None else h0.float()

    def body(h, xc, dtc, bc, cc):
        xc, dtc, bc, cc = xc.float(), dtc.float(), bc.float(), cc.float()
        ys = []
        for t in range(xc.shape[1]):
            dtt = dtc[:, t, :, None]
            h = h * torch.exp(dtt * af) + (dtt * xc[:, t, :, None]) * bc[:, t, None, :]
            ys.append((h * cc[:, t, None, :]).sum(-1))
        return h, (torch.stack(ys, 1) + xc * ds).to(x.dtype)

    ys, bounds = [], []
    record = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, dt, a, b_in, c_in, d_skip, h0))
    for i in range(l // chunk if l else 0):
        sl = slice(i * chunk, (i + 1) * chunk)
        bounds.append(h)
        args = (h, x[:, sl], dt[:, sl], b_in[:, sl], c_in[:, sl])
        h, y = checkpoint(body, *args, use_reentrant=False) if record else body(*args)
        ys.append(y)
    y = torch.cat(ys, 1) if ys else x.new_zeros(bsz, 0, dch)
    if not states:
        return y, h
    return y, h, torch.stack(bounds, 1) if bounds else h.new_zeros(bsz, 0, dch, n), chunk


def mamba_scan_bwd_ref(x, dt, a, b_in, c_in, d_skip, h0, states, dy, dh_final=None, *, chunk):
    """The selective scan's backward, written as the CUDA kernel
    (``csrc/mamba_scan.cu`` ``mamba_scan_bwd_kernel``) walks it, in plain
    fp32 tensor arithmetic (not autograd of the forward).  ``states`` (B,
    chunks, D, N) holds the state entering each chunk of ``chunk`` steps
    (the last chunk may be shorter); ``dy`` (B, L, D) is y's cotangent and
    ``dh_final`` (B, D, N) or None h_final's.  The chunks are walked in
    reverse: each recomputes its states from its boundary state, then steps
    back through them carrying g = dL/dh, with a_t = exp(dt_t A):

        g += dy_t C_t;  dC_t = sum_d dy_t h_t;  dx_t = dt_t sum_n g B_t + D dy_t;
        ddt_t = sum_n g (x_t B_t + A a_t h_{t-1});  dB_t = sum_d g dt_t x_t;
        dA += g dt_t a_t h_{t-1};  dD += dy_t x_t;  g <- a_t g.

    → (dx, ddt in x's and dt's dtypes, dA (D, N) fp32, dB, dC (B, L, N) in
    b_in's and c_in's dtypes, dD (D,) fp32, dh0 (B, D, N) fp32: the last
    g).  ``h0`` is unused (the first boundary state holds it) and kept for
    the kernel's signature."""
    del h0
    bsz, l, dch = x.shape
    n = a.shape[1]
    xf, dtf, bf, cf, dyf = x.float(), dt.float(), b_in.float(), c_in.float(), dy.float()
    af, ds = a.float(), d_skip.float()
    g = (torch.zeros(bsz, dch, n, device=x.device) if dh_final is None
         else dh_final.float().clone())
    dx, ddt = torch.empty_like(xf), torch.empty_like(xf)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    da = torch.zeros(dch, n, device=x.device)
    for i in reversed(range(states.shape[1])):
        t0, t1 = i * chunk, min(l, (i + 1) * chunk)
        hs = [states[:, i].float()]          # hs[k]: the state before step t0 + k
        for t in range(t0, t1):
            dtt = dtf[:, t, :, None]
            hs.append(hs[-1] * torch.exp(dtt * af)
                      + (dtt * xf[:, t, :, None]) * bf[:, t, None, :])
        for t in reversed(range(t0, t1)):
            dtt, xt, dyt = dtf[:, t, :, None], xf[:, t, :, None], dyf[:, t, :, None]
            bt, ct = bf[:, t, None, :], cf[:, t, None, :]
            dec = torch.exp(dtt * af)
            h_prev, h_cur = hs[t - t0], hs[t - t0 + 1]
            g = g + dyt * ct
            dc[:, t] = (dyt * h_cur).sum(1)
            dx[:, t] = dtt[..., 0] * (g * bt).sum(-1) + ds * dyt[..., 0]
            ddt[:, t] = (g * (xt * bt + af * dec * h_prev)).sum(-1)
            db[:, t] = (g * (dtt * xt)).sum(1)
            da += (g * dtt * dec * h_prev).sum(0)
            g = g * dec
    dd = (dyf * xf).sum((0, 1))
    return (dx.to(x.dtype), ddt.to(dt.dtype), da, db.to(b_in.dtype), dc.to(c_in.dtype), dd, g)
