"""Direct convolution through PARLOOPER and BRGEMM TPPs (paper §III-B,
Listing 4), and K12, the 1×1 convolution on K1.

A port of ``repro/kernels/conv.py``.  Two paths:
  * ``conv2d_parlooper``: Listing 4's seven logical loops (n, c, k, h, w, r,
    s) declared with PARLOOPER and run by the executor; its body zeroes on
    the first (c, r, s) visit and batch-reduces the input patches against
    the weights.  Where the reference does cb·r·s separate dots, each body
    call here does one ``tpp.brgemm`` over the stacked (c, r, s) patches:
    the same sum within fp32 tolerance, in r·s·cb times fewer launches on
    the card.  This path is no kernel.
  * ``conv2d_1x1`` (K12, replacing ``conv2d_1x1_pallas``): R = S = 1 is a
    stride-based BRGEMM, a plain product over the collapsed spatial dims;
    the strided subsample and the reshape of the reference, then K1 under
    the spec string.  It reads the blocked layouts through that reshape
    (copies); reading them in place is later speed work.

Blocked layouts (paper lines 1–3): I (N, Cb, H, W, bc); W (Kb, Cb, R, S, bc,
bk); O (N, Kb, P, Q, bk).
"""
from __future__ import annotations

import torch

from repro_torch.core import tpp
from repro_torch.core.loops import LoopSpec, ThreadedLoop
from repro_torch.kernels import brgemm, ref

__all__ = ["conv2d_parlooper", "conv2d_1x1", "block_conv_tensors", "LAUNCHES"]

# Calls of K12 that launched K1 on the card since import (or a reset).
LAUNCHES = 0


def block_conv_tensors(x_nhwc, w_rsck, bc: int, bk: int):
    """NHWC/HWIO → the paper's blocked layouts (views; permuted, not
    copied)."""
    n, h, w, c = x_nhwc.shape
    r, s, c2, k = w_rsck.shape
    assert c % bc == 0 and k % bk == 0 and c2 == c
    xb = x_nhwc.reshape(n, h, w, c // bc, bc).permute(0, 3, 1, 2, 4)
    wb = w_rsck.reshape(r, s, c // bc, bc, k // bk, bk).permute(4, 2, 0, 1, 3, 5)
    return xb, wb  # (N, Cb, H, W, bc), (Kb, Cb, R, S, bc, bk)


def conv2d_parlooper(xb, wb, *, spec_string: str = "abcdefg", stride: int = 1,
                     w_step: int | None = None, out_dtype=None, mode: str = "auto"):
    """Forward convolution, Listing 4.  xb (N, Cb, H, W, bc); wb (Kb, Cb, R,
    S, bc, bk) → (N, Kb, P, Q, bk) in ``out_dtype`` (default xb's dtype),
    VALID, an fp32 sum per body call.

    Logical loops: a=n, b=c (in-feature blocks, reduction), c=k (out-feature
    blocks), d=h (P rows), e=w (Q column tiles of ``w_step``), f=r, g=s (f,
    g reductions); c, r and s each take one step over their whole extent,
    so a body call batch-reduces every (c, r, s) patch at once.  The output
    is written in place."""
    n, cb, h, w, bc = xb.shape
    kb, cb2, r, s, bc2, bk = wb.shape
    assert cb == cb2 and bc == bc2
    p = (h - r) // stride + 1
    q = (w - s) // stride + 1
    w_step = w_step or q
    assert q % w_step == 0
    out_dtype = out_dtype or xb.dtype

    loops = [
        LoopSpec(0, n, 1, name="n"),
        LoopSpec(0, cb, cb, name="c"),   # fold all C blocks into one BRGEMM
        LoopSpec(0, kb, 1, name="k"),
        LoopSpec(0, p, 1, name="h"),
        LoopSpec(0, q, w_step, name="w"),
        LoopSpec(0, r, r, name="r"),     # fold R, S into the BRGEMM (offsets)
        LoopSpec(0, s, s, name="s"),
    ]
    tl = ThreadedLoop(loops, spec_string, reduction_letters=("b", "f", "g"))
    span = (w_step - 1) * stride + 1

    def body(ind, out):
        i_n, i_c, i_k, i_h, i_w, i_r, i_s = ind
        # the (c, r, s) patches, each (w_step, bc): input row i_h*stride + dr,
        # columns from i_w*stride + ds strided by `stride`
        patches = torch.stack([
            xb[i_n, :, i_h * stride + dr, i_w * stride + ds:i_w * stride + ds + span:stride]
            for dr in range(r) for ds in range(s)], 1)          # (cb, r·s, w_step, bc)
        wt = wb[i_k].reshape(cb * r * s, bc, bk)                 # (c, r, s) order
        acc = tpp.brgemm(patches.reshape(cb * r * s, w_step, bc), wt,
                         out_dtype=torch.float32)
        dst = out[i_n, i_k, i_h, i_w:i_w + w_step]
        if i_c == 0 and i_r == 0 and i_s == 0:
            dst.copy_(acc)
        else:
            dst.copy_(dst.float() + acc)
        return out

    out0 = torch.zeros(n, kb, p, q, bk, dtype=out_dtype, device=xb.device)
    return tl(body, carry=out0, mode=mode)


def conv2d_1x1(xb, wb, *, stride: int = 1, out_dtype=None, spec_string: str = "bca"):
    """K12: the R = S = 1 convolution of blocked xb (N, Cb, H, W, bc) with wb
    (Kb, Cb, 1, 1, bc, bk) → (N, Kb, P, Q, bk) in ``out_dtype`` (default
    xb's dtype), as (N·P·Q, C) @ (C, K) under ``spec_string``.  On CUDA
    tensors the product is K1 (``brgemm.matmul``); on CPU tensors its plain
    version, after the same schedule is validated, so an illegal spec
    raises on either."""
    global LAUNCHES
    n, cb, h, w, bc = xb.shape
    kb, _, r, s, _, bk = wb.shape
    assert r == 1 and s == 1
    x = xb[:, :, ::stride, ::stride, :]
    p, q = x.shape[2], x.shape[3]
    xm = x.permute(0, 2, 3, 1, 4).reshape(n * p * q, cb * bc)
    wm = wb[:, :, 0, 0].permute(1, 2, 0, 3).reshape(cb * bc, kb * bk)
    out_dtype = out_dtype or xb.dtype
    if xm.device.type == "cpu" and wm.device.type == "cpu":
        brgemm.schedule(xm.shape[0], xm.shape[1], wm.shape[1], xm.dtype, spec_string)
        om = ref.matmul_ref(xm, wm, out_dtype=out_dtype)
    else:
        om = brgemm.matmul(xm, wm, out_dtype=out_dtype, spec_string=spec_string)
        LAUNCHES += 1
    return om.reshape(n, p, q, kb, bk).permute(0, 3, 1, 2, 4)
