#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which must pass:
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, all at once) and print the build time;
  3. hold each kernel (K1 GEMM, K1 on transposed operands, K2 flash
     attention, K6 its backward, K3 flash decode, K4 paged decode) against
     its plain PyTorch version on the card, at the main paths' shapes plus
     GQA, windowed and ragged ones; print error and
     tolerance, the median time over CUDA events, the plain version's time,
     one PyTorch library call's time as a yardstick (the port never calls
     it) and the bound;
  4. run ``generate_loop`` and the serving engine for reduced fp32
     llama2-13b, gpt-j-6b and minicpm-2b on the card (kernels) and on the
     CPU (plain versions): the logits must agree, and the greedy tokens and
     the engine's greedy and sampled tokens must be equal;
  5. serve full-width llama2-13b (bf16, all 40 layers, random weights from a
     seed, batch 4, prompt 512, 16 new tokens) through ``generate_loop`` with
     every launch counter set to 0 just before and read just after: K1, K2
     and K3 must have launched, the logits must be finite;
  6. serve the same model through the continuous-batching engine (8 slots,
     16-token pages, 16 ragged requests, greedy and sampled): paged logits
     must equal dense ones, every request must finish with ``validate()``
     clean after every step, K4 must launch once per layer per decode step,
     and a drain on 3 slots must give the same tokens (schedule invariance);
  7. train reduced fp32 minicpm-2b and gpt-j-6b for 3 steps on the card and
     on the CPU from one initial state (loss and grad norm must agree), and
     check that 2 steps + checkpoint + restore + 2 steps give the parameters
     of 4 steps straight, bit for bit;
  8. train minicpm-2b at full width and depth (fp32 masters, bf16 compute,
     B 4 x S 1024, remat) for 6 trainer steps with every launch counter set
     to 0 just before and read just after: losses and grad norms finite, K6
     launched once per layer per step, K1 with a transposed operand; then 3
     steps on one repeated batch, whose loss must fall at each step; print
     step time, tokens/s, model-FLOPs share, bound, peak memory and one
     profiled step's device breakdown;
  9. print one JSON line with every kernel's numbers;
 10. print the last line, ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero before the last line.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published dense peaks by card (NVIDIA data sheets): bf16 tensor-core and
# fp32 non-tensor FLOP/s, HBM bytes/s.
PEAKS = {
    "H100 SXM": {"bf16": 989e12, "fp32": 67e12, "hbm": 3.35e12},
    "H100 PCIe": {"bf16": 756e12, "fp32": 51e12, "hbm": 2.0e12},
}

# Kernel against plain version on the card.  Both sides read the same inputs
# and accumulate in fp32, so they differ by summation order and, in bf16, by
# one rounding of the output (2^-8 relative) and the plain decode's bf16 p.
TOL = {"float32": {"gemm": (1e-4, 1e-3), "attn": (1e-4, 1e-4)},
       "bfloat16": {"gemm": (1e-2, 1e-2), "attn": (1e-2, 1e-2)}}
MODEL_TOL = (1e-4, 1e-3)   # logits, reduced fp32 configs: GPU kernels vs CPU plain

# file:line of the TPU kernel each CUDA kernel replaces: matmul_pallas,
# flash_attention_pallas, flash_decode_pallas and the Pallas path of
# paged_decode_attention.
REPLACES = {
    "gemm": "src/repro/kernels/brgemm.py:58",
    "gemm_transposed": "src/repro/kernels/brgemm.py:58",
    "flash_attention": "src/repro/kernels/flash_attention.py:35",
    "flash_attention_bwd": "src/repro/fusion/autodiff.py:236",
    "flash_decode": "src/repro/kernels/flash_attention.py:169",
    "paged_decode": "src/repro/kernels/ops.py:103",
}
SOURCE = {
    "gemm": "src/repro_torch/kernels/csrc/gemm.cu",
    "gemm_transposed": "src/repro_torch/kernels/csrc/gemm.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_bwd": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "flash_decode": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "paged_decode": "src/repro_torch/kernels/csrc/paged_decode.cu",
}
KERNELS = tuple(SOURCE)
# What each kernel's ms, plain_ms, bound_ms and library_ms add up: the
# weighted cases of phase 3 (library: torch.matmul without the activation;
# scaled_dot_product_attention; for K4, index_select of the pages into a
# dense view plus scaled_dot_product_attention with a length mask).
ROW = {
    "gemm": "one llama2-13b layer's 7 projections at prefill (M 2048) plus one decode step (M 4)",
    "gemm_transposed": "minicpm-2b backward at 4096 tokens: dX of the down-projection, dW of the"
                       " up-projection, and one 2048-row loss chunk's tied logits and dE",
    "flash_attention": "one llama2-13b layer's prefill attention (B 4, H 40, S 512, causal)",
    "flash_attention_bwd": "one minicpm-2b layer's attention backward (B 4, H 36, S 1024, D 64,"
                           " causal)",
    "flash_decode": "one llama2-13b layer's decode attention (B 4, H 40, cache 528, length 520)",
    "paged_decode": "one llama2-13b layer's paged decode attention (B 8, H 40, page 16, lengths 37..1000)",
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name):
    print(f"\n== {name}", flush=True)


def time_ms(torch, fn, warmup=3, reps=10):
    """Median milliseconds of ``fn`` over CUDA events, after warmup."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(torch, got, want, rtol, atol):
    """→ (max abs error, within tolerance); tuples of tensors are compared
    as one flat tensor."""
    torch.cuda.synchronize()
    if isinstance(got, tuple):
        got = torch.cat([t.float().flatten() for t in got])
        want = torch.cat([t.float().flatten() for t in want])
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool((err <= atol + rtol * w.abs()).all())
    return float(err.max()), ok


class Bench:
    """Per-kernel results: each case's numbers, and the sum over the cases
    that make up the kernel's main-path row."""

    def __init__(self, torch, peaks):
        self.torch = torch
        self.peaks = peaks
        self.cases = {name: [] for name in KERNELS}

    def bound(self, flops, nbytes, kind):
        t_ops = flops / self.peaks[kind]
        t_bytes = nbytes / self.peaks["hbm"]
        return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"

    def run(self, kernel, label, fn, plain, library, *, flops, nbytes, dtype, tol_kind,
            weight=0, timed=True):
        """Check ``fn()`` against ``plain()``; time kernel, plain version and
        library call; ``weight`` is how often the case occurs in the
        kernel's main-path row (0: a check only)."""
        torch = self.torch
        got = fn()
        torch.cuda.synchronize()
        want = plain()
        rtol, atol = TOL[dtype][tol_kind]
        err, ok = compare(torch, got, want, rtol, atol)
        kind = "bf16" if dtype == "bfloat16" else "fp32"
        bound_ms, bound_by = self.bound(flops, nbytes, kind)
        row = {"case": label, "dtype": dtype, "max_abs_err": err, "rtol": rtol, "atol": atol,
               "weight": weight, "bound_ms": bound_ms, "bound_by": bound_by,
               "ms": None, "plain_ms": None, "library_ms": None}
        if timed:
            row["ms"] = time_ms(torch, fn)
            row["plain_ms"] = time_ms(torch, plain, warmup=1, reps=3)
            row["library_ms"] = time_ms(torch, library) if library is not None else None
        self.cases[kernel].append(row)
        print(f"  {kernel:15s} {label:38s} max_abs_err {err:.3e} (rtol {rtol}, atol {atol})"
              + (f"  kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms"
                 f"  library {row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 4)} ms"
                 f"  bound {bound_ms:.4f} ms ({bound_by})" if timed else ""), flush=True)
        check(ok, f"{kernel} {label}: kernel disagrees with its plain version "
                  f"(max abs err {err:.3e}, rtol {rtol}, atol {atol})")
        return got

    def summary(self, kernel):
        rows = [r for r in self.cases[kernel] if r["weight"]]
        tot = {k: sum(r[k] * r["weight"] for r in rows)
               for k in ("ms", "plain_ms", "bound_ms")}
        lib = [r["library_ms"] for r in rows]
        tot["library_ms"] = (sum(x * r["weight"] for x, r in zip(lib, rows))
                             if all(x is not None for x in lib) else None)
        share = {"operations": 0.0, "bytes": 0.0}
        for r in rows:
            share[r["bound_by"]] += r["bound_ms"] * r["weight"]
        tot["bound_by"] = max(share, key=share.get)
        tot["max_abs_err"] = max(r["max_abs_err"] for r in self.cases[kernel])
        return tot


def gemm_cases(torch, bench, ref, brgemm):
    """K1 at the main path's projections of one llama2-13b layer (prefill
    M = 4 x 512, decode M = 4), plus ragged and fp32 checks."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def operands(m, k, n, dtype, bias=False):
        a = torch.randn(m, k, generator=gen, device=dev).to(dtype)
        b = (torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)).to(dtype)
        c = torch.randn(n, generator=gen, device=dev).to(dtype) if bias else None
        return a, b, c

    d, ff = 5120, 13824
    # (K, N, activation, occurrences per layer): wq wk wv wo | wg (silu) | wu | wd
    layer = [(d, d, None, 4), (d, ff, "silu", 1), (d, ff, None, 1), (ff, d, None, 1)]
    # prefill and generate_loop decode make up K1's row; the engine's decode
    # (M 8) is timed beside them
    for m, phase_name, main in ((2048, "prefill", True), (4, "decode", True),
                                (8, "engine decode", False)):
        for k, n, act, count in layer:
            a, b, _ = operands(m, k, n, torch.bfloat16)
            bench.run("gemm", f"{phase_name} {m}x{k}x{n} {act or ''}",
                      lambda: brgemm.matmul(a, b, activation=act),
                      lambda: ref.matmul_ref(a, b, activation=act),
                      lambda: torch.matmul(a, b),
                      flops=2 * m * n * k, nbytes=2 * (m * k + k * n + m * n),
                      dtype="bfloat16", tol_kind="gemm", weight=count if main else 0)
    # the engine's logits: bf16 operands, fp32 output (library: bf16 out)
    m, k, n = 8, d, 32000
    a, b, _ = operands(m, k, n, torch.bfloat16)
    bench.run("gemm", f"engine logits {m}x{k}x{n} fp32 out",
              lambda: brgemm.matmul(a, b, out_dtype=torch.float32),
              lambda: ref.matmul_ref(a, b, out_dtype=torch.float32),
              lambda: torch.matmul(a, b),
              flops=2 * m * n * k, nbytes=2 * (m * k + k * n) + 4 * m * n,
              dtype="bfloat16", tol_kind="gemm")
    for m, k, n, act, dt in ((37, 200, 100, "gelu", torch.bfloat16),
                             (16, 96, 130, "relu", torch.bfloat16),
                             (70, 300, 96, "sigmoid", torch.float32),
                             (16, 64, 128, "silu", torch.float32)):
        a, b, c = operands(m, k, n, dt, bias=True)
        name = "bfloat16" if dt == torch.bfloat16 else "float32"
        bench.run("gemm", f"check {m}x{k}x{n} bias {act} {name}",
                  lambda: brgemm.matmul(a, b, bias=c, activation=act),
                  lambda: ref.matmul_ref(a, b, bias=c, activation=act), None,
                  flops=2 * m * n * k, nbytes=a.element_size() * (m * k + k * n + m * n),
                  dtype=name, tol_kind="gemm", timed=False)
    # bf16 in, fp32 out, unaligned leading dimension (scalar loads)
    m, k, n = 48, 77, 64
    a, b, _ = operands(m, k, n, torch.bfloat16)
    bench.run("gemm", f"check {m}x{k}x{n} fp32 out",
              lambda: brgemm.matmul(a, b, out_dtype=torch.float32),
              lambda: ref.matmul_ref(a, b, out_dtype=torch.float32), None,
              flops=2 * m * n * k, nbytes=2 * (m * k + k * n) + 4 * m * n,
              dtype="bfloat16", tol_kind="gemm", timed=False)


def gemm_training_cases(torch, bench, ref, brgemm):
    """K1 at minicpm-2b's training shapes for B 4 x S 1024 (4096 tokens;
    the tied logits per 512-token loss chunk, 2048 rows): the forward
    projections and the logits' dX in the plain layout, then the backward's
    products reading one operand transposed in place, plus ragged and fp32
    checks."""
    gen = torch.Generator(device="cuda").manual_seed(9)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    t, d, ff, v, chunk = 4096, 2304, 5760, 122880, 2048
    cases = [  # label, a, b, out dtype, weight (1: the row), timed
        ("dX down-proj (4096x2304)·(5760x2304)^T", randn(t, d), randn(ff, d, scale=ff ** -0.5).T,
         torch.bfloat16, 1, True),
        ("dW up-proj (2304x4096)^T-read·(4096x5760) fp32 out", randn(t, d).T, randn(t, ff),
         torch.float32, 1, True),
        ("logits fwd (2048x2304)·(122880x2304)^T fp32 out", randn(chunk, d),
         randn(v, d, scale=0.02).T, torch.float32, 1, True),
        ("dE logits (122880x2048)^T-read·(2048x2304) fp32 out", randn(chunk, v, scale=1e-3).T,
         randn(chunk, d), torch.float32, 1, True),
        ("check ragged (77x40)^T·(100x77)^T bf16", randn(40, 77).T, randn(100, 40).T,
         torch.bfloat16, 0, False),
        ("check M 9 (33x9)^T·(33x50) fp32 out", randn(33, 9).T, randn(33, 50), torch.float32, 0,
         False),
        ("check fp32 (70x300)^T·(96x300)^T", randn(300, 70, dtype=torch.float32).T,
         randn(96, 300, dtype=torch.float32).T, torch.float32, 0, False),
    ]
    # The forward projections of a layer (wq wk wv wo | wg (silu) | wu | wd),
    # and dX of the tied logits, which reads the (122880, 2304) embedding as
    # stored: no operand is transposed, so they are K1's plain layout.
    for k, n, act in ((d, d, None), (d, ff, "silu"), (d, ff, None), (ff, d, None)):
        x, w = randn(t, k), randn(k, n, scale=k ** -0.5)
        bench.run("gemm", f"train fwd {t}x{k}x{n} {act or ''}",
                  lambda: brgemm.matmul(x, w, activation=act),
                  lambda: ref.matmul_ref(x, w, activation=act),
                  lambda: torch.matmul(x, w), flops=2 * t * n * k,
                  nbytes=2 * (t * k + k * n + t * n), dtype="bfloat16", tol_kind="gemm")
    del x, w
    dl, emb = randn(chunk, v, scale=1e-3), randn(v, d, scale=0.02)
    bench.run("gemm", "dX logits (2048x122880)·(122880x2304)",
              lambda: brgemm.matmul(dl, emb), lambda: ref.matmul_ref(dl, emb),
              lambda: torch.matmul(dl, emb), flops=2 * chunk * v * d,
              nbytes=2 * (chunk * v + v * d + chunk * d), dtype="bfloat16", tol_kind="gemm")
    del dl, emb
    for label, a, b, out, weight, timed in cases:
        m, k = a.shape
        n = b.shape[1]
        dt = "bfloat16" if a.dtype == torch.bfloat16 else "float32"
        bench.run("gemm_transposed", label,
                  lambda: brgemm.matmul(a, b, out_dtype=out),
                  lambda: ref.matmul_ref(a, b, out_dtype=out),
                  (lambda: torch.matmul(a, b)) if timed else None,
                  flops=2 * m * n * k,
                  nbytes=a.element_size() * (m * k + k * n) + m * n * out.itemsize,
                  dtype=dt, tol_kind="gemm", weight=weight, timed=timed)


def _pairs(torch, sq, skv, causal, window):
    rows = torch.arange(sq)[:, None] + (skv - sq)
    cols = torch.arange(skv)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    return int(mask.sum())


def attention_cases(torch, bench, ref, fa):
    """K2 at the prefill shape (B 4, H 40, S 512, D 128, causal, bf16), GQA,
    windowed, minicpm-2b's training forward (B 4, H 36, S 1024, D 64), and
    small ragged fp32 and bf16 checks."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # label, B, H, Hk, Sq, Skv, D, causal, window, dtype, weight, timed
        ("main B4 H40 S512 D128 causal", 4, 40, 40, 512, 512, 128, True, None, torch.bfloat16, 1, True),
        ("gqa B4 H40 Hk8 S512 D128", 4, 40, 8, 512, 512, 128, True, None, torch.bfloat16, 0, True),
        ("window128 B4 H40 S512 D128", 4, 40, 40, 512, 512, 128, True, 128, torch.bfloat16, 0, True),
        ("minicpm train B4 H36 S1024 D64 causal", 4, 36, 36, 1024, 1024, 64, True, None, torch.bfloat16, 0, True),
        ("check Sq50 Skv77 H4 Hk2 D16 fp32", 2, 4, 2, 50, 77, 16, True, None, torch.float32, 0, False),
        ("check Sq64 H4 Hk2 D16 window24 fp32", 2, 4, 2, 64, 64, 16, True, 24, torch.float32, 0, False),
        ("check Sq40 Skv40 H6 Hk3 D64 noncausal", 1, 6, 3, 40, 40, 64, False, None, torch.bfloat16, 0, False),
        ("check Sq33 H2 D256 causal", 1, 2, 2, 33, 33, 256, True, None, torch.bfloat16, 0, False),
    ]
    for label, b, h, hk, sq, skv, d, causal, window, dt, weight, timed in cases:
        # q, k, v as strided views of (B, S, H, D) projections, as on the path
        q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dt).transpose(1, 2)
        k = torch.randn(b, skv, hk, d, generator=gen, device="cuda").to(dt).transpose(1, 2)
        v = torch.randn(b, skv, hk, d, generator=gen, device="cuda").to(dt).transpose(1, 2)
        pairs = _pairs(torch, sq, skv, causal, window)
        if window is None:
            library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                             enable_gqa=hk != h)
        else:
            keep = torch.ones(sq, skv, dtype=torch.bool, device="cuda").tril().triu(-(window - 1))
            library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep,
                                                             enable_gqa=hk != h)
        name = "bfloat16" if dt == torch.bfloat16 else "float32"
        bench.run("flash_attention", label,
                  lambda: fa.flash_attention(q, k, v, causal=causal, window=window),
                  lambda: ref.attention_ref(q, k, v, causal=causal, window=window),
                  library if timed else None,
                  flops=4 * b * h * d * pairs,
                  nbytes=q.element_size() * (2 * b * h * sq * d + 2 * b * hk * skv * d),
                  dtype=name, tol_kind="attn", weight=weight, timed=timed)


def attention_bwd_cases(torch, bench, ref, fa):
    """K6 against its plain version from the same (o, lse) of K2 (whose o
    and lse are first held against the plain version's): minicpm-2b's training
    shape (B 4, H 36, S 1024, D 64, causal, bf16), llama2-13b's (B 1, H 40,
    S 512, D 128), GQA, window 128, and small fp32 and bf16 checks (ragged,
    Sq < Skv, noncausal, D 256, rows with every key masked)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(10)
    cases = [  # label, B, H, Hk, Sq, Skv, D, causal, window, dtype, weight, timed
        ("minicpm B4 H36 S1024 D64 causal", 4, 36, 36, 1024, 1024, 64, True, None, torch.bfloat16, 1, True),
        ("llama2 B1 H40 S512 D128 causal", 1, 40, 40, 512, 512, 128, True, None, torch.bfloat16, 0, True),
        ("gqa B2 H32 Hk8 S512 D128 causal", 2, 32, 8, 512, 512, 128, True, None, torch.bfloat16, 0, True),
        ("window128 B4 H36 S1024 D64", 4, 36, 36, 1024, 1024, 64, True, 128, torch.bfloat16, 0, True),
        ("check Sq50 Skv77 H4 Hk2 D16 fp32", 2, 4, 2, 50, 77, 16, True, None, torch.float32, 0, False),
        ("check Sq64 H4 Hk2 D16 window24 fp32", 2, 4, 2, 64, 64, 16, True, 24, torch.float32, 0, False),
        ("check Sq40 H6 Hk3 D32 noncausal fp32", 1, 6, 3, 40, 40, 32, False, None, torch.float32, 0, False),
        ("check Sq33 H2 D256 causal", 1, 2, 2, 33, 33, 256, True, None, torch.bfloat16, 0, False),
        ("check Sq70 Skv40 H4 D16 masked rows fp32", 2, 4, 4, 70, 40, 16, True, None, torch.float32, 0, False),
    ]
    for label, b, h, hk, sq, skv, d, causal, window, dt, weight, timed in cases:
        def proj(s, heads, scale=1.0):
            x = torch.randn(b, s, heads, d, generator=gen, device="cuda") * scale
            return x.to(dt).transpose(1, 2)
        q, k, v, do = proj(sq, h), proj(skv, hk), proj(skv, hk), proj(sq, h)
        name = "bfloat16" if dt == torch.bfloat16 else "float32"
        o, lse = fa.flash_attention(q, k, v, causal=causal, window=window, with_lse=True)
        o_ref, lse_ref = ref.attention_fwd_ref(q, k, v, causal=causal, window=window)
        # a row with every key masked: NaN in the plain version, 0 from K2
        o_ref = torch.where(torch.isfinite(lse_ref)[..., None], o_ref.float(), 0.0)
        o_err, o_ok = compare(torch, o, o_ref, *TOL[name]["attn"])
        check(o_ok, f"K2's output disagrees with the plain version's for {label}: {o_err:.3e}")
        both_inf = torch.isinf(lse) & torch.isinf(lse_ref)
        err = float(torch.where(both_inf, 0.0, lse - lse_ref).abs().max())
        rtol, atol = TOL["float32"]["attn"]
        check(err <= atol + rtol * float(lse_ref[~both_inf].abs().max()),
              f"K2's lse disagrees with the plain version's for {label}: {err:.3e}")
        del o_ref
        library = None
        if timed:
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            if window is None:
                out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, enable_gqa=hk != h)
            else:
                keep = torch.ones(sq, skv, dtype=torch.bool, device="cuda").tril().triu(-(window - 1))
                out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep, enable_gqa=hk != h)
            library = lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)
        pairs = _pairs(torch, sq, skv, causal, window)
        bench.run("flash_attention_bwd", f"{label} (K2 o err {o_err:.1e}, lse err {err:.1e})",
                  lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window),
                  lambda: ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window),
                  library,
                  flops=10 * b * h * d * pairs,
                  nbytes=q.element_size() * (4 * b * h * sq * d + 4 * b * hk * skv * d) + 4 * b * h * sq,
                  dtype=name, tol_kind="attn", weight=weight, timed=timed)


def decode_cases(torch, bench, ref, fa):
    """K3 at the decode shape (B 4, H 40, D 128, cache 528, length 520,
    bf16), GQA, windowed, and ragged lengths."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [  # label, B, H, Hk, S, D, lengths, window, dtype, weight, timed
        ("main B4 H40 S528 D128 len520", 4, 40, 40, 528, 128, [520] * 4, None, torch.bfloat16, 1, True),
        ("gqa B4 H40 Hk8 S528 D128 len520", 4, 40, 8, 528, 128, [520] * 4, None, torch.bfloat16, 0, True),
        ("window128 B4 H40 S528 D128 len520", 4, 40, 40, 528, 128, [520] * 4, 128, torch.bfloat16, 0, True),
        ("check ragged lens H40 Hk8 D128", 4, 40, 8, 528, 128, [1, 300, 528, 77], None, torch.bfloat16, 0, False),
        ("check ragged lens H4 Hk2 D16 window16 fp32", 3, 4, 2, 64, 16, [20, 64, 37], 16, torch.float32, 0, False),
        ("check H16 Hk1 D128 fp32", 2, 16, 1, 100, 128, [100, 61], None, torch.float32, 0, False),
    ]
    for label, b, h, hk, s, d, lens, window, dt, weight, timed in cases:
        q = torch.randn(b, 1, h, d, generator=gen, device="cuda").to(dt).transpose(1, 2)[:, :, 0]
        kc = torch.randn(b, hk, s, d, generator=gen, device="cuda").to(dt)
        vc = torch.randn(b, hk, s, d, generator=gen, device="cuda").to(dt)
        length = torch.tensor(lens, dtype=torch.int32, device="cuda")
        valid = sum(min(n, window) if window else n for n in lens)
        library = None
        if timed and window is None:
            n = lens[0]
            library = lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc[:, :, :n], vc[:, :, :n], enable_gqa=hk != h)
        name = "bfloat16" if dt == torch.bfloat16 else "float32"
        bench.run("flash_decode", label,
                  lambda: fa.flash_decode(q, kc, vc, length=length, window=window),
                  lambda: ref.decode_attention_ref(q, kc, vc, length=length, window=window),
                  library,
                  flops=4 * h * d * valid,
                  nbytes=q.element_size() * (2 * b * h * d + 2 * hk * d * valid),
                  dtype=name, tol_kind="attn", weight=weight, timed=timed)


def _page_table(torch, lens, ps, maxp, num_pages, seed):
    """(B, maxp) int32 table over a shuffled pool of ``num_pages`` pages:
    each slot owns ceil(len / ps) of them, the rest of its row is the trash
    page (index ``num_pages``), as the engine's allocator leaves it."""
    perm = torch.randperm(num_pages, generator=torch.Generator().manual_seed(seed))
    table = torch.full((len(lens), maxp), num_pages, dtype=torch.int32)
    used = 0
    for i, n in enumerate(lens):
        k = -(-n // ps)
        table[i, :k] = perm[used:used + k]
        used += k
    return table.cuda()


def paged_decode_cases(torch, bench, ref, fa):
    """K4 at the engine's shape (llama2-13b, B 8, H = Hk = 40, D 128, page
    16, a 513-row pool, lengths 37..1000, bf16), GQA, windowed, and small
    fp32 and bf16 checks."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(4)
    engine_lens = [37, 1000, 513, 260, 777, 129, 400, 64]
    cases = [  # label, B, H, Hk, D, page, max pages, pool pages, lengths, window, dtype, weight, timed
        ("main B8 H40 D128 ps16 len37..1000", 8, 40, 40, 128, 16, 64, 512, engine_lens, None, torch.bfloat16, 1, True),
        ("gqa B8 H32 Hk8 D128 ps16", 8, 32, 8, 128, 16, 64, 512, engine_lens, None, torch.bfloat16, 0, True),
        ("window128 B8 H40 D128 ps16", 8, 40, 40, 128, 16, 64, 512, engine_lens, 128, torch.bfloat16, 0, True),
        ("check H4 Hk2 D16 ps4 window5 fp32", 3, 4, 2, 16, 4, 8, 20, [13, 32, 3], 5, torch.float32, 0, False),
        ("check H16 Hk1 D128 ps16 fp32", 2, 16, 1, 128, 16, 8, 20, [100, 61], None, torch.float32, 0, False),
        ("check H8 Hk2 D64 ps8 len1", 2, 8, 2, 64, 8, 8, 20, [50, 1], None, torch.bfloat16, 0, False),
    ]
    for label, b, h, hk, d, ps, maxp, npages, lens, window, dt, weight, timed in cases:
        q = torch.randn(b, h, d, generator=gen, device="cuda").to(dt)
        kp = torch.randn(npages + 1, ps, hk, d, generator=gen, device="cuda").to(dt)
        vp = torch.randn(npages + 1, ps, hk, d, generator=gen, device="cuda").to(dt)
        table = _page_table(torch, lens, ps, maxp, npages, seed=b + h)
        length = torch.tensor(lens, dtype=torch.int32, device="cuda")
        valid = sum(min(n, window) if window else n for n in lens)
        library = None
        if timed and window is None:
            keep = (torch.arange(maxp * ps, device="cuda")[None, :] < length[:, None])[:, None, None, :]
            flat = table.flatten()

            def library():
                kd = kp.index_select(0, flat).view(b, maxp * ps, hk, d).transpose(1, 2)
                vd = vp.index_select(0, flat).view(b, maxp * ps, hk, d).transpose(1, 2)
                return F.scaled_dot_product_attention(q[:, :, None], kd, vd, attn_mask=keep,
                                                      enable_gqa=hk != h)
        name = "bfloat16" if dt == torch.bfloat16 else "float32"
        pages_read = sum(-(-n // ps) for n in lens)
        bench.run("paged_decode", label,
                  lambda: fa.paged_decode(q, kp, vp, table, page_size=ps, length=length,
                                          window=window),
                  lambda: ref.paged_decode_attention_ref(q, kp, vp, table, page_size=ps,
                                                         length=length, window=window),
                  library,
                  flops=4 * h * d * valid,
                  nbytes=q.element_size() * (2 * b * h * d + 2 * hk * d * valid)
                  + 4 * (pages_read + b),
                  dtype=name, tol_kind="attn", weight=weight, timed=timed)


def _to_cuda(tree):
    """A copy of a parameter tree (dicts and lists of tensors) on the GPU,
    each leaf a leaf that requires a gradient where the original does."""
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cuda(v) for v in tree]
    return tree.detach().cuda().requires_grad_(tree.requires_grad)


def reduced_models(torch):
    """Reduced fp32 configs: CUDA kernels against CPU plain versions."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    from repro_torch.serve.decode import ServeConfig, generate_loop

    rtol, atol = MODEL_TOL
    for arch in ("llama2_13b", "gptj_6b", "minicpm_2b"):
        cfg = get_config(arch).reduced()
        cpu = lm.init_params(cfg, seed=0, device="cpu")
        params = {"cpu": cpu, "cuda": _to_cuda(cpu)}
        gen = torch.Generator().manual_seed(3)
        prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
        caches = {"cpu": lm.init_cache(cfg, 2, 16, device="cpu"),
                  "cuda": lm.init_cache(cfg, 2, 16, device="cuda")}
        logits = {dev: lm.prefill(cfg, params[dev], caches[dev],
                                  {"tokens": prompts.to(dev)})[0].cpu() for dev in params}
        worst = float((logits["cuda"] - logits["cpu"]).abs().max())
        check(torch.allclose(logits["cuda"], logits["cpu"], rtol=rtol, atol=atol),
              f"{arch} reduced prefill: GPU and CPU logits differ by {worst:.3e}")
        for t in range(6):
            toks = torch.randint(0, cfg.vocab_size, (2,), generator=gen)
            logits = {dev: lm.decode_step(cfg, params[dev], caches[dev], toks.to(dev), 8 + t)[0].cpu()
                      for dev in params}
            err = float((logits["cuda"] - logits["cpu"]).abs().max())
            worst = max(worst, err)
            check(torch.allclose(logits["cuda"], logits["cpu"], rtol=rtol, atol=atol),
                  f"{arch} reduced decode step {t}: GPU and CPU logits differ by {err:.3e}")
        scfg = ServeConfig(max_seq=64)
        toks = {dev: generate_loop(cfg, params[dev], prompts, 8, scfg=scfg).cpu() for dev in params}
        same = torch.equal(toks["cuda"], toks["cpu"])
        served = {dev: reduced_engine(cfg, params[dev]) for dev in params}
        engine_same = served["cuda"] == served["cpu"]
        print(f"  {arch}-reduced fp32: max logit diff {worst:.3e} (rtol {rtol}, atol {atol}),"
              f" greedy tokens equal: {same}, engine tokens and statuses equal: {engine_same}"
              f" ({len(served['cuda'][0])} requests)", flush=True)
        check(same, f"{arch} reduced: greedy tokens differ between GPU and CPU")
        check(engine_same, f"{arch} reduced: engine tokens or statuses differ between GPU and CPU")


def reduced_engine(cfg, params):
    """8 ragged requests, greedy and sampled, through a 3-slot engine with
    4-token pages and optimistic admission on a pool small enough to
    preempt; ``validate()`` after every step; → (tokens, statuses, stats)."""
    import numpy as np
    from repro_torch.serve import Engine, EngineConfig

    eng = Engine(cfg, params, EngineConfig(num_slots=3, page_size=4, max_seq=64, segment_len=4,
                                           seed=7, admission="optimistic", num_pages=6,
                                           thrash_preemptions=50))
    rng = np.random.default_rng(5)    # a draw whose drain preempts once
    for i in range(8):
        prompt = rng.integers(1, cfg.vocab_size, int(rng.integers(3, 12)))
        eng.submit(prompt, int(rng.integers(4, 10)), temperature=0.8 if i % 2 else 0.0,
                   top_k=5 if i % 4 == 1 else 0, top_p=0.9 if i % 4 == 3 else 1.0)
    while not eng.idle:
        eng.step()
        eng.validate()
    check(eng.stats["preemptions"] > 0, "the reduced engine run did not preempt")
    tokens = {uid: eng.collect(uid) for uid in sorted(eng.metrics)}
    return tokens, {uid: eng.status(uid).value for uid in tokens}, eng.stats


def serving_bounds(cfg, params, batch, prompt_len, new, peaks):
    """Least card time for the main path's prefill and for one decode step,
    each the larger of its bytes over the HBM rate and its operations over
    the bf16 peak.  Bytes: every weight the step reads once (the embedding
    only in the rows it gathers) and the K/V cache written or read once.
    Operations: the projections, the causal attention and the last
    token's logits."""
    layer_w = [t for layer in params["layers"] for sub in layer.values() for t in sub.values()]
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    w_bytes = sum(t.numel() * t.element_size() for t in layer_w + [head]) \
        + sum(t.numel() * t.element_size() for t in params["final_norm"].values())
    proj = sum(t.numel() for t in layer_w if t.dim() == 2)
    L, h, hk, d = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kv_token = 2 * L * batch * hk * d * params["embed"].element_size()
    logits = 2 * batch * cfg.d_model * cfg.padded_vocab

    def bound(flops, nbytes):
        return max(flops / peaks["bf16"], nbytes / peaks["hbm"]) * 1e3

    pairs = prompt_len * (prompt_len + 1) // 2
    prefill = bound(2 * batch * prompt_len * proj + 4 * L * batch * h * d * pairs + logits,
                    w_bytes + kv_token * prompt_len)
    length = prompt_len + new / 2            # the mean cache length over the decode steps
    decode = bound(2 * batch * proj + 4 * L * batch * h * d * length + logits,
                   w_bytes + kv_token * length)
    return {"prefill_bound_ms": prefill, "decode_bound_ms_per_token": decode}


def init_model(torch):
    """Full-width, full-depth llama2-13b with random weights from a seed."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm

    cfg = get_config("llama2_13b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  init {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.dtype},"
          f" {torch.cuda.memory_allocated() / 2**30:.2f} GiB of weights in"
          f" {time.perf_counter() - t0:.2f} s", flush=True)
    return cfg, params


def full_width(torch, counters, peaks, cfg, params):
    """llama2-13b at full width and depth through generate_loop."""
    from repro_torch.models import lm
    from repro_torch.serve.decode import ServeConfig, generate_loop

    batch, prompt_len, new = 4, 512, 16
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device="cuda")

    # Output check through the step entry points: finite logits of the right shape.
    caches = lm.init_cache(cfg, batch, prompt_len + 1, device="cuda")
    logits, caches = lm.prefill(cfg, params, caches, {"tokens": prompts})
    check(logits.shape == (batch, cfg.padded_vocab), f"prefill logits {tuple(logits.shape)}")
    check(bool(lm.finite_logits(logits).all()), "prefill logits are not finite")
    logits, _ = lm.decode_step(cfg, params, caches, logits.argmax(-1), prompt_len)
    check(bool(lm.finite_logits(logits).all()), "decode logits are not finite")
    del caches, logits

    scfg = ServeConfig(max_seq=prompt_len + new)

    def serve(n):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = generate_loop(cfg, params, prompts, n, scfg=scfg)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - start) * 1e3

    _, prefill_ms = serve(1)          # prefill and the first token
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    out, total_ms = serve(new)        # the main path
    launches = counters.read()
    peak = torch.cuda.max_memory_allocated()
    check(out.shape == (batch, prompt_len + new), f"generate_loop output {tuple(out.shape)}")
    check(torch.equal(out[:, :prompt_len], prompts), "generate_loop changed the prompt")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "token outside the vocabulary")
    decode_ms = (total_ms - prefill_ms) / (new - 1)
    result = {"prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
              "total_ms": total_ms, "tokens_per_s": batch * new / (total_ms / 1e3),
              "decode_tokens_per_s": batch / (decode_ms / 1e3),
              "max_memory_allocated_gib": peak / 2**30, "launches": launches}
    result.update(serving_bounds(cfg, params, batch, prompt_len, new, peaks))
    print(f"  generate_loop B{batch} P{prompt_len} +{new}: prefill {prefill_ms:.1f} ms"
          f" (bound {result['prefill_bound_ms']:.2f}), decode {decode_ms:.2f} ms/token"
          f" (bound {result['decode_bound_ms_per_token']:.2f}),"
          f" {result['tokens_per_s']:.1f} tokens/s overall,"
          f" peak {peak / 2**30:.2f} GiB, launches {launches}", flush=True)
    for name in ("gemm", "flash_attention", "flash_decode"):
        check(launches[name] > 0, f"kernel {name} was not launched by generate_loop")
    result["profile"] = device_breakdown(
        torch, lambda: generate_loop(cfg, params, prompts, new, scfg=scfg), total_ms)
    return result


ENGINE = dict(num_slots=8, page_size=16, max_seq=1024, segment_len=8, admission="reserve", seed=0)
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95)
BF16_LOGITS = (2e-2, 2e-1)   # the bf16 tolerance of the repo's tests


def engine_requests(cfg, n=16):
    """Ragged requests from a numpy seed: prompts of 32..480 tokens, 8..40
    new tokens; even uids greedy, odd ones sampled."""
    import numpy as np
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(32, 481))
        reqs.append(dict(prompt=rng.integers(0, cfg.vocab_size, plen).tolist(),
                         max_new=int(rng.integers(8, 41)), **(SAMPLED if i % 2 else {})))
    return reqs


def drain(torch, cfg, params, reqs, *, num_slots, validate=True, tracer=None, logits=None):
    """Submit ``reqs`` to a fresh engine and run it dry; → (engine, wall ms
    of the drain).  Builds the pools before the clock starts.  A list
    passed as ``logits`` receives a device copy of every (uids, positions,
    logits) the engine samples from."""
    from repro_torch.serve import Engine, EngineConfig
    from repro_torch.serve import engine as engine_mod

    eng = Engine(cfg, params, EngineConfig(**dict(ENGINE, num_slots=num_slots)), tracer=tracer)
    for r in reqs:
        eng.submit(r["prompt"], r["max_new"], temperature=r.get("temperature", 0.0),
                   top_k=r.get("top_k", 0), top_p=r.get("top_p", 1.0))
    sample = engine_mod.sample_tokens
    if logits is not None:
        def recording(lg, *, uids, positions, **knobs):
            logits.append((uids.clone(), positions.clone(), lg.clone()))
            return sample(lg, uids=uids, positions=positions, **knobs)
        engine_mod.sample_tokens = recording
    try:
        torch.cuda.synchronize()
        start = time.perf_counter()
        while not eng.idle:
            eng.step()
            if validate:
                eng.validate()
        torch.cuda.synchronize()
    finally:
        engine_mod.sample_tokens = sample
    return eng, (time.perf_counter() - start) * 1e3


def logits_divergence(torch, rec_a, rec_b, uid):
    """The first position at which two drains sampled ``uid`` from logits
    that are not bitwise equal, with the largest difference and each
    drain's top-2 gap there."""
    def rows(rec):
        out = {}
        for uids, positions, lg in rec:
            for i in (uids == uid).nonzero().flatten().tolist():
                out[int(positions[i])] = lg[i].float().cpu()
        return out
    a, b = rows(rec_a), rows(rec_b)
    for p in sorted(set(a) & set(b)):
        if not torch.equal(a[p], b[p]):
            ta, tb = a[p].topk(2).values, b[p].topk(2).values
            return {"uid": uid, "position": p, "max_abs_diff": float((a[p] - b[p]).abs().max()),
                    "top2_gap": (float(ta[0] - ta[1]), float(tb[0] - tb[1])),
                    "argmax": (int(a[p].argmax()), int(b[p].argmax()))}
    return None


def paged_matches_dense(torch, cfg, params):
    """One bucket-padded paged prefill and one paged decode step against the
    dense path, two prompts of 100 tokens, a shuffled table; → max abs
    logit difference."""
    from repro_torch.models import lm
    b, plen, bucket, ps, maxp, num_pages = 2, 100, 128, 16, 8, 32
    gen = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (b, bucket), generator=gen, device="cuda")
    dense = lm.init_cache(cfg, b, plen + 1, device="cuda")
    want, dense = lm.prefill(cfg, params, dense, {"tokens": tokens[:, :plen]})
    pools = lm.init_paged_cache(cfg, num_pages, ps, device="cuda")
    table = _page_table(torch, [bucket] * b, ps, maxp, num_pages, seed=7)
    got, pools = lm.prefill(cfg, params, pools, {"tokens": tokens}, page_table=table,
                            page_size=ps, logit_index=torch.full((b,), plen - 1, device="cuda"))
    errs = [float((got - want).abs().max())]
    ok = torch.allclose(got, want, rtol=BF16_LOGITS[0], atol=BF16_LOGITS[1])
    tok = want.argmax(-1)
    want, _ = lm.decode_step(cfg, params, dense, tok, plen)
    got, _ = lm.decode_step(cfg, params, pools, tok, torch.full((b,), plen, device="cuda"),
                            page_table=table, page_size=ps)
    errs.append(float((got - want).abs().max()))
    ok = ok and torch.allclose(got, want, rtol=BF16_LOGITS[0], atol=BF16_LOGITS[1])
    print(f"  paged vs dense logits, prefill and one decode step: max abs diff"
          f" {errs[0]:.3e}, {errs[1]:.3e} (rtol {BF16_LOGITS[0]}, atol {BF16_LOGITS[1]})",
          flush=True)
    check(ok and all(math.isfinite(e) for e in errs), "paged logits differ from dense logits")
    del pools, dense
    return max(errs)


def first_difference(torch, cfg, params, a, b):
    """The first (uid, position) where two drains' tokens differ, with the
    top-2 gap of the dense path's logits there."""
    from repro_torch.models import lm
    for uid in sorted(a):
        if a[uid] != b[uid]:
            i = next(j for j, (x, y) in enumerate(zip(a[uid], b[uid])) if x != y)
            prefix = torch.tensor([a[uid][:i]], device="cuda")
            caches = lm.init_cache(cfg, 1, i, device="cuda")
            logits, _ = lm.prefill(cfg, params, caches, {"tokens": prefix})
            top = logits[0].topk(2).values
            return {"uid": uid, "position": i, "tokens": (a[uid][i], b[uid][i]),
                    "top2_gap": float(top[0] - top[1])}
    return None


def batch_invariance_probe(torch, cfg, params):
    """Whether one paged decode step gives a row the same bits in a batch of
    8 as in a batch of 3 (the engine's two drains): every call of the
    step's kernels, norms and RoPE is recorded at both batch sizes, and the
    first one whose first three rows differ is reported with whether its
    input rows were equal (if so, that op depends on the batch)."""
    from repro_torch.kernels import ops
    from repro_torch.models import blocks, lm
    ps, per_slot, b = 16, 24, 8
    gen = torch.Generator(device="cuda").manual_seed(8)
    pools = lm.init_paged_cache(cfg, b * per_slot, ps, device="cuda")
    for pool in pools:
        for t in pool.values():
            t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    table = torch.full((b, ENGINE["max_seq"] // ps), b * per_slot, dtype=torch.int32)
    table[:, :per_slot] = torch.arange(b * per_slot, dtype=torch.int32).view(b, per_slot)
    table = table.cuda()
    pos = torch.tensor([300, 250, 350, 236, 284, 216, 244, 106], device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device="cuda")
    hooked = [(ops, "matmul"), (ops, "paged_decode_attention"), (blocks, "_norm"),
              (blocks, "apply_rope"), (lm, "_logits")]
    saved = {(m, n): getattr(m, n) for m, n in hooked}

    def run(n):
        calls = []
        for (m, name), fn in saved.items():
            def rec(*a, _fn=fn, _name=name, **k):
                out = _fn(*a, **k)
                x = next(t for t in a if isinstance(t, torch.Tensor))
                calls.append((_name, x.detach().clone(), out.detach().clone()))
                return out
            setattr(m, name, rec)
        try:
            logits, _ = lm.decode_step(cfg, params, pools, toks[:n], pos[:n],
                                       page_table=table[:n], page_size=ps)
        finally:
            for (m, name), fn in saved.items():
                setattr(m, name, fn)
        return logits, calls

    logits8, calls8 = run(b)
    logits3, calls3 = run(3)
    first = None
    for i, ((name, x8, y8), (_, x3, y3)) in enumerate(zip(calls8, calls3)):
        if not torch.equal(y8[:3], y3):
            first = {"call": i, "of": len(calls8), "op": name,
                     "input_rows_equal": torch.equal(x8[:3], x3),
                     "max_abs_diff": float((y8[:3].float() - y3.float()).abs().max())}
            break
    out = {"logits_equal": torch.equal(logits8[:3], logits3), "first_differing_call": first}
    print(f"  one paged decode step at batch 8 and batch 3: {out}", flush=True)
    del pools
    return out


def engine_full_width(torch, counters, peaks, cfg, params):
    """llama2-13b at full width and depth through the serving engine."""
    from repro_torch.obs.trace import Tracer

    paged_err = paged_matches_dense(torch, cfg, params)
    probe = batch_invariance_probe(torch, cfg, params)
    reqs = engine_requests(cfg)
    tracer = Tracer()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    rec8, rec3 = [], []
    eng, wall_ms = drain(torch, cfg, params, reqs, num_slots=ENGINE["num_slots"], tracer=tracer,
                         logits=rec8)
    launches = counters.read()                  # the main path's run
    peak = torch.cuda.max_memory_allocated()
    tokens = {uid: eng.collect(uid) for uid in range(len(reqs))}
    for uid, r in enumerate(reqs):
        check(eng.status(uid).value == "finished", f"request {uid} ended {eng.status(uid).value}")
        check(len(tokens[uid]) == len(r["prompt"]) + r["max_new"],
              f"request {uid}: {len(tokens[uid])} tokens, want {len(r['prompt']) + r['max_new']}")
        check(tokens[uid][:len(r["prompt"])] == r["prompt"], f"request {uid}: prompt changed")
        check(all(0 <= t < cfg.vocab_size for t in tokens[uid]), f"request {uid}: token outside the vocabulary")
    steps = eng.decode_steps
    check(launches["paged_decode"] == cfg.num_layers * steps,
          f"K4 launched {launches['paged_decode']} times in {steps} decode steps of {cfg.num_layers} layers")
    for name in ("gemm", "flash_attention"):
        check(launches[name] > 0, f"kernel {name} was not launched by the engine")
    spans = tracer.spans()
    decode_ms = sum(sp.duration for sp in spans if sp.name == "engine.decode_segment") * 1e3
    prefill_ms = [sp.duration * 1e3 for sp in spans if sp.name == "engine.prefill"]
    ttft = sorted((m["first_token"] - m["submitted"]) * 1e3 for m in eng.metrics.values())
    generated = eng.tokens_generated
    mean_ctx = statistics.mean(len(r["prompt"]) + r["max_new"] / 2 for r in reqs)
    bound = serving_bounds(cfg, params, ENGINE["num_slots"], int(mean_ctx), 0, peaks)
    result = {"requests": len(reqs), "slots": ENGINE["num_slots"], "generated_tokens": generated,
              "drain_ms": wall_ms, "tokens_per_s": generated / (wall_ms / 1e3),
              "ttft_ms_median": statistics.median(ttft),
              "ttft_ms_p90": statistics.quantiles(ttft, n=10)[8],
              "prefill_ms_median": statistics.median(prefill_ms), "prefills": len(prefill_ms),
              "decode_steps": steps, "decode_ms_per_step": decode_ms / steps,
              "decode_step_bound_ms": bound["decode_bound_ms_per_token"],
              "engine_steps": eng._step_idx, "max_memory_allocated_gib": peak / 2**30,
              "launches": launches, "paged_vs_dense_max_abs": paged_err,
              "batch_invariance_probe": probe, "stats": eng.stats}
    print(f"  drain of {len(reqs)} requests on {ENGINE['num_slots']} slots: {wall_ms:.1f} ms,"
          f" {generated} tokens, {result['tokens_per_s']:.1f} tokens/s; TTFT median"
          f" {result['ttft_ms_median']:.1f} ms, p90 {result['ttft_ms_p90']:.1f} ms; prefill median"
          f" {result['prefill_ms_median']:.1f} ms; {steps} decode steps at"
          f" {result['decode_ms_per_step']:.2f} ms (bound {result['decode_step_bound_ms']:.2f} ms at"
          f" mean context {mean_ctx:.0f}); peak {peak / 2**30:.2f} GiB; launches {launches}",
          flush=True)
    del eng
    torch.cuda.empty_cache()

    eng3, wall3_ms = drain(torch, cfg, params, reqs, num_slots=3, logits=rec3)
    tokens3 = {uid: eng3.collect(uid) for uid in range(len(reqs))}
    del eng3
    torch.cuda.empty_cache()
    diff = first_difference(torch, cfg, params, tokens, tokens3)
    result["slots3_drain_ms"] = wall3_ms
    result["schedule_invariant"] = diff is None
    print(f"  drain on 3 slots: {wall3_ms:.1f} ms; tokens equal to the 8-slot drain: {diff is None}"
          + (f"; first difference {diff}" if diff else ""), flush=True)
    if diff:
        print(f"  first logits of uid {diff['uid']} that differ between the drains:"
              f" {logits_divergence(torch, rec8, rec3, diff['uid'])}", flush=True)
    del rec8, rec3
    check(diff is None, f"tokens depend on the number of slots: {diff}")

    wave = reqs[:ENGINE["num_slots"]]
    _, wave_ms = drain(torch, cfg, params, wave, num_slots=ENGINE["num_slots"], validate=False)
    result["profile"] = device_breakdown(
        torch, lambda: drain(torch, cfg, params, wave, num_slots=ENGINE["num_slots"],
                             validate=False), wave_ms)
    result["profile"]["requests"] = len(wave)
    return result


# Kernel names as the profiler reports them → the port's kernel.  K1's
# launches that read a transposed operand are kernels of their own names.
KERNEL_OF = {"gemm_bf16_wmma": "gemm", "gemm_f32_simt": "gemm",
             "gemm_transposed_bf16_wmma": "gemm_transposed",
             "gemm_transposed_f32_simt": "gemm_transposed",
             "flash_attention_kernel": "flash_attention", "flash_decode_kernel": "flash_decode",
             "paged_decode_kernel": "paged_decode", "dkdv_kernel": "flash_attention_bwd",
             "dq_kernel": "flash_attention_bwd", "delta_kernel": "flash_attention_bwd"}


def kernel_of(name):
    """The port's kernel that a profiled device kernel belongs to: the
    first word of its demangled name that is one of the port's kernel
    names."""
    return next((KERNEL_OF[w] for w in re.findall(r"\w+", name) if w in KERNEL_OF), "other")


# Named ranges of the port (torch.profiler.record_function) whose device
# spans a profile reports beside the kernels.
RANGES = ("adamw",)


def device_breakdown(torch, run, wall_ms):
    """Device time by kernel over one more ``run()`` under torch.profiler;
    the busy share divides the summed device time by ``wall_ms``, the same
    run's time without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_kernel, ranges = {}, {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0:
            continue
        if ev.key in RANGES:     # a named range's device span, not a kernel
            ranges[ev.key] = ev.self_device_time_total / 1e3
            continue
        name = kernel_of(ev.key)
        ms, count = by_kernel.get(name, (0.0, 0))
        by_kernel[name] = (ms + ev.self_device_time_total / 1e3, count + ev.count)
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms if busy_ms else None,
           "by_kernel": {k: {"ms": ms, "launches": n} for k, (ms, n) in
                         sorted(by_kernel.items(), key=lambda kv: -kv[1][0])},
           "ranges_ms": ranges}
    print(f"  profile: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms"
          + "".join(f"; {k} {v['ms']:.1f} ms / {v['launches']}" for k, v in out["by_kernel"].items())
          + "".join(f"; range {k} spans {v:.1f} ms on the device" for k, v in ranges.items()),
          flush=True)
    return out


class Counters:
    """Reads and resets the kernel wrappers' launch counters."""

    def __init__(self, brgemm, fa):
        self.brgemm, self.fa = brgemm, fa

    def reset(self):
        self.brgemm.LAUNCHES = 0
        self.brgemm.TRANSPOSED_LAUNCHES = 0
        self.fa.ATTENTION_LAUNCHES = 0
        self.fa.BACKWARD_LAUNCHES = 0
        self.fa.DECODE_LAUNCHES = 0
        self.fa.PAGED_DECODE_LAUNCHES = 0

    def read(self):
        return {"gemm": self.brgemm.LAUNCHES - self.brgemm.TRANSPOSED_LAUNCHES,
                "gemm_transposed": self.brgemm.TRANSPOSED_LAUNCHES,
                "flash_attention": self.fa.ATTENTION_LAUNCHES,
                "flash_attention_bwd": self.fa.BACKWARD_LAUNCHES,
                "flash_decode": self.fa.DECODE_LAUNCHES,
                "paged_decode": self.fa.PAGED_DECODE_LAUNCHES}


TRAIN_TOL = 1e-4     # loss and grad norm per step, reduced fp32 configs: CUDA vs CPU


def reduced_training(torch):
    """Reduced fp32 minicpm-2b and gpt-j-6b: three ``make_train_step``
    steps on CUDA and on the CPU from the same initial state and batches
    (loss and grad norm within TRAIN_TOL), then 4 trainer steps straight
    against 2 steps, a checkpoint, a restore and 2 more on the card
    (parameters bitwise equal)."""
    import tempfile
    from repro_torch.configs.base import get_config
    from repro_torch.data import DataConfig, SyntheticCorpus, to_device
    from repro_torch.optim.adamw import init_state, tree_leaves
    from repro_torch.train import (SimulatedPreemption, TrainConfig, TrainerConfig,
                                   init_train_state, make_train_step, train)

    for arch in ("minicpm_2b", "gptj_6b"):
        cfg = get_config(arch).reduced()
        tcfg = TrainConfig(peak_lr=3e-3, warmup_steps=2, total_steps=40, loss_chunk=16)
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, seed=1)
        cpu_params, cpu_opt = init_train_state(cfg, tcfg, 0, device="cpu")
        state = {"cpu": (cpu_params, cpu_opt)}
        gpu_params = _to_cuda(cpu_params)
        state["cuda"] = (gpu_params, init_state(gpu_params, tcfg.adamw))
        step_fn = make_train_step(cfg, tcfg)
        corpus = SyntheticCorpus(dcfg)
        worst = 0.0
        for step in range(3):
            batch = corpus.batch_at(step)
            m = {}
            for dev in ("cpu", "cuda"):
                params, opt, metrics = step_fn(*state[dev], to_device(batch, dev), step)
                state[dev] = (params, opt)
                m[dev] = (float(metrics["loss"]), float(metrics["grad_norm"]))
            for (a, b), what in zip(zip(m["cuda"], m["cpu"]), ("loss", "grad norm")):
                rel = abs(a - b) / abs(b)
                worst = max(worst, rel)
                check(math.isfinite(a) and rel <= TRAIN_TOL,
                      f"{arch} reduced step {step}: CUDA {what} {a} against CPU {b}")
        with tempfile.TemporaryDirectory() as d:
            rcfg = dict(ckpt_every=2, log_every=0)
            straight, _, _ = train(cfg, tcfg, dcfg, TrainerConfig(num_steps=4, **rcfg), device="cuda")
            try:
                train(cfg, tcfg, dcfg, TrainerConfig(num_steps=4, ckpt_dir=d, preempt_after=2, **rcfg),
                      device="cuda")
                check(False, f"{arch}: the preemption did not happen")
            except SimulatedPreemption:
                pass
            resumed, _, _ = train(cfg, tcfg, dcfg, TrainerConfig(num_steps=4, ckpt_dir=d, **rcfg),
                                  device="cuda")
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(straight), tree_leaves(resumed)))
        print(f"  {arch}-reduced fp32: 3 steps, CUDA vs CPU loss and grad norm within"
              f" {worst:.2e} relative (tol {TRAIN_TOL}); 4 steps straight vs 2 + checkpoint +"
              f" restore + 2 bitwise equal: {same}", flush=True)
        check(same, f"{arch}: resumed training differs from the straight run")


def training_model_flops(cfg, batch, seq):
    """(model FLOPs of one step: 6 N tokens plus causal attention forward and
    backward, remat excluded; FLOPs the step does with remat: one more
    forward of every layer and one more of the loss chunks' logits)."""
    L, d, ff, h, hd = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.head_dim
    per_layer = d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd + h * hd * d \
        + (3 if cfg.gated_mlp else 2) * d * ff
    tokens = batch * seq
    pairs = seq * (seq + 1) // 2
    attn_fwd = 4 * batch * h * hd * pairs * L
    logits_fwd = 2 * tokens * d * cfg.padded_vocab
    model = 6 * (L * per_layer + d * cfg.padded_vocab) * tokens + 3 * attn_fwd
    remat = model + 2 * L * per_layer * tokens + attn_fwd + logits_fwd
    return model, remat


def train_full_width(torch, counters, peaks):
    """minicpm-2b at full width and depth: 6 trainer steps (fp32 masters,
    bf16 compute, B 4 x S 1024, loss_chunk 512, remat, AdamW defaults, WSD),
    then 3 steps at a small constant learning rate on one repeated batch,
    whose loss must fall at each step, and one profiled step."""
    from repro_torch.configs.base import get_config
    from repro_torch.data import DataConfig, SyntheticCorpus, to_device
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import TrainConfig, TrainerConfig, make_train_step, train

    cfg = get_config("minicpm_2b")
    batch, seq, steps = 4, 1024, 6
    tcfg = TrainConfig(schedule="wsd", peak_lr=3e-4, warmup_steps=2, total_steps=100,
                       loss_chunk=512, remat=True)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    params, opt, hist = train(cfg, tcfg, dcfg, TrainerConfig(num_steps=steps, log_every=1),
                              seed=0, device="cuda")
    launches = counters.read()                    # the main path's run
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in tree_leaves(params))
    check(all(math.isfinite(x) for x in hist["loss"] + hist["grad_norm"]),
          f"non-finite loss or grad norm: {hist['loss']}, {hist['grad_norm']}")
    check(launches["flash_attention_bwd"] == cfg.num_layers * steps,
          f"K6 launched {launches['flash_attention_bwd']} times in {steps} steps of"
          f" {cfg.num_layers} layers")
    check(launches["gemm_transposed"] > 0, "K1 never read a transposed operand")
    for name in ("gemm", "flash_attention"):
        check(launches[name] > 0, f"kernel {name} was not launched by training")
    step_ms = statistics.median(hist["step_time"][1:]) * 1e3
    tokens = batch * seq
    model_flops, remat_flops = training_model_flops(cfg, batch, seq)
    state_bytes = 7 * 4 * n_params               # AdamW reads p, g, mu, nu; writes p, mu, nu
    # the model's work (remat, a choice that trades FLOPs for memory, beside it)
    bound_ms = max(model_flops / peaks["bf16"], state_bytes / peaks["hbm"]) * 1e3
    remat_bound_ms = max(remat_flops / peaks["bf16"], state_bytes / peaks["hbm"]) * 1e3
    result = {"steps": steps, "step_ms_median_2_6": step_ms, "step_times_ms":
              [t * 1e3 for t in hist["step_time"]], "tokens_per_s": tokens / (step_ms / 1e3),
              "model_flops_per_step": model_flops, "flops_per_step_with_remat": remat_flops,
              "mfu_bf16_peak": model_flops / (step_ms / 1e3) / peaks["bf16"],
              "step_bound_ms": bound_ms, "step_bound_with_remat_ms": remat_bound_ms,
              "parameters": n_params, "max_memory_allocated_gib": peak / 2**30,
              "launches": launches, "loss": hist["loss"], "grad_norm": hist["grad_norm"]}
    print(f"  trainer, {steps} steps of B{batch} x S{seq}: losses {[round(x, 4) for x in hist['loss']]},"
          f" grad norms {[round(x, 3) for x in hist['grad_norm']]}; step {step_ms:.1f} ms"
          f" (median of steps 2-{steps}), {result['tokens_per_s']:.1f} tokens/s,"
          f" model FLOPs {model_flops / 1e12:.2f} T/step ({remat_flops / 1e12:.2f} T with remat),"
          f" {100 * result['mfu_bf16_peak']:.2f} % of the {peaks['bf16'] / 1e12:g} TFLOP/s bf16 peak;"
          f" bound {bound_ms:.1f} ms ({remat_bound_ms:.1f} ms with remat); {n_params} parameters; peak {peak / 2**30:.2f} GiB;"
          f" launches {launches}", flush=True)

    # Downhill: a fresh AdamW state, one repeated batch, a small constant lr.
    del opt
    torch.cuda.empty_cache()
    fixed = TrainConfig(schedule="wsd", peak_lr=1e-5, warmup_steps=0, total_steps=10**6,
                        loss_chunk=512, remat=True)
    opt = init_state(params, AdamWConfig())
    step_fn = make_train_step(cfg, fixed)
    one = to_device(SyntheticCorpus(dcfg).batch_at(1000), "cuda")
    losses = []
    for i in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, one, i)
        losses.append(float(metrics["loss"]))
        last_ms = (time.perf_counter() - start) * 1e3
    with torch.no_grad():
        losses.append(float(lm.lm_loss(cfg, params, one, loss_chunk=512)[0]))
    falls = all(b < a for a, b in zip(losses, losses[1:]))
    result["repeated_batch_losses"] = losses
    print(f"  3 steps at lr 1e-5 on one batch: losses {losses} (falling: {falls})", flush=True)
    check(falls, f"the loss did not fall at each step on a repeated batch: {losses}")
    result["profile"] = device_breakdown(torch, lambda: step_fn(params, opt, one, 3), last_ms)
    del params, opt
    torch.cuda.empty_cache()
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, brgemm, ref
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1. card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card_line = smi.stdout.strip().splitlines()[0]
    print(card_line)
    kind = torch.cuda.get_device_name(0)
    peak_name = "H100 PCIe" if "PCIe" in kind else "H100 SXM"
    peaks = PEAKS[peak_name]
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {kind};"
          f" bounds use {peak_name} peaks: {peaks['bf16'] / 1e12:g} TFLOP/s bf16,"
          f" {peaks['fp32'] / 1e12:g} TFLOP/s fp32, {peaks['hbm'] / 1e12:g} TB/s", flush=True)

    phase("2. build")
    start = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - start
    print(f"  built {', '.join(logs)} in {build_s:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "spill" in line and " 0 bytes spill stores" not in line:
                print(f"  {name}: {line.strip()}")

    phase("3. kernels against their plain versions")
    bench = Bench(torch, peaks)
    gemm_cases(torch, bench, ref, brgemm)
    gemm_training_cases(torch, bench, ref, brgemm)
    attention_cases(torch, bench, ref, fa)
    attention_bwd_cases(torch, bench, ref, fa)
    decode_cases(torch, bench, ref, fa)
    paged_decode_cases(torch, bench, ref, fa)

    phase("4. reduced configs: CUDA kernels against CPU plain versions")
    reduced_models(torch)

    phase("5. llama2-13b, full width, through generate_loop")
    counters = Counters(brgemm, fa)
    cfg, params = init_model(torch)
    result = full_width(torch, counters, peaks, cfg, params)

    phase("6. llama2-13b, full width, through the serving engine")
    engine = engine_full_width(torch, counters, peaks, cfg, params)
    del params
    torch.cuda.empty_cache()

    phase("7. reduced configs: training on CUDA against the CPU")
    reduced_training(torch)

    phase("8. minicpm-2b, full width and depth, training")
    training = train_full_width(torch, counters, peaks)

    phase("9. kernels")
    kernels = []
    for name in KERNELS:
        s = bench.summary(name)
        tol = TOL["bfloat16"]["gemm" if name.startswith("gemm") else "attn"]
        by_path = {"generate_loop": result["launches"][name], "engine": engine["launches"][name],
                   "training": training["launches"][name]}
        kernels.append({
            "name": name, "row": ROW[name], "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": s["max_abs_err"],
            "max_err": s["max_abs_err"], "tol": {"rtol": tol[0], "atol": tol[1]},
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "cases": bench.cases[name]})
    print(json.dumps({"build_s": build_s, "full_width": result, "engine": engine,
                      "training": training}))
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
