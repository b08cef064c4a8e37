#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --gemm-tiles   # only: K1's wgmma tile choices, timed

Phases, each of which must pass:
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` and the
     K5 sources generated from ``csrc/fused_gemm.cuh`` and
     ``csrc/fused_chain.cuh`` for every fused graph phases 3, 4, 7, 8, 10
     and 10b launch, forward and derived backward (one nvcc per source, all at
     once, with the chained backward sources of ``csrc/attention_bwd.cuh``
     per chained graph and head dim) and print the build time, and each K2,
     K6, chained-forward (minicpm-2b's, bert-large's and gpt-j-6b's
     attention graphs, ``csrc/attention_fwd.cuh`` on the generated epilogue)
     and chained-backward instantiation's ``-Xptxas -v`` figures, shared
     memory and (with ``cuobjdump``) HGMMA instructions, and the same for
     each instantiation of the GEMM mainloop (``csrc/gemm_mainloop.cuh``:
     K1's wgmma and wgmma_decode kernels, K11's wgmma kernel; K5's wgmma,
     wgmma_split, wgmma_decode and row-panel kernels grouped by tile over
     every generated source; K10's and K9's wgmma kernels), K3's split
     kernel by dtype and head dim, and any C7518 warning;
  3. hold each kernel (K1 GEMM on its wgmma variants, the WMMA variant
     it replaced timed beside it at the prefill and decode rows, device
     times without the host's launch cost, all four transpositions, ragged
     TMA-aligned shapes, bias with each activation, fp32 out, rows of M 3 =
     M 8 = M 16 bitwise, two calls bitwise, the host's microseconds a
     decode call; K1 on transposed operands, K2 flash
     attention, K6 its backward at D 16 to 256, GQA, windows, Sq < Skv,
     ragged, bidirectional and fully masked rows, two calls bitwise equal;
     K3 flash decode split over fixed key chunks (its device time, and the
     replaced kernel's recorded time printed beside; rows at B 1 bitwise equal to B 4, S not
     a multiple of the chunk, window edges inside a chunk, a slot of length
     0, a misaligned cache refused) and K4 paged decode, also at gpt-j-6b's
     D 256; K5 fused
     TppGraphs (each GEMM-rooted row beside the WMMA or SIMT variant it
     replaced on the same inputs; decoded rows bitwise equal at M 1, 3, 8
     and 16; the fp32-operand backward graphs on wgmma_split at the fp32
     tolerance; ragged, transposed, narrow and batched operands on the
     wgmma variants): serving's graphs, and the fused training path's chained
     attention (on K2's mainloop; beside K2 at minicpm-2b's, bert-large's
     and gpt-j-6b's D 256 rows, each timed alone and 20 calls back to back;
     checks at D 16 to 256, Sq < Skv, a row with no key, operands every
     problem shares, fp32 on the SIMT variant, a misaligned bf16 operand
     refused, two calls bitwise equal), its chained backward kernel (against its plain version and
     against the six derived graphs, at minicpm-2b's and bert-large's
     shapes, bitwise equal reruns), its six derived backward graphs, the
     projections' derived backward graphs, in-kernel dropout bits and row
     panels, and the chained root and its six derived graphs without a causal mask at
     bert-large's shape; K8 selective scan at falcon-mamba-7b's prefill and
     engine-decode shapes; K10 Block-SpMM over the Fig. 8 sweep (4096^3,
     16x16 blocks, sparsity 0 to 0.9, bf16 and fp32, K1 and cuBLAS on the
     dense matrix beside it), 8x8 blocks and bert-large's sparse FFN
     products, each bf16 row on the wgmma kernel (its 64-row work list)
     beside the WMMA one (the pruned blocks' list); K9 at qwen3-moe's
     expert widths on wgmma (the replaced kernel's recorded time printed
     beside it), and checks
     (rows 8 and 100 a tile, ragged d and f, fp32 out, ids clamped) each on
     the variant its plan names; K7 Listing 6 at
     bert-large's output layers and N 5120, beside K5's keep-mask graph;
     K2 and K6 without a causal mask at bert-large's shape; K11 Listing 1 at
     benchmarks/bench_gemm.py's seven shapes under five spec strings on its
     wgmma variant, each bitwise equal to "bca"'s, K1 on the flat product
     and (at 2048^3) the WMMA variant beside it; K1 under
     those spec strings at llama2-13b's 5120x5120 projection, bitwise equal
     to its fixed grid; K12 at ResNet-50's 1x1 layers) against its
     plain PyTorch version on the card, at the main paths' shapes plus GQA,
     windowed and ragged ones; print error and tolerance, the median time
     over CUDA events, the plain version's time, one PyTorch library call's
     time as a yardstick (the port never calls it) and the bound;
  4. run ``generate_loop`` and the serving engine for reduced fp32
     llama2-13b, gpt-j-6b, minicpm-2b and falcon-mamba-7b on the card
     (kernels) and on the
     CPU (plain versions), without and with ``use_fusion``: the logits must
     agree, and the greedy tokens and the engine's greedy and sampled tokens
     must be equal;
  5. serve full-width llama2-13b (bf16, all 40 layers, random weights from a
     seed, batch 4, prompt 512, 16 new tokens) through ``generate_loop`` with
     every launch counter set to 0 just before and read just after: K1, K2
     and K3 must have launched, K2 once a layer and all on its bf16 wgmma
     kernel (``ATTENTION_WGMMA_LAUNCHES``, as in phases 6, 9 and 10b), every
     K1 launch on ``wgmma`` or ``wgmma_decode`` and none on ``wmma`` (as in
     phases 6, 7, 7b, 7f and 9 to 10c), the logits must be finite; one more
     run profiled, in which every K3 launch is the split kernel, one a call
     (as in phase 7);
  6. serve the same model through the continuous-batching engine (8 slots,
     16-token pages, 16 ragged requests, greedy and sampled): paged logits
     must equal dense ones, every request must finish with ``validate()``
     clean after every step, K4 must launch once per layer per decode step,
     and a drain on 3 slots must give the same tokens (schedule invariance);
  7. serve the same model with ``use_fusion=True``: K5 must launch twice per
     layer per prefill and per decode step, every launch on wgmma or
     wgmma_decode (as in 7e, 10, 10b and 10c, where wgmma_split joins
     them), and K1 four times per layer plus the logits, the logits must be
     finite; print prefill and decode times
     beside the unfused path's and the bounds, and how far the fused logits
     and tokens are from the unfused ones; then drain 8 requests through the
     engine on 8 slots and on 3: equal tokens, ``validate()`` clean;
 7f. (after 7e) serve full-width gpt-j-6b (bf16, all 28 layers, head dim
     256) through the engine: 8 ragged requests on 8 slots with
     ``validate()`` after every step, K4 at D 256 once a layer a decode
     step, and a 3-slot drain with equal tokens;
 7b. free llama2-13b and serve full-width falcon-mamba-7b (bf16, all 64
     layers, random weights from a seed): K8 must launch once per layer per
     prefill and per decode step and K1 four times per layer plus the
     logits, nothing else; a bucket-padded prefill must equal the unpadded
     one; ``generate_loop`` (batch 4, prompt 512, 16 new tokens) with every
     counter set to 0 just before and read just after, timed beside its
     bounds, with one profiled decode step; then the engine (8 slots, 16
     ragged requests, greedy and sampled, ``validate()`` after every step)
     and a 3-slot drain with equal tokens;
 7c. the paper's Block-SpMM path (``examples/sparse_inference.py``,
     ``benchmarks/bench_e2e.py``'s sparse row) at bert-large's widths: both
     FFN weights magnitude-pruned to 80 % of 8x8 blocks and stored once in
     64x8 blocks, up, gelu and down
     through ``ops.block_spmm`` on 4096 tokens with every counter set to 0
     just before and read just after (one K10 launch a call, on its wgmma
     kernel, nothing else),
     each against the dense pruned product, timed beside the dense
     ``torch.matmul``, K1 and the work list at 0 %; then Listing 6 through
     ``kernels.fused_output`` and qwen3-moe's experts through
     ``ops.grouped_matmul`` (one K9 launch, on wgmma), counted the same way;
  7d. PARLOOPER, with every counter set to 0 just before and read just
     after each run: Listing 1 (2048^3) through ``ops.brgemm_blocked``, one
     K11 launch; ResNet-50's 1x1 layers (N 32) through ``ops.conv2d``, one
     K12 call on one K1 launch a layer; its 3x3 layers (N 2) through
     Listing 4 on the executor, no kernel; each against its plain version;
  8. train reduced fp32 minicpm-2b, gpt-j-6b and bert-large for 3 steps on
     the card and on the CPU from one initial state (loss and grad norm
     must agree), and check that 2 steps + checkpoint + restore + 2 steps
     give the parameters of 4 steps straight, bit for bit; then 3 steps of
     each with ``use_fusion=True`` at dropout 0.15, CUDA against CPU;
  9. train minicpm-2b at full width and depth (fp32 masters, bf16 compute,
     B 4 x S 1024, remat) for 6 trainer steps with every launch counter set
     to 0 just before and read just after: losses and grad norms finite, K1
     (plain and transposed), K2 and K6 launched as often as the layer count
     implies, every K6 launch on its tensor-core kernels
     (``ATTENTION_BWD_WGMMA_LAUNCHES``); then 3 steps on one repeated
     batch, whose loss must fall at
     each step; print step time, tokens/s, model-FLOPs share, bound, peak
     memory and one profiled step's device breakdown;
 10. train the same model with ``use_fusion=True`` from phase 9's initial
     parameters and batches (4 trainer steps): K5's launches by graph must
     be what the derived backward plans imply (forward graphs twice a layer
     and step under remat, backward graphs once; the attention's backward
     is one chained-backward launch a layer and step, its six derived graphs
     launch 0 times; every chained forward and backward runs on wgmma), K2
     and K6 must not run,
     step 1's loss within rtol 2e-2 of phase 9's, and the loss must fall on
     a repeated batch; print the same numbers beside phase 9's;
 10b. train bert-large at full width and depth (24 bidirectional layers, d
     1024, B 16 x S 512; ``benchmarks/bench_e2e.py``'s train row) as phase 9
     (6 steps) and then with ``use_fusion=True`` as phase 10 (4 steps): K1,
     K2 and K6 launches as the layer count implies, K5's by graph, step 1's
     fused loss within rtol 2e-2 of the unfused one; print step time,
     sequences/s, tokens/s, the model-FLOPs share and peak memory;
 10c. train gpt-j-6b at full width (d 4096, 16 heads of 256, d_ff 16384;
     8 of its 28 layers, B 2 x S 2048) for 2 unfused trainer steps, then 4
     with ``use_fusion=True`` from the same state: K5's launches by graph as
     the derived plans imply, every chained forward and backward at D 256
     on wgmma, step 1's fused loss within rtol 2e-2 of the unfused one, a
     falling loss on a repeated batch; print step time, tokens/s, the
     model-FLOPs share and peak memory with the card's name and power limit;
 11. print one JSON line with every kernel's numbers;
 12. print the last line, ``{"ok": true, "device": {...}}``.

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

# Published dense peaks by card (NVIDIA data sheets): bf16 and TF32
# tensor-core and fp32 non-tensor FLOP/s, HBM bytes/s.
PEAKS = {
    "H100 SXM": {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "hbm": 3.35e12},
    "H100 PCIe": {"bf16": 756e12, "tf32": 378e12, "fp32": 51e12, "hbm": 2.0e12},
}

# Kernel against plain version on the card.  Both sides read the same inputs
# and accumulate in fp32, so they differ by summation order and, in bf16, by
# one rounding of the output (2^-8 relative) and the plain decode's bf16 p.
TOL = {"float32": {"gemm": (1e-4, 1e-3), "attn": (1e-4, 1e-4), "scan": (1e-4, 1e-4)},
       "bfloat16": {"gemm": (1e-2, 1e-2), "attn": (1e-2, 1e-2), "scan": (1e-2, 1e-2)}}
MODEL_TOL = (1e-4, 1e-3)   # logits, reduced fp32 configs: GPU kernels vs CPU plain

# file:line of the TPU kernel each CUDA kernel replaces: matmul_pallas,
# flash_attention_pallas, flash_decode_pallas, the Pallas path of
# paged_decode_attention, the attention backward plan, K5's lowering,
# mamba_scan_pallas, block_spmm_pallas, grouped_matmul_pallas,
# fused_output_pallas, brgemm_blocked_pallas and conv2d_1x1_pallas.
REPLACES = {
    "gemm": "src/repro/kernels/brgemm.py:58",
    "gemm_transposed": "src/repro/kernels/brgemm.py:58",
    "flash_attention": "src/repro/kernels/flash_attention.py:35",
    "flash_attention_bwd": "src/repro/fusion/autodiff.py:236",
    "flash_decode": "src/repro/kernels/flash_attention.py:169",
    "paged_decode": "src/repro/kernels/ops.py:103",
    "fused_gemm": "src/repro/fusion/lowering.py:330",
    "fused_chain": "src/repro/fusion/lowering.py:330",
    "fused_attention_bwd": "src/repro/fusion/lowering.py:330",
    "fused_proj_bwd": "src/repro/fusion/lowering.py:330",
    "mamba_scan": "src/repro/kernels/mamba_scan.py:27",
    "block_spmm": "src/repro/kernels/block_spmm.py:72",
    "grouped_matmul": "src/repro/kernels/block_spmm.py:137",
    "fused_output": "src/repro/kernels/fused_output.py:48",
    "brgemm_blocked": "src/repro/kernels/brgemm.py:152",
    "conv2d_1x1": "src/repro/kernels/conv.py:112",
    "hw_tile_bits": "src/repro/fusion/rng.py:212",
}
SOURCE = {
    "gemm": "src/repro_torch/kernels/csrc/gemm.cu",
    "gemm_transposed": "src/repro_torch/kernels/csrc/gemm.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_bwd": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
    "flash_decode": "src/repro_torch/kernels/csrc/flash_decode.cu",
    "paged_decode": "src/repro_torch/kernels/csrc/paged_decode.cu",
    # the templates; one source per graph is generated from them by
    # src/repro_torch/kernels/fused_gemm.py
    "fused_gemm": "src/repro_torch/kernels/csrc/fused_gemm.cuh",
    "fused_chain": "src/repro_torch/kernels/csrc/fused_chain.cuh",
    # the mainloop; one source per chained graph and head dim is generated
    # around it by src/repro_torch/kernels/fused_gemm.py
    "fused_attention_bwd": "src/repro_torch/kernels/csrc/attention_bwd.cuh",
    "fused_proj_bwd": "src/repro_torch/kernels/csrc/fused_gemm.cuh",
    "mamba_scan": "src/repro_torch/kernels/csrc/mamba_scan.cu",
    "block_spmm": "src/repro_torch/kernels/csrc/block_spmm.cu",
    "grouped_matmul": "src/repro_torch/kernels/csrc/block_spmm.cu",
    "fused_output": "src/repro_torch/kernels/csrc/fused_output.cu",
    "brgemm_blocked": "src/repro_torch/kernels/csrc/brgemm_blocked.cu",
    # the reshape around K1 (csrc/gemm.cu), under the spec string
    "conv2d_1x1": "src/repro_torch/kernels/conv.py",
    # K13, the Philox4x32-10 device function K5 draws from under hw_prng=True
    "hw_tile_bits": "src/repro_torch/kernels/csrc/philox.cuh",
}
KERNELS = tuple(SOURCE)
# What each kernel's ms, plain_ms, bound_ms and library_ms add up: the
# weighted cases of phase 3 (library: torch.matmul without the activation
# or on the flat matrices; cuDNN's convolution;
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
    "fused_gemm": "one llama2-13b layer's two fused graphs (fused_gated_mlp_silu, fused_attn_out_res)"
                  " at prefill (M 2048) plus one decode step (M 4)",
    "fused_chain": "one minicpm-2b layer's chained-root attention forward (B 4, H 36, S 1024, D 64,"
                   " causal)",
    "fused_attention_bwd": "K5's chained backward of one minicpm-2b layer's attention (B 4, H 36,"
                           " S 1024, D 64, causal): one generated kernel on csrc/attention_bwd.cuh"
                           " in place of the six derived graphs; library: SDPA's backward",
    "fused_proj_bwd": "one minicpm-2b layer's derived backward graphs of fused_attn_out_res"
                      " (dlhs, drhs) and fused_gated_mlp_silu (dz0, dlhs, drhs) at 4096 tokens",
    "mamba_scan": "one falcon-mamba-7b layer's scan at prefill (B 4, L 512, D 8192, N 16, bf16)"
                  " plus one engine decode step (B 8, L 1, from the cached state); no PyTorch"
                  " call computes a selective scan",
    "block_spmm": "bert-large's two FFN products at 80 % block sparsity (8x8 blocks) on 4096 tokens"
                  " (phase 7c: W_up 4096x1024 @ x^T, W_down 1024x4096 @ h^T, bf16); library:"
                  " torch.matmul on the dense pruned weights",
    "grouped_matmul": "one qwen3-moe expert layer's up projection: 4096 rows in 64-row tiles, d 4096"
                      " -> f 1536, 128 experts, sorted group ids, bf16; library: torch._grouped_mm"
                      " where the card's torch has it",
    "fused_output": "bert-large's two Listing 6 output layers at 4096 tokens (Bert-Output K 4096,"
                    " Bert-SelfOutput K 1024; N 1024, bf16, dropout 0.1 by a keep mask); no one"
                    " PyTorch call fuses the product with dropout, residual and layernorm",
    "brgemm_blocked": "Listing 1 at benchmarks/bench_gemm.py's seven shapes (1024^3 .. 4096x4096x11008),"
                      " bf16 64x64x64 blocks, k_step 4, spec 'bca'; library: torch.matmul on the flat"
                      " matrices",
    "conv2d_1x1": "ResNet-50's seven 1x1 layers at N 32, bf16, through ops.conv2d (blocking, reshape,"
                  " K1 under 'bca'); library: torch.nn.functional.conv2d in bf16 on channels-last"
                  " tensors",
    "hw_tile_bits": "K5 with hw_prng=True under pick_tiles' plan: minicpm-2b's fused_attn_out_do_res"
                    " (M 4096, K 2304 -> N 2304, rate 0.15) and bert-large's fused_output_graph(0.1)"
                    " at phase 10b's batch (M 8192, K 4096 -> N 1024), bf16; the bound is the graph's"
                    " (Philox's integer operations not counted: the table has no int32 rate);"
                    " library: torch.nn.functional.dropout on the (M, N) output, the draw alone",
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


def device_ms(torch, fn, reps=20):
    """Device milliseconds per call of ``fn``: ``reps`` calls enqueued
    behind a kernel that sleeps longer than the host takes to enqueue them,
    so the events time the kernels alone and not the host's launch cost
    (``time_ms`` of one call includes it while the card waits for it)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(reps * 400_000)      # ~0.2 ms of cycles a call at ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(torch, fn, reps=20):
    """Host microseconds per call of ``fn`` over ``reps`` calls back to
    back (the card synchronised before and after, not between)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


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
        # a kernel's library time measured for its whole row at once
        self.library_row = {}
        # numbers measured beside the cases (sweeps, K5 beside K7, ...)
        self.extra = {}

    def bound(self, flops, nbytes, kind):
        t_ops = flops / self.peaks[kind]
        t_bytes = nbytes / self.peaks["hbm"]
        return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"

    def run(self, kernel, label, fn, plain, library, *, flops, nbytes, dtype, tol_kind,
            weight=0, timed=True, peak=None):
        """Check ``fn()`` against ``plain()``; time kernel, plain version and
        library call; ``weight`` is how often the case occurs in the
        kernel's main-path row (0: a check only).  ``dtype`` names the
        tolerance; ``peak`` ("bf16" or "fp32", by default as ``dtype``) the
        rate the operations' bound takes."""
        torch = self.torch
        got = fn()
        torch.cuda.synchronize()
        want = plain()
        rtol, atol = TOL[dtype][tol_kind]
        err, ok = compare(torch, got, want, rtol, atol)
        kind = peak or ("bf16" if dtype == "bfloat16" else "fp32")
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
        tot["library_ms"] = self.library_row.get(kernel, (
            sum(x * r["weight"] for x, r in zip(lib, rows))
            if all(x is not None for x in lib) else None))
        share = {"operations": 0.0, "bytes": 0.0}
        for r in rows:
            share[r["bound_by"]] += r["bound_ms"] * r["weight"]
        tot["bound_by"] = max(share, key=share.get)
        tot["max_abs_err"] = max(r["max_abs_err"] for r in self.cases[kernel])
        return tot


def gemm_cases(torch, bench, ref, brgemm):
    """K1 at the main path's projections of one llama2-13b layer (prefill
    M = 4 x 512, decode M = 4; the engine's decode, M 8, beside them), each
    on its wgmma variant, with the WMMA variant it replaced timed on the
    same operands ("was") and each layer's device time without the host's
    launch cost (``device_ms``, K1 and cuBLAS); the engine's logits; then
    checks: all four transpositions on wgmma and wgmma_decode, ragged but
    TMA-aligned shapes, bias with each activation, bf16 in with fp32 out,
    the rows of an M 3 product bitwise equal to the same rows at M 8 and
    M 16, two calls bitwise equal, operands TMA cannot read on wmma and fp32
    on simt; and K1's host microseconds per decode-shaped call."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def operands(m, k, n, dtype, bias=False, ta=False, tb=False):
        a = torch.randn(k, m, generator=gen, device=dev).to(dtype).T if ta else \
            torch.randn(m, k, generator=gen, device=dev).to(dtype)
        b = (torch.randn(n, k, generator=gen, device=dev) / math.sqrt(k)).to(dtype).T if tb else \
            (torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)).to(dtype)
        c = torch.randn(n, generator=gen, device=dev).to(dtype) if bias else None
        return a, b, c

    def on(variant, label, a, b, *, bias=None, act=None, out=None):
        """One check of K1 against its plain version, on ``variant``."""
        check(brgemm.variant_of(a, b) == variant, f"K1 {label}: not on {variant}")
        counter = brgemm.VARIANT_COUNTERS[variant]
        before = getattr(brgemm, counter)
        m, k = a.shape
        n = b.shape[1]
        out_size = (out or a.dtype).itemsize
        got = bench.run("gemm", f"check {variant} {label}",
                        lambda: brgemm.matmul(a, b, bias=bias, activation=act, out_dtype=out),
                        lambda: ref.matmul_ref(a, b, bias=bias, activation=act, out_dtype=out),
                        None, flops=2 * m * n * k,
                        nbytes=a.element_size() * (m * k + k * n) + m * n * out_size,
                        dtype="bfloat16" if a.dtype == torch.bfloat16 else "float32",
                        tol_kind="gemm", timed=False)
        check(getattr(brgemm, counter) == before + 1, f"K1 {label}: {variant} did not launch")
        return got

    # prefill and generate_loop decode make up K1's row; the engine's decode
    # (M 8) is timed beside them
    layers = {}
    for m, phase_name, main in ((2048, "prefill", True), (4, "decode", True),
                                (8, "engine decode", False)):
        tot = dict.fromkeys(("ms", "device_ms", "wmma_ms", "wmma_device_ms", "library_ms",
                             "library_device_ms"), 0.0)
        for k, n, act, count in llama_layer():
            a, b, _ = operands(m, k, n, torch.bfloat16)
            check(brgemm.variant_of(a, b) == ("wgmma" if m > 16 else "wgmma_decode"),
                  f"K1 {phase_name} {m}x{k}x{n} is not on its wgmma variant")
            run = lambda: brgemm.matmul(a, b, activation=act)
            was = lambda: brgemm.matmul(a, b, activation=act, variant="wmma")
            lib = lambda: torch.matmul(a, b)
            bench.run("gemm", f"{phase_name} {m}x{k}x{n} {act or ''}", run,
                      lambda: ref.matmul_ref(a, b, activation=act), lib,
                      flops=2 * m * n * k, nbytes=2 * (m * k + k * n + m * n),
                      dtype="bfloat16", tol_kind="gemm", weight=count if main else 0)
            row = bench.cases["gemm"][-1]
            tot["ms"] += count * row["ms"]
            tot["library_ms"] += count * row["library_ms"]
            tot["device_ms"] += count * device_ms(torch, run)
            tot["wmma_ms"] += count * time_ms(torch, was)
            tot["wmma_device_ms"] += count * device_ms(torch, was)
            tot["library_device_ms"] += count * device_ms(torch, lib)
        layers[phase_name] = tot
        print(f"    K1 {phase_name} layer (M {m}, 7 projections): {tot['ms']:.4f} ms lone calls,"
              f" {tot['device_ms']:.4f} ms on the device; was (wmma) {tot['wmma_ms']:.4f} /"
              f" {tot['wmma_device_ms']:.4f}; cuBLAS {tot['library_ms']:.4f} /"
              f" {tot['library_device_ms']:.4f}", flush=True)
    bench.extra["gemm_layer_ms"] = layers
    d = 5120
    # the engine's logits: bf16 operands, fp32 output (library: bf16 out)
    m, k, n = 8, d, 32000
    a, b, _ = operands(m, k, n, torch.bfloat16)
    bench.run("gemm", f"engine logits {m}x{k}x{n} fp32 out",
              lambda: brgemm.matmul(a, b, out_dtype=torch.float32),
              lambda: ref.matmul_ref(a, b, out_dtype=torch.float32),
              lambda: torch.matmul(a, b),
              flops=2 * m * n * k, nbytes=2 * (m * k + k * n) + 4 * m * n,
              dtype="bfloat16", tol_kind="gemm")
    bench.extra["gemm_logits_device_ms"] = device_ms(
        torch, lambda: brgemm.matmul(a, b, out_dtype=torch.float32))
    # every transposition on both wgmma variants
    for ta in (False, True):
        for tb in (False, True):
            for variant, (m, k, n) in (("wgmma", (256, 192, 512)), ("wgmma_decode", (8, 512, 384))):
                a, b, _ = operands(m, k, n, torch.bfloat16, ta=ta, tb=tb)
                on(variant, f"{m}x{k}x{n} trans_a {ta} trans_b {tb}", a, b)
    # ragged but TMA-aligned edges in M, N and K
    for variant, (m, k, n) in (("wgmma", (200, 136, 520)), ("wgmma", (2100, 5120, 136)),
                               ("wgmma_decode", (5, 136, 520))):
        a, b, _ = operands(m, k, n, torch.bfloat16)
        on(variant, f"ragged {m}x{k}x{n}", a, b)
    # bias with each activation, and bf16 in with fp32 out
    for act in (None, "relu", "gelu", "silu", "sigmoid"):
        for variant, m in (("wgmma", 300), ("wgmma_decode", 7)):
            a, b, c = operands(m, 256, 384, torch.bfloat16, bias=True)
            on(variant, f"{m}x256x384 bias {act}", a, b, bias=c, act=act)
    for variant, m in (("wgmma", 300), ("wgmma_decode", 16)):
        a, b, _ = operands(m, 256, 384, torch.bfloat16)
        on(variant, f"{m}x256x384 fp32 out", a, b, out=torch.float32)
    # a row of C has the same bits at M 3, 8 and 16 (the split of K is fixed
    # from (K, N)), and two calls give the same bits
    for k, n, act in ((d, d, None), (d, 13824, "silu"), (13824, d, None)):
        a16, b, _ = operands(16, k, n, torch.bfloat16)
        c16 = brgemm.matmul(a16, b, activation=act)
        c8 = brgemm.matmul(a16[:8], b, activation=act)
        c3 = brgemm.matmul(a16[:3], b, activation=act)
        again = brgemm.matmul(a16, b, activation=act)
        torch.cuda.synchronize()
        check(torch.equal(c16[:3], c3) and torch.equal(c8[:3], c3),
              f"K1 wgmma_decode {k}x{n}: rows at M 3, 8 and 16 differ")
        check(torch.equal(c16, again), f"K1 wgmma_decode {k}x{n}: two calls differ")
    a, b, _ = operands(2048, d, d, torch.bfloat16)
    check(torch.equal(brgemm.matmul(a, b), brgemm.matmul(a, b)), "K1 wgmma: two calls differ")
    print("    K1: rows of M 3 = M 8 = M 16 bitwise at 5120x5120, 5120x13824 silu and 13824x5120;"
          " two calls bitwise equal (wgmma_decode, wgmma)", flush=True)
    # operands TMA cannot read run on wmma, fp32 on simt
    for m, k, n, act, dt in ((37, 200, 100, "gelu", torch.bfloat16),
                             (16, 96, 130, "relu", torch.bfloat16),
                             (70, 300, 96, "sigmoid", torch.float32),
                             (16, 64, 128, "silu", torch.float32)):
        a, b, c = operands(m, k, n, dt, bias=True)
        on("wmma" if dt == torch.bfloat16 else "simt", f"{m}x{k}x{n} bias {act}", a, b, bias=c,
           act=act)
    # bf16 in, fp32 out, unaligned leading dimension (scalar loads)
    a, b, _ = operands(48, 77, 64, torch.bfloat16)
    on("wmma", "48x77x64 fp32 out", a, b, out=torch.float32)
    # the host's cost of one decode-shaped call
    a, b, _ = operands(4, d, d, torch.bfloat16)
    host = {"k1_wgmma_decode": host_us(torch, lambda: brgemm.matmul(a, b)),
            "k1_wmma": host_us(torch, lambda: brgemm.matmul(a, b, variant="wmma")),
            "torch_matmul": host_us(torch, lambda: torch.matmul(a, b))}
    bench.extra["gemm_host_us_per_decode_call"] = host
    print(f"    K1 host us a decode-shaped call (4x5120x5120, 20 back to back): "
          + ", ".join(f"{k} {v:.1f}" for k, v in host.items()), flush=True)


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
        check(brgemm.variant_of(x, w) == "wgmma", f"K1 train fwd {t}x{k}x{n}: not on wgmma")
        bench.run("gemm", f"train fwd {t}x{k}x{n} {act or ''}",
                  lambda: brgemm.matmul(x, w, activation=act),
                  lambda: ref.matmul_ref(x, w, activation=act),
                  lambda: torch.matmul(x, w), flops=2 * t * n * k,
                  nbytes=2 * (t * k + k * n + t * n), dtype="bfloat16", tol_kind="gemm")
    del x, w
    dl, emb = randn(chunk, v, scale=1e-3), randn(v, d, scale=0.02)
    check(brgemm.variant_of(dl, emb) == "wgmma", "K1 dX logits: not on wgmma")
    bench.run("gemm", "dX logits (2048x122880)·(122880x2304)",
              lambda: brgemm.matmul(dl, emb), lambda: ref.matmul_ref(dl, emb),
              lambda: torch.matmul(dl, emb), flops=2 * chunk * v * d,
              nbytes=2 * (chunk * v + v * d + chunk * d), dtype="bfloat16", tol_kind="gemm")
    del dl, emb
    for label, a, b, out, weight, timed in cases:
        m, k = a.shape
        n = b.shape[1]
        dt = "bfloat16" if a.dtype == torch.bfloat16 else "float32"
        want = "wgmma" if weight else ("simt" if dt == "float32" else "wmma")
        check(brgemm.variant_of(a, b) == want, f"K1 {label}: not on {want}")
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


def _attention_operands(torch, gen, b, h, hk, sq, skv, d, dt, layout):
    """q, k, v as generate_loop passes them to K2: q a strided view of the
    (B, S, H, D) projection; k and v the same ("proj", the prefill's
    in-flight K/V) or slices [:, :, :Skv] of (B, Hk, Skv + 16, D) dense
    caches ("cache", a prompt after earlier tokens)."""
    q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dt).transpose(1, 2)
    if layout == "cache":
        k, v = (torch.randn(b, hk, skv + 16, d, generator=gen, device="cuda").to(dt)[:, :, :skv]
                for _ in range(2))
    else:
        k, v = (torch.randn(b, skv, hk, d, generator=gen, device="cuda").to(dt).transpose(1, 2)
                for _ in range(2))
    return q, k, v


def ptxas_by_kernel(log):
    """``nvcc -Xptxas -v`` lines of a build log by mangled kernel name:
    {name: "Used N registers, ...; B bytes stack frame, S bytes spill
    stores, L bytes spill loads"}."""
    out, name = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            name = found.group(1)
            out[name] = []
        elif name and ("stack frame" in line or "Used " in line):
            out[name].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def k2_build_report(build, fa, log):
    """Print the ``-Xptxas -v`` figures of each K2 instantiation (the bf16
    kernel, csrc/attention_fwd.cuh's mainloop on K2's epilogue, and the
    fp32 SIMT kernel, by head dim), with the dynamic
    shared memory of its plan, and, where ``cuobjdump`` is on the path, the
    HGMMA instructions of each bf16 instantiation; → those figures."""
    import shutil
    import torch

    report = {}
    for mangled, figures in ptxas_by_kernel(log).items():
        found = re.search(r"(flash_attention_kernel|attention_fwd_wgmma_kernel)I(?:f)?Li(\d+)E",
                          mangled)
        if not found:
            continue
        kernel, d = found.group(1), int(found.group(2))
        wgmma = "wgmma" in kernel
        t = torch.empty(1, 1, 1, d, dtype=torch.bfloat16 if wgmma else torch.float32)
        plan = fa.forward_plan(t, t, t)
        report[f"{kernel}<{d}>"] = {"mangled": mangled, "ptxas": figures,
                                    "dynamic_smem_bytes": plan.smem_bytes, "rows": plan.rows,
                                    "bn": plan.bn, "stages": plan.stages}
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(tool).exists():
        sass = subprocess.run([tool, "-sass", str(build._target("flash_attention"))],
                              capture_output=True, text=True, timeout=300).stdout
        for part in sass.split("Function : ")[1:]:
            name = part.split()[0]
            for row in report.values():
                if row["mangled"] == name:
                    row["hgmma"] = part.count("HGMMA")
    for name, row in sorted(report.items()):
        print(f"  K2 {name}: {row['ptxas']}; dynamic smem {row['dynamic_smem_bytes']} bytes"
              f" ({row['rows']} rows, BN {row['bn']}, {row['stages']} stages)"
              + (f"; {row['hgmma']} HGMMA instructions" if "hgmma" in row else ""), flush=True)
    return report


def gemm_build_report(build, logs):
    """Print the ``-Xptxas -v`` figures of each instantiation of the GEMM
    mainloop (csrc/gemm_mainloop.cuh: K1's wgmma and wgmma_decode kernels,
    plain and transposed, and K11's wgmma kernel by tile), its CTA shape,
    dynamic shared memory and, where ``cuobjdump`` is on the path, its HGMMA
    instructions; → those figures by kernel."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    report = {}
    for lib in ("gemm", "brgemm_blocked"):
        rows = {}
        for mangled, figures in ptxas_by_kernel(logs[lib]).items():
            found = re.search(r"((?:gemm_transposed_bf16|gemm_bf16|brgemm_blocked_bf16)_wgmma"
                              r"(?:_decode)?)IN7gemm_ml6ConfigILi(\d+)ELi(\d+)ELi(\d+)"
                              r"ELb([01])ELb([01])EE(?:ELb([01])E)?", mangled)
            if not found:
                continue
            kernel, wg, bn, stages, a_mn, b_mn, paired = found.groups()
            wg, bn, stages = int(wg), int(bn), int(stages)
            smem = 1024 + stages * (64 * wg + bn) * 128 + 16 * stages + 16
            rows[f"{kernel}<{64 * wg}x{bn}, {stages} stages, A_MN {a_mn}, B_MN {b_mn}"
                 + (", paired" if paired == "1" else "") + ">"] = {
                "mangled": mangled, "ptxas": figures, "dynamic_smem_bytes": smem,
                "threads": 128 * wg + 32}
        if Path(tool).exists():
            sass = subprocess.run([tool, "-sass", str(build._target(lib))], capture_output=True,
                                  text=True, timeout=300).stdout
            for part in sass.split("Function : ")[1:]:
                for row in rows.values():
                    if row["mangled"] == part.split()[0]:
                        row["hgmma"] = part.count("HGMMA")
        for name, row in sorted(rows.items()):
            print(f"  {lib} {name}: {row['ptxas']}; {row['threads']} threads, dynamic smem"
                  f" {row['dynamic_smem_bytes']} bytes"
                  + (f"; {row['hgmma']} HGMMA instructions" if "hgmma" in row else ""), flush=True)
        report[lib] = rows
    return report


def bwd_build_report(build, fa, logs, chained):
    """Print the ``-Xptxas -v`` figures of each attention-backward
    instantiation (csrc/attention_bwd.cuh's dk/dv and dq kernels, wgmma and
    SIMT): K6's by head dim and each generated chained backward's
    (``chained``: name → source), with the dynamic shared memory of its
    plan and, where ``cuobjdump`` is on the path, each wgmma kernel's HGMMA
    instructions; → those figures by library."""
    import shutil
    import torch

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    report = {}
    for lib in ("flash_attention_bwd", *chained):
        rows = {}
        for mangled, figures in ptxas_by_kernel(logs[lib]).items():
            found = re.search(r"((?:dkdv|dq)_(?:wgmma|simt)_kernel)ILi(\d+)E", mangled)
            if not found:
                continue
            kernel, d = found.group(1), int(found.group(2))
            t = torch.empty(1, 1, 1, d, dtype=torch.bfloat16 if "wgmma" in kernel else torch.float32)
            plan = fa.backward_plan(t, t, t)
            rows[f"{kernel}<{d}>"] = {"mangled": mangled, "ptxas": figures,
                                      "dynamic_smem_bytes": plan.kv_smem if kernel.startswith("dkdv")
                                      else plan.q_smem}
        target = (build._target(lib) if lib == "flash_attention_bwd"
                  else build._generated_target(lib, chained[lib]))
        if Path(tool).exists():
            sass = subprocess.run([tool, "-sass", str(target)], capture_output=True, text=True,
                                  timeout=300).stdout
            for part in sass.split("Function : ")[1:]:
                for row in rows.values():
                    if row["mangled"] == part.split()[0]:
                        row["hgmma"] = part.count("HGMMA")
        for name, row in sorted(rows.items()):
            print(f"  {lib} {name}: {row['ptxas']}; dynamic smem {row['dynamic_smem_bytes']} bytes"
                  + (f"; {row['hgmma']} HGMMA instructions" if "hgmma" in row else ""), flush=True)
        report[lib] = rows
    return report


def chain_build_report(build, fusion, fused_gemm, fa, logs):
    """Print the ``-Xptxas -v`` figures of the chained forward's wgmma
    instantiations (csrc/attention_fwd.cuh on the generated epilogue) in
    the sources of minicpm-2b's, bert-large's and gpt-j-6b's attention
    graphs, by head dim, with the dynamic shared memory of the plan and,
    where ``cuobjdump`` is on the path, the HGMMA instructions; → those
    figures by config."""
    import shutil
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    report = {}
    for arch in ("minicpm_2b", "bert_large", "gptj_6b"):
        cfg = get_config(arch)
        graph = fusion.simplify_graph(attention_graph(fusion, cfg, lm.layer_kinds(cfg)[0]))
        src = fused_gemm.generate_source(graph)
        name = fused_gemm.source_name(graph, src)
        rows = {}
        for mangled, figures in ptxas_by_kernel(logs[name]).items():
            found = re.search(r"attention_fwd_wgmma_kernelILi(\d+)E", mangled)
            if found:
                d = int(found.group(1))
                wg, bn, stages = fa.WGMMA_TILES[d]
                rows[d] = {"mangled": mangled, "ptxas": figures,
                           "dynamic_smem_bytes": fa.wgmma_smem(d, 64 * wg, bn, stages)}
        if Path(tool).exists():
            sass = subprocess.run([tool, "-sass", str(build._generated_target(name, src))],
                                  capture_output=True, text=True, timeout=300).stdout
            for part in sass.split("Function : ")[1:]:
                for row in rows.values():
                    if row["mangled"] == part.split()[0]:
                        row["hgmma"] = part.count("HGMMA")
        for d, row in sorted(rows.items()):
            print(f"  chained forward ({cfg.name}, {name}) D {d}: {row['ptxas']}; dynamic smem"
                  f" {row['dynamic_smem_bytes']} bytes"
                  + (f"; {row['hgmma']} HGMMA instructions" if "hgmma" in row else ""), flush=True)
        report[arch] = {"source": name, "by_head_dim": rows}
    return report


def _ptxas_numbers(figures):
    """(registers, spill stores + loads, stack frame) bytes of one
    ``ptxas_by_kernel`` entry."""
    def num(pattern):
        found = re.search(pattern, figures)
        return int(found.group(1)) if found else 0
    return (num(r"Used (\d+) registers"),
            num(r"(\d+) bytes spill stores") + num(r"(\d+) bytes spill loads"),
            num(r"(\d+) bytes stack frame"))


def k5_k10_build_report(logs, sources, fused_gemm):
    """Print, for the tensor-core instantiations of K5's GEMM-rooted graphs
    (csrc/fused_gemm.cuh: fused_gemm_bf16_wgmma by its WTile (consumer
    warpgroups, lhs and rhs pieces), fused_gemm_bf16_wgmma_decode,
    fused_panel_bf16_wgmma) grouped by (kernel, roots, distinct lhs, tile)
    over every generated source, the sources, registers (min-max), spilled
    and stack bytes and the dynamic shared memory of the tile; then K10's
    block_spmm_bf16_wgmma by block depth and B's layout; and any ptxas
    C7518 warning (serialized wgmma).  → those figures."""
    groups, warnings = {}, []
    for name, src in sources.items():
        if "fused_chain.cuh" in src:
            continue
        roots = int(re.search(r"static constexpr int R = (\d+);", src).group(1))
        nl = int(re.search(r"static constexpr int NLHS = (\d+);", src).group(1))
        warnings += [f"{name}: {ln.strip()}" for ln in logs[name].splitlines() if "C7518" in ln]
        for mangled, figures in ptxas_by_kernel(logs[name]).items():
            kind = re.search(r"(fused_gemm_bf16_wgmma_decode|fused_gemm_bf16_wgmma|"
                             r"fused_panel_bf16_wgmma)I", mangled)
            if not kind:
                continue
            tile = re.search(r"WTileI\w+?Li(\d)ELi(\d)ELi(\d)E", mangled)
            if tile:
                wg, pa, pb = (int(x) for x in tile.groups())
                smem = fused_gemm.wgmma_tile(roots, nl, (pa, pb), wg == 1)[3]
                key = f"{kind.group(1)}<R {roots}, NL {nl}, WG {wg}, pieces ({pa}, {pb})>"
            else:
                stages = min(6, max(2, 112 * 1024 // ((roots * 128 + nl * 16) * 128)))
                smem = 1024 + stages * (roots * 128 + nl * 16) * 128 + 16 * stages + 16
                key = f"{kind.group(1)}<R {roots}, NL {nl}, {stages} stages>"
            row = groups.setdefault(key, {"sources": 0, "registers": [], "spill_bytes": 0,
                                          "stack_bytes": 0, "dynamic_smem_bytes": smem})
            regs, spill, stack = _ptxas_numbers(figures)
            row["sources"] += 1
            row["registers"].append(regs)
            row["spill_bytes"] = max(row["spill_bytes"], spill)
            row["stack_bytes"] = max(row["stack_bytes"], stack)
    for key, row in sorted(groups.items()):
        regs = row.pop("registers")
        row["registers"] = [min(regs), max(regs)]
        print(f"  K5 {key}: {row['sources']} sources, {min(regs)}-{max(regs)} registers,"
              f" spills {row['spill_bytes']} bytes, stack {row['stack_bytes']} bytes, dynamic"
              f" smem {row['dynamic_smem_bytes']} bytes", flush=True)
    k10 = {}
    for mangled, figures in ptxas_by_kernel(logs["block_spmm"]).items():
        found = re.search(r"block_spmm_bf16_wgmmaILi(\d+)ELb([01])E", mangled)
        if found:
            bk, tb = int(found.group(1)), found.group(2) == "1"
            # spmm_wg::Cfg: 4 stages of 4 k16 steps, each B's 16 x 128 and
            # the step's 64 x 16 blocks
            k10[f"64x{bk}, B {'stored (N, K)' if tb else '(K, N)'}"] = {
                "ptxas": figures, "dynamic_smem_bytes": 1024 + 4 * 4 * (4096 + 2048) + 16 * 4}
    for key, row in sorted(k10.items()):
        print(f"  K10 block_spmm_bf16_wgmma {key}: {row['ptxas']}; dynamic smem"
              f" {row['dynamic_smem_bytes']} bytes", flush=True)
    print(f"  ptxas C7518 (serialized wgmma) warnings: {len(warnings)}"
          + "".join(f"\n    {w}" for w in warnings[:10]), flush=True)
    return {"k5": groups, "k10": k10, "c7518": warnings}


def k3_k9_build_report(logs):
    """Print the ``-Xptxas -v`` figures of K3's split kernel by dtype and
    head dim (csrc/flash_decode.cu) and of K9's wgmma kernel
    (csrc/block_spmm.cu), and any ptxas C7518 warning (serialized wgmma) in
    K9's source; → those figures."""
    report = {}
    for mangled, figures in ptxas_by_kernel(logs["flash_decode"]).items():
        found = re.search(r"flash_decode_split_kernelI(f|13__nv_bfloat16)Li(\d+)E", mangled)
        if found:
            dt = "fp32" if found.group(1) == "f" else "bf16"
            report[f"K3 flash_decode_split_kernel<{dt}, {found.group(2)}>"] = figures
    for mangled, figures in ptxas_by_kernel(logs["block_spmm"]).items():
        if "grouped_matmul_bf16_wgmma" in mangled:
            report["K9 grouped_matmul_bf16_wgmma"] = figures
    warnings = [ln.strip() for ln in logs["block_spmm"].splitlines() if "C7518" in ln]
    for name, figures in sorted(report.items()):
        print(f"  {name}: {figures}", flush=True)
    print(f"  csrc/block_spmm.cu ptxas C7518 (serialized wgmma) warnings: {len(warnings)}",
          flush=True)
    return {"kernels": report, "c7518": warnings}


def k4_k8_build_report(logs):
    """Print the ``-Xptxas -v`` figures of K4's split kernel by dtype and
    head dim (csrc/paged_decode.cu) and of K8's two kernels
    (csrc/mamba_scan.cu: prefill by dtype, state size and lanes, decode by
    dtype and state size); → those figures."""
    report = {}
    dts = {"f": "fp32", "13__nv_bfloat16": "bf16"}
    for mangled, figures in ptxas_by_kernel(logs["paged_decode"]).items():
        found = re.search(r"paged_decode_split_kernelI(f|13__nv_bfloat16)Li(\d+)E", mangled)
        if found:
            report[f"K4 paged_decode_split_kernel<{dts[found.group(1)]}, {found.group(2)}>"] = figures
    for mangled, figures in ptxas_by_kernel(logs["mamba_scan"]).items():
        found = re.search(r"mamba_scan_(prefill|decode)_kernelI(f|13__nv_bfloat16)Li(\d+)E"
                          r"(?:Li(\d+)E)?", mangled)
        if found:
            kind, dt, n, lanes = found.groups()
            report[f"K8 mamba_scan_{kind}_kernel<{dts[dt]}, N {n}"
                   + (f", {lanes} lanes>" if lanes else ">")] = figures
    for name, figures in sorted(report.items()):
        print(f"  {name}: {figures}", flush=True)
    return report


def attention_cases(torch, bench, ref, fa):
    """K2 at the prefill shape (B 4, H 40, S 512, D 128, causal, bf16), GQA,
    windowed, minicpm-2b's training forward (B 4, H 36, S 1024, D 64),
    bert-large's (B 16, H 16, S 512, D 64, not causal), and small checks at
    the bf16 kernel's edges: rows with no key (Sq 70 > Skv 40), Sq < Skv,
    Sq and Skv ragged against the 128-row and 64- or 128-key tiles, D 16,
    32 and 256, windows 24 and 100, GQA 5:1, k and v as dense-cache slices;
    and fp32 checks on the SIMT kernel."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # label, B, H, Hk, Sq, Skv, D, causal, window, dtype, weight, timed, layout
        ("main B4 H40 S512 D128 causal", 4, 40, 40, 512, 512, 128, True, None, bf, 1, True, "proj"),
        ("gqa B4 H40 Hk8 S512 D128", 4, 40, 8, 512, 512, 128, True, None, bf, 0, True, "proj"),
        ("window128 B4 H40 S512 D128", 4, 40, 40, 512, 512, 128, True, 128, bf, 0, True, "proj"),
        ("minicpm train B4 H36 S1024 D64 causal", 4, 36, 36, 1024, 1024, 64, True, None, bf, 0, True, "proj"),
        ("bert train B16 H16 S512 D64 noncausal", 16, 16, 16, 512, 512, 64, False, None, bf, 0, True, "proj"),
        ("check Sq50 Skv77 H4 Hk2 D16 fp32", 2, 4, 2, 50, 77, 16, True, None, f32, 0, False, "proj"),
        ("check Sq64 H4 Hk2 D16 window24 fp32", 2, 4, 2, 64, 64, 16, True, 24, f32, 0, False, "proj"),
        ("check Sq40 Skv40 H6 Hk3 D64 noncausal", 1, 6, 3, 40, 40, 64, False, None, bf, 0, False, "proj"),
        ("check Sq33 H2 D256 causal", 1, 2, 2, 33, 33, 256, True, None, bf, 0, False, "proj"),
        ("check Sq70 Skv40 H4 D16 masked rows", 2, 4, 4, 70, 40, 16, True, None, bf, 0, False, "proj"),
        ("check Sq50 Skv77 H4 Hk2 D16", 2, 4, 2, 50, 77, 16, True, None, bf, 0, False, "proj"),
        ("check Sq65 Skv200 H2 D32 window24", 1, 2, 2, 65, 200, 32, True, 24, bf, 0, False, "proj"),
        ("check Sq200 H4 D64 window24", 2, 4, 4, 200, 200, 64, True, 24, bf, 0, False, "proj"),
        ("check Sq300 Skv300 H10 Hk2 D128 window100", 1, 10, 2, 300, 300, 128, True, 100, bf, 0, False, "proj"),
        ("check Sq129 Skv257 H4 D256 noncausal", 1, 4, 4, 129, 257, 256, False, None, bf, 0, False, "proj"),
        ("check Sq97 Skv61 H2 D256 masked rows", 1, 2, 2, 97, 61, 256, True, None, bf, 0, False, "proj"),
        ("check Sq200 Skv200 H5 Hk1 D32 noncausal window100", 2, 5, 1, 200, 200, 32, False, 100, bf, 0, False, "proj"),
        ("check dense-cache slice Sq480 H40 Hk8 D128", 1, 40, 8, 480, 480, 128, True, None, bf, 0, False, "cache"),
        ("check dense-cache slice Sq32 Skv300 H40 D128", 2, 40, 40, 32, 300, 128, True, None, bf, 0, False, "cache"),
        ("check dense-cache slice Sq200 H36 D64", 1, 36, 36, 200, 200, 64, True, None, bf, 0, False, "cache"),
    ]
    for label, b, h, hk, sq, skv, d, causal, window, dt, weight, timed, layout in cases:
        q, k, v = _attention_operands(torch, gen, b, h, hk, sq, skv, d, dt, layout)
        pairs = _pairs(torch, sq, skv, causal, window)
        if window is None:
            library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                             enable_gqa=hk != h)
        else:
            keep = torch.ones(sq, skv, dtype=torch.bool, device="cuda").tril().triu(-(window - 1))
            library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep,
                                                             enable_gqa=hk != h)
        if causal and sq > skv:
            # rows with every key masked: NaN in the plain version, 0 from K2
            def plain():
                o, lse = ref.attention_fwd_ref(q, k, v, causal=causal, window=window)
                return torch.where(torch.isfinite(lse)[..., None], o.float(), 0.0).to(o.dtype)
        else:
            plain = lambda: ref.attention_ref(q, k, v, causal=causal, window=window)
        name = "bfloat16" if dt == torch.bfloat16 else "float32"
        kernel = lambda: fa.flash_attention(q, k, v, causal=causal, window=window)
        bench.run("flash_attention", label, kernel, plain, library if timed else None,
                  flops=4 * b * h * d * pairs,
                  nbytes=q.element_size() * (2 * b * h * sq * d + 2 * b * hk * skv * d),
                  dtype=name, tol_kind="attn", weight=weight, timed=timed)
        if timed:
            # the device's rate without the host's cost of a lone launch: 20
            # calls back to back between two events, as a model path issues them
            def back_to_back(fn):
                return time_ms(torch, lambda: [fn() for _ in range(20)], warmup=1, reps=5) / 20
            row = {"kernel_ms": back_to_back(kernel), "library_ms": back_to_back(library)}
            bench.extra.setdefault("flash_attention_back_to_back", {})[label] = row
            print(f"  {'':15s} {label:38s} 20 back to back: kernel {row['kernel_ms']:.4f} ms"
                  f"  library {row['library_ms']:.4f} ms", flush=True)


def attention_bwd_cases(torch, bench, ref, fa):
    """K6 against its plain version from the same (o, lse) of K2 (whose o
    and lse are first held against the plain version's): minicpm-2b's training
    shape (B 4, H 36, S 1024, D 64, causal, bf16), llama2-13b's (B 1, H 40,
    S 512, D 128), GQA, window 128, bert-large's (B 16, H 16, S 512, D 64,
    not causal), and small fp32 and bf16 checks (ragged, Sq < Skv,
    noncausal, windows 24 and 100, GQA 5:1, D 16 to 256, rows with every
    key masked)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(10)
    cases = [  # label, B, H, Hk, Sq, Skv, D, causal, window, dtype, weight, timed
        ("minicpm B4 H36 S1024 D64 causal", 4, 36, 36, 1024, 1024, 64, True, None, torch.bfloat16, 1, True),
        ("llama2 B1 H40 S512 D128 causal", 1, 40, 40, 512, 512, 128, True, None, torch.bfloat16, 0, True),
        ("gqa B2 H32 Hk8 S512 D128 causal", 2, 32, 8, 512, 512, 128, True, None, torch.bfloat16, 0, True),
        ("window128 B4 H36 S1024 D64", 4, 36, 36, 1024, 1024, 64, True, 128, torch.bfloat16, 0, True),
        ("bert B16 H16 S512 D64 noncausal", 16, 16, 16, 512, 512, 64, False, None, torch.bfloat16, 0, True),
        ("check Sq50 Skv77 H4 Hk2 D16 fp32", 2, 4, 2, 50, 77, 16, True, None, torch.float32, 0, False),
        ("check Sq64 H4 Hk2 D16 window24 fp32", 2, 4, 2, 64, 64, 16, True, 24, torch.float32, 0, False),
        ("check Sq40 H6 Hk3 D32 noncausal fp32", 1, 6, 3, 40, 40, 32, False, None, torch.float32, 0, False),
        ("check Sq33 H2 D256 causal", 1, 2, 2, 33, 33, 256, True, None, torch.bfloat16, 0, False),
        ("check Sq70 Skv40 H4 D16 masked rows fp32", 2, 4, 4, 70, 40, 16, True, None, torch.float32, 0, False),
        ("check Sq70 Skv40 H4 D16 masked rows", 2, 4, 4, 70, 40, 16, True, None, torch.bfloat16, 0, False),
        ("check Sq50 Skv77 H4 Hk2 D32", 2, 4, 2, 50, 77, 32, True, None, torch.bfloat16, 0, False),
        ("check Sq200 H4 D64 window24", 2, 4, 4, 200, 200, 64, True, 24, torch.bfloat16, 0, False),
        ("check Sq300 H10 Hk2 D128 window100", 1, 10, 2, 300, 300, 128, True, 100, torch.bfloat16, 0, False),
        ("check Sq129 Skv257 H4 D256 noncausal", 1, 4, 4, 129, 257, 256, False, None, torch.bfloat16, 0, False),
        ("gptj B1 H16 S512 D256 causal", 1, 16, 16, 512, 512, 256, True, None, torch.bfloat16, 0, True),
        ("check Sq50 Skv77 H4 Hk2 D16", 2, 4, 2, 50, 77, 16, True, None, torch.bfloat16, 0, False),
        ("check Sq64 Skv64 H2 D64 noncausal", 1, 2, 2, 64, 64, 64, False, None, torch.bfloat16, 0, False),
        ("check Sq97 Skv61 H2 D256 masked rows", 1, 2, 2, 97, 61, 256, True, None, torch.bfloat16, 0, False),
        ("check Sq200 Skv200 H5 Hk1 D32 noncausal window100", 2, 5, 1, 200, 200, 32, False, 100, torch.bfloat16, 0, False),
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
        fn = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, window=window)
        got = bench.run("flash_attention_bwd", f"{label} (K2 o err {o_err:.1e}, lse err {err:.1e})",
                        fn,
                        lambda: ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window),
                        library,
                        flops=10 * b * h * d * pairs,
                        nbytes=q.element_size() * (4 * b * h * sq * d + 4 * b * hk * skv * d) + 4 * b * h * sq,
                        dtype=name, tol_kind="attn", weight=weight, timed=timed)
        # no float atomics: a rerun gives the same bits
        check(all(torch.equal(a, c) for a, c in zip(got, fn())),
              f"K6 {label}: two identical calls differ")


# The lone-call times of the kernels K3's split and K9's wgmma variant
# replaced (K3: one block a (batch, kv head), one 32-key tile of scalar loads
# at a time; K9: K1's unpipelined WMMA tile), chip_smoke.py phase 3 on an
# NVIDIA H100 80GB HBM3 at 700 W, as PERF.md's rows keep them: printed beside
# this run's times, never part of its results
WAS_MS = {"main B4 H40 S528 D128 len520": 0.2036, "gptj B4 H16 S528 D256 len520": 0.1968,
          "qwen3-moe": 0.6432,
          # K4 and K8 before their redesign (a lone call each, PERF.md)
          "main B8 H40 D128 ps16 len37..1000": 0.2169,
          "gptj B8 H16 D256 ps16 len37..1000": 0.3254,
          "prefill B4 L512 D8192 N16 strided B/C": 0.3825,
          "engine decode B8 L1 D8192 N16 h0": 0.0783,
          "decode B4 L1 D8192 N16 h0": 0.0646,
          "batch-1 prefill L512 D8192 N16": 0.1810}


def device_row(torch, bench, kernel, fn):
    """Time ``fn`` on the device alone (``device_ms``) into the last case of
    ``kernel`` and print it beside the replaced kernel's recorded time."""
    row = bench.cases[kernel][-1]
    row["device_ms"] = device_ms(torch, fn)
    label = row["case"]
    print(f"    device {row['device_ms']:.4f} ms"
          + (f"; was {WAS_MS[label]:.4f} ms (the replaced kernel, a lone call, PERF.md)"
             if label in WAS_MS else ""), flush=True)
    return row


def decode_cases(torch, bench, ref, fa):
    """K3 at the decode shape (B 4, H 40, D 128, cache 528, length 520,
    bf16), GQA, windowed, ragged lengths and gpt-j-6b's D 256, each timed
    row with its device time (``device_ms``), the replaced kernel's
    recorded time (``WAS_MS``) printed beside it; library: SDPA over the
    live keys (the window's slice of them); then the split's own checks: every row
    decoded at B 1 bitwise equal to the same row at B 4 (main and ragged
    lengths), caches whose S is not a multiple of the chunk, a window edge
    inside a chunk, a slot of length 0 (zeros; the plain version's softmax
    has no key there), and a misaligned cache refused."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    chunk = fa.DECODE_CHUNK
    cases = [  # label, B, H, Hk, S, D, lengths, window, dtype, weight, timed
        ("main B4 H40 S528 D128 len520", 4, 40, 40, 528, 128, [520] * 4, None, bf16, 1, True),
        ("gqa B4 H40 Hk8 S528 D128 len520", 4, 40, 8, 528, 128, [520] * 4, None, bf16, 0, True),
        ("window128 B4 H40 S528 D128 len520", 4, 40, 40, 528, 128, [520] * 4, 128, bf16, 0, True),
        ("check ragged lens H40 Hk8 D128", 4, 40, 8, 528, 128, [1, 300, 528, 77], None, bf16, 0, False),
        ("check ragged lens H4 Hk2 D16 window16 fp32", 3, 4, 2, 64, 16, [20, 64, 37], 16, f32, 0, False),
        ("check H16 Hk1 D128 fp32", 2, 16, 1, 100, 128, [100, 61], None, f32, 0, False),
        ("gptj B4 H16 S528 D256 len520", 4, 16, 16, 528, 256, [520] * 4, None, bf16, 0, True),
        ("check ragged lens H16 D256 window64", 3, 16, 16, 300, 256, [1, 300, 129], 64, bf16, 0, False),
        # S not a multiple of the chunk; lengths clamped to S
        (f"check S{3 * chunk + 44} H8 Hk2 D128 len above S", 3, 8, 2, 3 * chunk + 44, 128,
         [3 * chunk + 44, 3 * chunk + 100, chunk + 1], None, bf16, 0, False),
        ("check S37 H8 Hk8 D64 fp32 one chunk", 2, 8, 8, 37, 64, [37, 5], None, f32, 0, False),
        # window edges inside a chunk, one row's window reaching back past key 0
        ("check window100 H40 Hk8 D128 edges inside chunks", 4, 40, 8, 528, 128,
         [520, 300, 101, 99], 100, bf16, 0, False),
    ]
    bitwise = []
    for label, b, h, hk, s, d, lens, window, dt, weight, timed in cases:
        q = torch.randn(b, 1, h, d, generator=gen, device="cuda").to(dt).transpose(1, 2)[:, :, 0]
        kc = torch.randn(b, hk, s, d, generator=gen, device="cuda").to(dt)
        vc = torch.randn(b, hk, s, d, generator=gen, device="cuda").to(dt)
        length = torch.tensor(lens, dtype=torch.int32, device="cuda")
        live = [min(n, s) for n in lens]
        valid = sum(min(n, window) if window else n for n in live)
        library = None
        if timed:      # every length equal: SDPA over the live keys computes the same
            hi = lens[0]
            lo = max(hi - window, 0) if window else 0
            library = lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc[:, :, lo:hi], vc[:, :, lo:hi], enable_gqa=hk != h)
        name = "bfloat16" if dt == bf16 else "float32"
        fn = lambda: fa.flash_decode(q, kc, vc, length=length, window=window)  # noqa: E731
        out = bench.run("flash_decode", label, fn,
                        lambda: ref.decode_attention_ref(q, kc, vc, length=length, window=window),
                        library,
                        flops=4 * h * d * valid,
                        nbytes=q.element_size() * (2 * b * h * d + 2 * hk * d * valid),
                        dtype=name, tol_kind="attn", weight=weight, timed=timed)
        if timed:
            device_row(torch, bench, "flash_decode", fn)
        if label.startswith(("main", "check ragged lens H40")):
            bitwise.append((label, q, kc, vc, length, window, out))
    # a row's bits do not depend on the batch it is decoded in
    for label, q, kc, vc, length, window, out in bitwise:
        for i in range(q.shape[0]):
            one = fa.flash_decode(q[i:i + 1], kc[i:i + 1], vc[i:i + 1], length=length[i:i + 1],
                                  window=window)
            check(torch.equal(one, out[i:i + 1]),
                  f"K3 {label}: row {i} decoded at B 1 differs from the same row at B 4")
    print(f"  flash_decode rows at B 1 bitwise equal to B 4: {len(bitwise)} cases", flush=True)
    # a slot of length 0 gives zeros; the others hold against the plain version
    b, h, hk, s, d = 4, 40, 8, 528, 128
    q = torch.randn(b, h, d, generator=gen, device="cuda").to(bf16)
    kc = torch.randn(b, hk, s, d, generator=gen, device="cuda").to(bf16)
    vc = torch.randn(b, hk, s, d, generator=gen, device="cuda").to(bf16)
    length = torch.tensor([0, 520, 1, chunk], dtype=torch.int32, device="cuda")
    out = fa.flash_decode(q, kc, vc, length=length)
    err, ok = compare(torch, out[1:], ref.decode_attention_ref(q[1:], kc[1:], vc[1:],
                                                               length=length[1:]),
                      *TOL["bfloat16"]["attn"])
    check(float(out[0].float().abs().max()) == 0.0 and ok,
          f"K3 with a slot of length 0: that row {float(out[0].float().abs().max())} (want 0),"
          f" the others {err:.3e} from the plain version")
    print(f"  flash_decode check slot of length 0: zeros; others max_abs_err {err:.3e}", flush=True)
    # a cache the 16-byte loads cannot read is refused, not copied
    buf = torch.zeros(2 * 64 * 128 + 4, dtype=bf16, device="cuda")[4:].view(1, 2, 64, 128)
    try:
        fa.flash_decode(q[:1, :4], buf, buf, length=length[:1])
        refused = False
    except ValueError:
        refused = True
    check(refused, "K3 took a cache whose base is not 16-byte aligned")


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
    16, a 513-row pool, lengths 37..1000, bf16), GQA, windowed, gpt-j-6b's
    (H = Hk = 16, D 256), small fp32 and bf16 checks and page sizes 4 and 8
    over several chunks, each timed row with its device time
    (``device_ms``) beside the replaced kernel's recorded time; library:
    the pages gathered by ``index_select`` and SDPA masked to the live keys
    (the window's, where there is one); then the
    split's own checks: rows at B 1 bitwise equal to the same rows at B 8,
    a slot of length 0 (zeros), table columns past ceil(length / ps) full
    of page ids out of any pool (never read), and the engine's int64
    lengths (``pos + 1``) and an int64 table read as they lie."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    engine_lens = [37, 1000, 513, 260, 777, 129, 400, 64]
    cases = [  # label, B, H, Hk, D, page, max pages, pool pages, lengths, window, dtype, weight, timed
        ("main B8 H40 D128 ps16 len37..1000", 8, 40, 40, 128, 16, 64, 512, engine_lens, None, bf16, 1, True),
        ("gqa B8 H32 Hk8 D128 ps16", 8, 32, 8, 128, 16, 64, 512, engine_lens, None, bf16, 0, True),
        ("window128 B8 H40 D128 ps16", 8, 40, 40, 128, 16, 64, 512, engine_lens, 128, bf16, 0, True),
        ("check H4 Hk2 D16 ps4 window5 fp32", 3, 4, 2, 16, 4, 8, 20, [13, 32, 3], 5, f32, 0, False),
        ("check H16 Hk1 D128 ps16 fp32", 2, 16, 1, 128, 16, 8, 20, [100, 61], None, f32, 0, False),
        ("check H8 Hk2 D64 ps8 len1", 2, 8, 2, 64, 8, 8, 20, [50, 1], None, bf16, 0, False),
        # gpt-j-6b's engine shape: H = Hk = 16, D 256
        ("gptj B8 H16 D256 ps16 len37..1000", 8, 16, 16, 256, 16, 64, 512, engine_lens, None, bf16, 0, True),
        ("check H4 Hk2 D256 ps4 window5 fp32", 3, 4, 2, 256, 4, 8, 20, [13, 32, 3], 5, f32, 0, False),
        ("check H16 D256 ps16 window100", 3, 16, 16, 256, 16, 8, 20, [100, 61, 1], 100, bf16, 0, False),
        # small pages over several chunks, window edges inside chunks
        ("check ps4 H40 Hk8 D128 len1..300 window100", 4, 40, 8, 128, 4, 80, 300,
         [300, 1, 129, 64], 100, bf16, 0, False),
        ("check ps8 H8 Hk8 D64 fp32 len3..200", 3, 8, 8, 64, 8, 32, 80, [200, 65, 3], None, f32, 0,
         False),
    ]
    bitwise = []
    for label, b, h, hk, d, ps, maxp, npages, lens, window, dt, weight, timed in cases:
        q = torch.randn(b, h, d, generator=gen, device="cuda").to(dt)
        kp = torch.randn(npages + 1, ps, hk, d, generator=gen, device="cuda").to(dt)
        vp = torch.randn(npages + 1, ps, hk, d, generator=gen, device="cuda").to(dt)
        table = _page_table(torch, lens, ps, maxp, npages, seed=b + h)
        length = torch.tensor(lens, dtype=torch.int32, device="cuda")
        valid = sum(min(n, window) if window else n for n in lens)
        library = None
        if timed:     # the pages gathered, SDPA masked to the live keys (the window's)
            pos = torch.arange(maxp * ps, device="cuda")[None, :]
            keep = pos < length[:, None]
            if window is not None:
                keep = keep & (pos >= length[:, None] - window)
            keep = keep[:, None, None, :]
            flat = table.flatten()

            def library():
                kd = kp.index_select(0, flat).view(b, maxp * ps, hk, d).transpose(1, 2)
                vd = vp.index_select(0, flat).view(b, maxp * ps, hk, d).transpose(1, 2)
                return F.scaled_dot_product_attention(q[:, :, None], kd, vd, attn_mask=keep,
                                                      enable_gqa=hk != h)
        name = "bfloat16" if dt == bf16 else "float32"
        pages_read = sum(-(-n // ps) for n in lens)

        def fn():
            return fa.paged_decode(q, kp, vp, table, page_size=ps, length=length, window=window)

        out = bench.run("paged_decode", label, fn,
                        lambda: ref.paged_decode_attention_ref(q, kp, vp, table, page_size=ps,
                                                               length=length, window=window),
                        library,
                        flops=4 * h * d * valid,
                        nbytes=q.element_size() * (2 * b * h * d + 2 * hk * d * valid)
                        + 4 * (pages_read + b),
                        dtype=name, tol_kind="attn", weight=weight, timed=timed)
        if timed:
            device_row(torch, bench, "paged_decode", fn)
        if label.startswith(("main", "check ps4")):
            bitwise.append((label, q, kp, vp, table, length, ps, window, out))
    print(f"  paged_decode plan at the main row: {fa.paged_decode_plan(*bitwise[0][1:5], page_size=16)}",
          flush=True)
    # a slot's bits do not depend on the batch it is decoded in
    for label, q, kp, vp, table, length, ps, window, out in bitwise:
        for i in range(q.shape[0]):
            one = fa.paged_decode(q[i:i + 1], kp, vp, table[i:i + 1], page_size=ps,
                                  length=length[i:i + 1], window=window)
            check(torch.equal(one, out[i:i + 1]),
                  f"K4 {label}: slot {i} decoded at B 1 differs from the same slot at B {q.shape[0]}")
    print(f"  paged_decode rows at B 1 bitwise equal to B 8 and B 4: {len(bitwise)} cases", flush=True)
    # a slot of length 0 gives zeros; columns past a slot's pages hold ids out
    # of any pool and are never read; int64 lengths and table read in place
    label, q, kp, vp, table, length, ps, window, out = bitwise[0]
    lens = [0, 1000, 1, 64, 17, 513, 16, 999]
    length = torch.tensor(lens, dtype=torch.int64, device="cuda")
    wild = table.clone()
    for i, n in enumerate(lens):
        wild[i, -(-n // ps):] = 1 << 30
    got = fa.paged_decode(q, kp, vp, wild, page_size=ps, length=length)
    got64 = fa.paged_decode(q, kp, vp, wild.long(), page_size=ps, length=length)
    want = ref.paged_decode_attention_ref(q[1:], kp, vp, table[1:], page_size=ps,
                                          length=length[1:])
    err, ok = compare(torch, got[1:], want, *TOL["bfloat16"]["attn"])
    zero = float(got[0].float().abs().max())
    check(zero == 0.0 and ok and torch.equal(got, got64),
          f"K4 with a slot of length 0 ({zero}, want 0), out-of-pool ids past each slot's pages"
          f" and int64 lengths: {err:.3e} from the plain version; int64 table equal:"
          f" {torch.equal(got, got64)}")
    print(f"  paged_decode check slot of length 0: zeros; out-of-pool ids past the pages never"
          f" read, int64 lengths and table: max_abs_err {err:.3e}", flush=True)
    # pools the 16-byte loads cannot read are refused, not copied
    buf = torch.zeros(kp.numel() + 4, dtype=bf16, device="cuda")[4:].view(kp.shape)
    try:
        fa.paged_decode(q, buf, buf, table, page_size=ps, length=length)
        refused = False
    except ValueError:
        refused = True
    check(refused, "K4 took pools whose base is not 16-byte aligned")


def sm_clock_ghz():
    """The card's maximum SM clock (``nvidia-smi --query-gpu=clocks.max.sm``)
    in GHz."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(smi.stdout.split()[0]) / 1e3


def mamba_scan_cases(torch, bench, ref, scan):
    """K8 at falcon-mamba-7b's shapes (D 8192, N 16): the prefill (B 4,
    L 512, bf16, B and C strided column slices of the x projection as on
    the path, no state) and the engine's decode step (B 8, L 1, from a
    state), plus generate_loop's decode (B 4), the batch-1 prefill, a
    ragged fp32 L 100 from a state, contiguous B and C, N 8, and a channel
    count that is not a multiple of a block's; two checks write the state
    in place over h0, as the layer does into its cache.  Each case runs on
    the kernel its ``scan_plan`` names (printed with its lanes and waves),
    each timed row with its device time.  Operations count 6 N + 3 per
    channel-step (an exponential as one) at the fp32 peak; bytes count x,
    dt, B, C, A, D and the state read once, y and the new state written
    once; beside them the special-function floor, B·L·D·N exponentials at
    132 SMs x 16 a clock of the card's maximum SM clock.  Then each row of
    the B 4 prefill and of the B 8 decode is held bitwise equal to the same
    row decoded at B 1."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    ghz = sm_clock_ghz()
    # label, B, L, D, N, dtype, with h0, strided B/C, weight, timed, state in place
    cases = [
        ("prefill B4 L512 D8192 N16 strided B/C", 4, 512, 8192, 16, torch.bfloat16, False, True, 1, True, False),
        ("engine decode B8 L1 D8192 N16 h0", 8, 1, 8192, 16, torch.bfloat16, True, True, 1, True, False),
        ("decode B4 L1 D8192 N16 h0", 4, 1, 8192, 16, torch.bfloat16, True, True, 0, True, False),
        ("batch-1 prefill L512 D8192 N16", 1, 512, 8192, 16, torch.bfloat16, False, True, 0, True, False),
        ("check ragged L100 D8192 N16 h0 fp32", 2, 100, 8192, 16, torch.float32, True, True, 0, False, False),
        ("check L77 D256 N16 contiguous B/C bf16", 2, 77, 256, 16, torch.bfloat16, True, False, 0, False, False),
        ("check L40 D128 N8 h0 fp32", 2, 40, 128, 8, torch.float32, True, True, 0, False, False),
        ("check L65 D100 N16 h0 fp32", 3, 65, 100, 16, torch.float32, True, False, 0, False, False),
        ("check decode B8 L1 D8192 N16 state in place", 8, 1, 8192, 16, torch.bfloat16, True, True, 0, False, True),
        ("check L100 D8192 N16 fp32 state in place", 2, 100, 8192, 16, torch.float32, True, True, 0, False, True),
    ]

    def in_place(x, dtv, a, bi, ci, dsk, h0):
        h = h0.clone()
        y, h_fin = scan.mamba_scan(x, dtv, a, bi, ci, dsk, h0=h, h_out=h)
        check(h_fin.data_ptr() == h.data_ptr(), "mamba_scan h_out: state not written in place")
        return y, h

    rows = {}
    for label, b, l, d, n, dt, with_h0, strided, weight, timed, inplace in cases:
        x = torch.randn(b, l, d, generator=gen, device="cuda").to(dt)
        # softplus of the path's dt_raw (bias -2): about 0.01 to 1
        dtv = (torch.rand(b, l, d, generator=gen, device="cuda") * 0.9 + 0.01).to(dt)
        a = -torch.arange(1, n + 1, dtype=torch.float32, device="cuda").expand(d, n).contiguous()
        a = a * (0.5 + torch.rand(d, 1, generator=gen, device="cuda"))
        if strided:   # (B·L, dt_rank + 2N) projection, B and C its column slices
            proj = torch.randn(b, l, 256 + 2 * n, generator=gen, device="cuda").to(dt)
            bi, ci = proj[..., 256:256 + n], proj[..., 256 + n:]
        else:
            bi = torch.randn(b, l, n, generator=gen, device="cuda").to(dt)
            ci = torch.randn(b, l, n, generator=gen, device="cuda").to(dt)
        dsk = torch.randn(d, generator=gen, device="cuda")
        h0 = torch.randn(b, d, n, generator=gen, device="cuda") if with_h0 else None
        esize = x.element_size()
        nbytes = (esize * (3 * b * l * d + 2 * b * l * n) + 4 * (d * n + d)
                  + 4 * b * d * n * (2 if with_h0 else 1))
        name = "bfloat16" if dt == torch.bfloat16 else "float32"
        plan = scan.scan_plan(b, l, d, n, dt)
        fn = ((lambda: in_place(x, dtv, a, bi, ci, dsk, h0)) if inplace else
              (lambda: scan.mamba_scan(x, dtv, a, bi, ci, dsk, h0=h0)))
        before = (scan.SCAN_PREFILL_LAUNCHES, scan.SCAN_DECODE_LAUNCHES)
        got = bench.run("mamba_scan", label, fn,
                        lambda: ref.mamba_scan_ref(x, dtv, a, bi, ci, dsk, h0=h0),
                        None, flops=b * l * d * (6 * n + 3), nbytes=nbytes, dtype=name,
                        tol_kind="scan", weight=weight, timed=timed, peak="fp32")
        ran = (scan.SCAN_PREFILL_LAUNCHES - before[0], scan.SCAN_DECODE_LAUNCHES - before[1])
        check((ran[0] > 0) == (plan.variant == "prefill") and (ran[1] > 0) == (plan.variant == "decode"),
              f"K8 {label}: plan {plan.variant}, launches (prefill, decode) {ran}")
        row = bench.cases["mamba_scan"][-1]
        row["plan"] = plan._asdict()
        row["sfu_floor_ms"] = b * l * d * n / (132 * 16 * ghz * 1e9) * 1e3
        print(f"    plan {plan.variant}, {plan.lanes} lanes a channel, grid {plan.grid}, smem"
              f" {plan.smem_bytes} bytes, {plan.blocks_per_sm} blocks an SM, {plan.waves}"
              f" wave(s); special-function floor {row['sfu_floor_ms']:.4f} ms at {ghz:.3f} GHz",
              flush=True)
        if timed:
            device_row(torch, bench, "mamba_scan", fn)
        if label.startswith(("prefill B4", "engine decode")):
            rows[label] = (x, dtv, a, bi, ci, dsk, h0, got)
    # a row's bits do not depend on the batch (B 1's prefill plan spreads a
    # channel over more lanes; the sum's tree does not change)
    for label, (x, dtv, a, bi, ci, dsk, h0, (y, h)) in rows.items():
        b, l, d = x.shape
        for i in range(b):
            y1, h1 = scan.mamba_scan(x[i:i + 1], dtv[i:i + 1], a, bi[i:i + 1], ci[i:i + 1], dsk,
                                     h0=None if h0 is None else h0[i:i + 1])
            check(torch.equal(y1, y[i:i + 1]) and torch.equal(h1, h[i:i + 1]),
                  f"K8 {label}: row {i} at B 1 ({scan.scan_plan(1, l, d, 16, x.dtype).lanes}"
                  f" lanes) differs from the same row at B {b}"
                  f" ({scan.scan_plan(b, l, d, 16, x.dtype).lanes} lanes)")
    print(f"  mamba_scan rows at B 1 bitwise equal to B 4 (prefill) and B 8 (decode), y and"
          f" state: {len(rows)} cases", flush=True)


def block_prune(w, sparsity, bs=8):
    """Magnitude-based block pruning (the paper's block-wise weight pruning),
    ``examples/sparse_inference.py``'s helper: zero the ``sparsity`` share
    of (bs, bs) blocks of ``w`` with the smallest summed magnitudes."""
    import numpy as np
    m, n = w.shape
    tiles = w.reshape(m // bs, bs, n // bs, bs).transpose(0, 2, 1, 3)
    scores = np.abs(tiles).sum((2, 3))
    k = int(scores.size * sparsity)
    thresh = np.partition(scores.ravel(), k)[k] if k else -np.inf
    tiles = tiles.copy()
    tiles[scores < thresh] = 0
    return tiles.transpose(0, 2, 1, 3).reshape(m, n)


def random_block_sparse(rng, m, k, bs, sparsity):
    """An (m, k) fp32 numpy matrix whose (bs, bs) blocks are each zeroed with
    probability ``sparsity`` (``benchmarks/bench_spmm.py``'s pattern)."""
    import numpy as np
    dense = rng.normal(size=(m, k)).astype(np.float32)
    dense.reshape(m // bs, bs, k // bs, bs).transpose(0, 2, 1, 3)[
        rng.random((m // bs, k // bs)) < sparsity] = 0
    return dense


def bert_ffn_weights(seed=0):
    """bert-large's two FFN weights in (out, in) layout, N(0, 1/in), fp32
    numpy: W_up (4096, 1024) and W_down (1024, 4096)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    d, ff = 1024, 4096
    return (rng.normal(size=(ff, d)).astype(np.float32) / math.sqrt(d),
            rng.normal(size=(d, ff)).astype(np.float32) / math.sqrt(ff))


def block_spmm_cases(torch, bench, ref, spmm, brgemm):
    """K10 against its plain version: the Fig. 8 sweep of
    ``benchmarks/bench_spmm.py`` at the card's size (M = K = N = 4096, 16x16
    blocks, sparsity 0, 0.5, 0.7, 0.9, bf16 and fp32; library: cuBLAS on the
    dense pruned matrix; K1 on the same dense matrix beside it), 8x8 blocks
    at 80 %, bert-large's two 80 % sparse FFN products on 4096 tokens with
    B a transposed view (phase 7c's calls: K10's row), and small checks (an
    empty 64-row block row without padding, ragged N, both layouts of B on
    each variant, all-zero work lists, fp32 out).  A matrix pruned in bs x
    bs blocks runs in bf16 as its 64-row work list (``densify_to_bcsr(a, 64,
    bs)``, wgmma where TMA reads B), beside the WMMA kernel it replaced on
    the bs x bs list; in fp32 as the bs x bs list (SIMT).  Every bound counts
    the pruned blocks, not the 64-row blocks' zeros."""
    import numpy as np
    rng = np.random.default_rng(12)
    gen = torch.Generator(device="cuda").manual_seed(12)
    bf16, f32 = torch.bfloat16, torch.float32
    rows64 = spmm.WGMMA_ROWS

    def run(label, a, bs, b, dense=None, weight=0, timed=True, out_dtype=None, pad=True):
        name = "bfloat16" if b.dtype == bf16 else "float32"
        out = out_dtype or b.dtype
        fine = spmm.densify_to_bcsr(a, bs, bs, pad_empty_rows=pad)
        work = spmm.densify_to_bcsr(a, rows64, bs, pad_empty_rows=pad) if b.dtype == bf16 else fine
        blocks, rid, cid = work[0].to(b.dtype), work[1], work[2]
        nrows = a.shape[0] // blocks.shape[1]
        items = int((fine[0].abs().sum((1, 2)) != 0).sum())
        flops = 2 * items * bs * bs * b.shape[1]
        nbytes = (items * bs * bs * b.element_size() + 8 * items + b.numel() * b.element_size()
                  + a.shape[0] * b.shape[1] * out.itemsize)
        before = {v: getattr(spmm, c) for v, c in spmm.SPMM_COUNTERS.items()}
        spmm.block_spmm(blocks, rid, cid, b, nrows_b=nrows, out_dtype=out_dtype)
        variant = next(v for v, c in spmm.SPMM_COUNTERS.items() if getattr(spmm, c) > before[v])
        bench.run("block_spmm", f"{label} [{variant}]",
                  lambda: spmm.block_spmm(blocks, rid, cid, b, nrows_b=nrows, out_dtype=out_dtype),
                  lambda: ref.block_spmm_ref(blocks, rid, cid, b, nrows_b=nrows, out_dtype=out_dtype),
                  (lambda: torch.matmul(dense, b)) if dense is not None else None,
                  flops=flops, nbytes=nbytes, dtype=name, tol_kind="gemm", weight=weight,
                  timed=timed)
        row = bench.cases["block_spmm"][-1]
        row["blocks"] = f"{blocks.shape[0]} of {blocks.shape[1]}x{bs} ({items} of {bs}x{bs})"
        fn = lambda: spmm.block_spmm(blocks, rid, cid, b, nrows_b=nrows,  # noqa: E731
                                     out_dtype=out_dtype)
        if variant == "wgmma":
            # the WMMA kernel it replaced, on the bs x bs work list
            fb, fr, fc = fine[0].to(b.dtype), fine[1], fine[2]
            was = lambda: spmm.block_spmm(fb, fr, fc, b, nrows_b=a.shape[0] // bs,  # noqa: E731
                                          out_dtype=out_dtype)
            before = spmm.SPMM_WMMA_LAUNCHES
            err, ok = compare(torch, was(), fn(), *TOL["bfloat16"]["gemm"])
            check(ok and spmm.SPMM_WMMA_LAUNCHES == before + 1,
                  f"K10 {label}: the wmma variant on the {bs}x{bs} list differs from wgmma by"
                  f" {err:.3e} (or did not run on wmma)")
            if timed:
                row["wmma_ms"] = time_ms(torch, was)
                print(f"    beside: the wmma variant it replaced ({bs}x{bs} blocks)"
                      f" {row['wmma_ms']:.4f} ms", flush=True)
        return row, fn

    m = k = n = 4096
    b32 = torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)
    sweep = []
    for sparsity in (0.0, 0.5, 0.7, 0.9):
        dense_np = random_block_sparse(rng, m, k, 16, sparsity)
        dense32 = torch.from_numpy(dense_np).cuda()
        for dt in (bf16, f32):
            b, dense = b32.to(dt), dense32.to(dt)
            row, _ = run(f"fig8 4096^3 16x16 sparsity {sparsity} {str(dt)[6:]}", dense_np, 16, b,
                         dense)
            entry = {"sparsity": sparsity, "dtype": str(dt)[6:], "blocks": row["blocks"],
                     "k10_ms": row["ms"], "k10_wmma_ms": row.get("wmma_ms"),
                     "cublas_dense_ms": row["library_ms"], "bound_ms": row["bound_ms"]}
            # the port's own dense GEMM on the same (pruned) matrix
            entry["k1_dense_ms"] = time_ms(torch, lambda: brgemm.matmul(dense, b))
            sweep.append(entry)
            del dense
        del dense32
    for dt in ("bfloat16", "float32"):
        rows = [e for e in sweep if e["dtype"] == dt]
        base = rows[0]["k10_ms"]
        for e in rows:
            e["speedup_vs_k10_at_0"] = base / e["k10_ms"]
        print(f"  Fig. 8 sweep {dt}: " + "; ".join(
            f"{e['sparsity']:.0%} K10 {e['k10_ms']:.4f} ms"
            + (f" (wmma {e['k10_wmma_ms']:.4f})" if e["k10_wmma_ms"] is not None else "")
            + f" ({e['speedup_vs_k10_at_0']:.2f}x of 0 %,"
            f" bound {e['bound_ms']:.4f}), K1 dense {e['k1_dense_ms']:.4f},"
            f" cuBLAS dense {e['cublas_dense_ms']:.4f}" for e in rows), flush=True)
    bench.extra["fig8_sweep"] = sweep

    dense_np = random_block_sparse(rng, m, k, 8, 0.8)
    dense = torch.from_numpy(dense_np).cuda().to(bf16)
    run("4096^3 8x8 sparsity 0.8 bfloat16", dense_np, 8, b32.to(bf16), dense)
    del dense, b32

    # phase 7c's two calls: the pruned weight (out, in) times x^T, read in place
    w_up, w_down = bert_ffn_weights()
    t = 4096
    for name, w in (("W_up 4096x1024", w_up), ("W_down 1024x4096", w_down)):
        w_sp = block_prune(w, 0.8)
        x = torch.randn(t, w.shape[1], generator=gen, device="cuda").to(bf16)
        dense = torch.from_numpy(w_sp).cuda().to(bf16)
        row, fn = run(f"bert {name} 80 % 8x8 @ x^T (T {t})", w_sp, 8, x.T, dense, weight=1)
        row["device_ms"] = device_ms(torch, fn)
        print(f"    device {row['device_ms']:.4f} ms", flush=True)
    del x, dense

    # checks: an empty 64-row block row (without a padding block where pad
    # is off), ragged N, both layouts of B on each variant (wgmma where TMA
    # reads B: its stored rows a multiple of 16 bytes; wmma else; simt in
    # fp32), odd item counts, fp32 out
    for bs, mm, kk, nn, dt, trans, pad, out in (
            (8, 128, 96, 300, f32, False, False, None), (8, 128, 96, 300, bf16, True, False, None),
            (16, 192, 64, 200, bf16, True, True, f32), (16, 128, 64, 129, bf16, False, False, None),
            (16, 128, 48, 77, f32, True, False, None), (8, 128, 72, 136, bf16, False, True, None),
            (8, 192, 200, 200, bf16, False, False, None), (16, 128, 96, 64, bf16, True, False, f32),
            (16, 128, 128, 264, bf16, False, True, None), (8, 128, 40, 1000, bf16, True, True, None),
            (8, 128, 64, 99, bf16, True, False, None)):
        a = random_block_sparse(rng, mm, kk, bs, 0.5)
        a[rows64:2 * rows64] = 0   # 64-row block row 1 is empty
        bmat = (torch.randn(nn, kk, generator=gen, device="cuda").T if trans else
                torch.randn(kk, nn, generator=gen, device="cuda")).to(dt)
        _, fn = run(f"check {bs}x{bs} {mm}x{kk} N {nn} {'B^T ' if trans else ''}{str(dt)[6:]}"
                    f"{' no pad' if not pad else ''}{' fp32 out' if out else ''}",
                    a, bs, bmat, timed=False, out_dtype=out, pad=pad)
        check(float(fn()[rows64:2 * rows64].abs().max()) == 0.0,
              "K10: the empty block row is not zero")
    # an all-zero matrix without padding: no items, on wmma (bf16) and simt
    for dt in (bf16, f32):
        a = np.zeros((128, 64), np.float32)
        blocks, rid, cid = spmm.densify_to_bcsr(a, rows64, 8, pad_empty_rows=False)
        bmat = torch.randn(64, 256, generator=gen, device="cuda").to(dt)
        before = spmm.SPMM_LAUNCHES
        got = spmm.block_spmm(blocks.to(dt), rid, cid, bmat, nrows_b=2)
        check(spmm.SPMM_LAUNCHES == before + 1 and float(got.abs().max()) == 0.0,
              f"K10: an empty {str(dt)[6:]} work list did not launch or is not zero")


def grouped_matmul_cases(torch, bench, ref, spmm):
    """K9 against its plain version at qwen3-moe's expert widths
    (``src/repro/configs/qwen3_moe_235b.py``: d 4096, moe_d_ff 1536, 128
    experts): 4096 rows in 64-row tiles with sorted group ids drawn from the
    seed, bf16, on the variant ``grouped_plan`` names (wgmma), with its
    device time and the replaced kernel's recorded time (``WAS_MS``) printed
    beside it; library:
    ``torch._grouped_mm`` where the card's torch has it; plus checks, each
    on the variant its plan names: rows 8 and 100 a tile, f not a multiple
    of the wgmma tile, a ragged d, fp32 output and bf16 output of fp32
    operands, out-of-range ids clamped, f not a multiple of 8 (wmma) and
    fp32 (simt).  The plain version takes the clamped ids."""
    import numpy as np
    rng = np.random.default_rng(13)
    gen = torch.Generator(device="cuda").manual_seed(13)
    bf16, f32 = torch.bfloat16, torch.float32

    def operands(t, d, f, e, bm, dt):
        x = torch.randn(t, d, generator=gen, device="cuda").to(dt)
        w = (torch.randn(e, d, f, generator=gen, device="cuda") / math.sqrt(d)).to(dt)
        gid = torch.from_numpy(np.sort(rng.integers(0, e, t // bm)).astype(np.int32)).cuda()
        return x, w, gid

    def run(label, x, gid, w, out=None, library=None, flops=0, nbytes=0, weight=0, timed=False):
        e, tiles = w.shape[0], gid.shape[0]
        plan = spmm.grouped_plan(tiles, x.shape[0] // tiles, x.shape[1], w.shape[2], e, x.dtype)
        before = {v: getattr(spmm, c) for v, c in spmm.GROUPED_COUNTERS.items()}
        spmm.grouped_matmul(x, gid, w, out_dtype=out)
        ran = [v for v, c in spmm.GROUPED_COUNTERS.items() if getattr(spmm, c) > before[v]]
        check(ran == [plan.variant], f"K9 {label}: ran on {ran}, its plan names {plan.variant}")
        fn = lambda: spmm.grouped_matmul(x, gid, w, out_dtype=out)  # noqa: E731
        name = "bfloat16" if x.dtype == bf16 else "float32"
        bench.run("grouped_matmul", f"{label} [{plan.variant}]", fn,
                  lambda: ref.grouped_matmul_ref(x, gid.clamp(0, e - 1), w, out_dtype=out),
                  library, flops=flops, nbytes=nbytes, dtype=name, tol_kind="gemm",
                  weight=weight, timed=timed)
        return bench.cases["grouped_matmul"][-1], fn

    t, d, f, e, bm = 4096, 4096, 1536, 128, 64
    x, w, gid = operands(t, d, f, e, bm, bf16)
    used = int(torch.unique(gid).numel())
    library, why = None, None
    if not hasattr(torch, "_grouped_mm"):
        why = f"torch {torch.__version__} has no torch._grouped_mm"
    else:
        # rows of each expert, in order: offsets are the running row counts
        offs = (torch.bincount(gid.long(), minlength=e) * bm).cumsum(0).to(torch.int32)
        wt = w.transpose(-2, -1).contiguous().transpose(-2, -1)    # column-major slabs
        try:
            lib_out = torch._grouped_mm(x, wt, offs=offs)
            err, ok = compare(torch, lib_out, ref.grouped_matmul_ref(x, gid, w), 1e-2, 1e-2)
            if ok:
                library = lambda: torch._grouped_mm(x, wt, offs=offs)
            else:
                why = f"torch._grouped_mm disagrees with the plain version by {err:.3e}"
        except (RuntimeError, TypeError, ValueError) as exc:   # the yardstick only
            why = f"torch._grouped_mm refused these operands: {str(exc).splitlines()[0][:160]}"
    row, fn = run(f"qwen3-moe T{t} tiles of {bm} d{d} f{f} E{e} ({used} used)", x, gid, w,
                  library=library, flops=2 * t * d * f,
                  nbytes=2 * (t * d + used * d * f + t * f) + 4 * (t // bm), weight=1, timed=True)
    row["device_ms"] = device_ms(torch, fn)
    print(f"    device {row['device_ms']:.4f} ms; was {WAS_MS['qwen3-moe']:.4f} ms (the wmma"
          f" variant it replaced, a lone call, PERF.md)", flush=True)
    bench.extra["grouped_matmul_library"] = why or "torch._grouped_mm"
    if why:
        print(f"  grouped_matmul library: none, {why}", flush=True)
    del x, w, gid
    for t, d, f, e, bm, dt, out in ((192, 96, 200, 5, 48, f32, None), (64, 32, 64, 4, 8, bf16, None),
                                    (300, 64, 136, 3, 100, bf16, None), (256, 72, 128, 6, 64, f32, bf16),
                                    (128, 64, 96, 4, 64, bf16, f32), (800, 256, 384, 6, 100, bf16, None),
                                    (48, 128, 256, 3, 8, bf16, f32), (384, 136, 200, 5, 64, bf16, None),
                                    (192, 64, 100, 3, 64, bf16, None)):
        x, w, gid = operands(t, d, f, e, bm, dt)
        name = "bfloat16" if dt == bf16 else "float32"
        run(f"check T{t} tiles of {bm} d{d} f{f} E{e} {name}" + (f" -> {str(out)[6:]}" if out else ""),
            x, gid, w, out)
    # ids out of range are clamped into [0, E)
    x, w, _ = operands(256, 128, 256, 4, 64, bf16)
    gid = torch.tensor([-3, 0, 4, 100], dtype=torch.int32, device="cuda")
    run("check T256 tiles of 64 d128 f256 E4 ids -3, 0, 4, 100 clamped", x, gid, w)


def fused_output_cases(torch, bench, fo, fusion):
    """K7 (Listing 6) against its plain version at bert-large's two output
    layers (M 4096 tokens, N 1024: Bert-Output K 4096 and Bert-SelfOutput K
    1024; bf16, dropout 0.1 by a seeded keep mask: K7's row), N 5120 (the
    panel in device memory) and fp32, each beside K5's ``fused_output_apply``
    keep-mask graph on the same inputs; plus ragged, no-dropout and fp32-out
    checks on both panel placements."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    bf16, f32 = torch.bfloat16, torch.float32
    k5_ms = {}
    for label, m, k, n, dt, rate, out, weight, timed in (
            ("Bert-Output M4096 K4096 N1024", 4096, 4096, 1024, bf16, 0.1, None, 1, True),
            ("Bert-SelfOutput M4096 K1024 N1024", 4096, 1024, 1024, bf16, 0.1, None, 1, True),
            ("M4096 K1024 N5120", 4096, 1024, 5120, bf16, 0.1, None, 0, True),
            ("fp32 M4096 K1024 N1024", 4096, 1024, 1024, f32, 0.1, None, 0, True),
            ("check fp32 M77 K50 N130", 77, 50, 130, f32, 0.3, None, 0, False),
            ("check fp32 M70 K64 N2000 (device panel)", 70, 64, 2000, f32, 0.2, None, 0, False),
            ("check bf16 M33 K72 N1700 (device panel)", 33, 72, 1700, bf16, 0.5, None, 0, False),
            ("check bf16 M40 K96 N256 no dropout", 40, 96, 256, bf16, 0.0, None, 0, False),
            ("check bf16 M64 K128 N384 fp32 out", 64, 128, 384, bf16, 0.1, f32, 0, False)):
        x = torch.randn(m, k, generator=gen, device="cuda").to(dt)
        w = (torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)).to(dt)
        res = torch.randn(m, n, generator=gen, device="cuda").to(dt)
        bias, gamma, beta = (torch.randn(n, generator=gen, device="cuda") for _ in range(3))
        keep = torch.rand(m, n, generator=gen, device="cuda") > rate
        args = (x, w, bias, res, gamma, beta)
        name = "bfloat16" if (out or dt) == bf16 else "float32"
        got = bench.run("fused_output", label,
                        lambda: fo.fused_output(*args, keep_mask=keep, dropout_rate=rate, out_dtype=out),
                        lambda: fo.fused_output_ref(*args, keep_mask=keep, dropout_rate=rate,
                                                    out_dtype=out),
                        None, flops=2 * m * n * k,
                        nbytes=_nbytes(x, w, res, keep) + m * n * (out or dt).itemsize + 12 * n,
                        dtype=name, tol_kind="gemm", weight=weight, timed=timed)
        if timed:     # the same layer as K5's keep-mask graph (fusion.library.fused_output_apply)
            with torch.no_grad():
                k5 = lambda: fusion.library.fused_output_apply(*args, keep_mask=keep, dropout_rate=rate)
                err, ok = compare(torch, k5(), got, *TOL[name]["gemm"])
                check(ok, f"K5's fused_output_apply and K7 disagree at {label}: {err:.3e}")
                k5_ms[label] = time_ms(torch, k5)
            print(f"    K5 fused_output_apply (keep mask) at {label}: {k5_ms[label]:.4f} ms"
                  f" (K7 {bench.cases['fused_output'][-1]['ms']:.4f}); |K5 - K7| {err:.3e}", flush=True)
    bench.extra["fused_output_k5_ms"] = k5_ms


# benchmarks/bench_gemm.py's shapes (M, K, N): paper Fig. 2 (square,
# skewed) and Fig. 5 (BERT-ish, GPT/Llama-ish)
GEMM_SHAPES = ((1024, 1024, 1024), (2048, 2048, 2048), (4096, 4096, 4096), (256, 1024, 4096),
               (1024, 4096, 1024), (2048, 5120, 5120), (4096, 4096, 11008))


def spec_strings(kb_outer):
    """The spec strings phase 3 runs K11 and K1 under, with their block
    steps: output-stationary, N outer, both output loops PARALLEL, M blocked
    by 4, and K blocked by ``kb_outer`` blocks (a multiple of the visit that
    divides K's block count)."""
    return (("bca", None), ("cba", None), ("BCa", None), ("bcba", {"b": (4,)}),
            ("bcaa", {"a": (kb_outer,)}))


def brgemm_blocked_cases(torch, bench, ref, brgemm):
    """K11 (Listing 1) at bench_gemm.py's seven shapes in bf16 64x64x64
    blocks, k_step 4, under every spec string of ``spec_strings``: each
    output bitwise equal to "bca"'s and within tolerance of
    ``brgemm_blocked_ref``; "bca" is K11's row, timed beside the plain
    version, ``torch.matmul`` on the flat matrices (the library) and K1 on
    the same flat product, every launch on the wgmma variant (two blocks of
    a block row a CTA where the table lists them together,
    ``brgemm.blocked_pairs``; one block a CTA timed beside it, bitwise
    equal); every spec's time kept, and at 2048^3 the WMMA variant it
    replaced timed on the same blocks ("was").  Then fp32 (the SIMT variant) at 1024^3, and the
    test shapes (8x16 and 4x8 A blocks, fp32 and bf16 in SIMT; 16x16 and
    32x16 in WMMA, one with an fp32 output; 64- and 128-row blocks with bk
    16 to 128 and bn 48 to 256 on wgmma, one with an fp32 output), each
    checking that its variant launched."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    bf16, f32 = torch.bfloat16, torch.float32
    blk, k_step = 64, 4
    by_spec, k1_ms = {}, {}
    for m, k, n in GEMM_SHAPES:
        mb, kb, nb = m // blk, k // blk, n // blk
        a = torch.randn(mb, kb, blk, blk, generator=gen, device="cuda").to(bf16)
        b = (torch.randn(nb, kb, blk, blk, generator=gen, device="cuda") / math.sqrt(k)).to(bf16)
        flat_a = a.permute(0, 2, 1, 3).reshape(m, k)
        flat_b = b.permute(1, 2, 0, 3).reshape(k, n)
        shape = f"{m}x{k}x{n}"
        flops, nbytes = 2 * m * n * k, 2 * (m * k + k * n + m * n)
        kb_outer = 16 if kb % 16 == 0 else kb
        base, times = None, {}
        before = (brgemm.BLOCKED_WGMMA_LAUNCHES, brgemm.BLOCKED_WMMA_LAUNCHES,
                  brgemm.BLOCKED_SIMT_LAUNCHES)
        for spec, steps in spec_strings(kb_outer):
            run = lambda: brgemm.brgemm_blocked(a, b, spec_string=spec, k_step=k_step,
                                                block_steps=steps)
            got = bench.run("brgemm_blocked", f"{shape} bf16 64^3 k_step 4 {spec} {steps or ''}",
                            run, lambda: ref.brgemm_blocked_ref(a, b),
                            (lambda: torch.matmul(flat_a, flat_b)) if base is None else None,
                            flops=flops, nbytes=nbytes, dtype="bfloat16", tol_kind="gemm",
                            weight=int(base is None), timed=base is None)
            if base is None:
                base, times[spec] = got, bench.cases["brgemm_blocked"][-1]["ms"]
            else:
                check(torch.equal(got, base), f"K11 {shape}: {spec} {steps} differs from 'bca'")
                times[f"{spec} {steps or ''}".strip()] = time_ms(torch, run, reps=5)
        check(brgemm.BLOCKED_WGMMA_LAUNCHES > before[0]
              and (brgemm.BLOCKED_WMMA_LAUNCHES, brgemm.BLOCKED_SIMT_LAUNCHES) == before[1:],
              f"K11 {shape}: not every launch ran on the wgmma variant")
        alone = lambda: brgemm.brgemm_blocked(a, b, k_step=k_step, pairs=False)
        check(torch.equal(alone(), base), f"K11 {shape}: one block a CTA differs from pairs")
        times["bca one block a CTA"] = time_ms(torch, alone)
        k1_ms[shape] = time_ms(torch, lambda: brgemm.matmul(flat_a, flat_b))
        if shape == "2048x2048x2048":
            was = lambda: brgemm.brgemm_blocked(a, b, k_step=k_step, variant="wmma")
            check(torch.equal(was(), base) or compare(torch, was(), base, 1e-2, 1e-2)[1],
                  "K11 wmma disagrees with wgmma")
            times["bca (wmma, was)"] = time_ms(torch, was)
        by_spec[shape] = times
        print(f"    {shape}: K11 by spec {', '.join(f'{s} {t:.4f}' for s, t in times.items())} ms"
              f" (bitwise equal); K1 on the flat product {k1_ms[shape]:.4f} ms", flush=True)
        del a, b, flat_a, flat_b, base
    bench.extra["brgemm_blocked_by_spec_ms"] = by_spec
    bench.extra["brgemm_blocked_k1_flat_ms"] = k1_ms
    # fp32 (SIMT) at 1024^3 and the test shapes; the variant counters
    for label, a_shape, b_shape, ks, dt, out, spec, variant, timed in (
            ("1024^3 fp32 64^3 k_step 4", (16, 16, 64, 64), (16, 16, 64, 64), 4, f32, None, "bca",
             "simt", True),
            ("check fp32 A 8x16 B 16x32 k_step 2", (4, 6, 8, 16), (3, 6, 16, 32), 2, f32, None,
             "bca", "simt", False),
            ("check fp32 A 4x8 B 8x16 k_step 2 bBcCa", (4, 6, 4, 8), (6, 6, 8, 16), 2, f32, None,
             "bBcCa", "simt", False),
            ("check bf16 A 8x16 B 16x32 k_step 3 cba", (4, 6, 8, 16), (3, 6, 16, 32), 3, bf16, None,
             "cba", "simt", False),
            ("check bf16 A 16x16 B 16x32 fp32 out", (4, 6, 16, 16), (3, 6, 16, 32), 2, bf16, f32,
             "Bca", "wmma", False),
            ("check bf16 A 32x16 B 16x48 k_step 1 bf16 out", (3, 5, 32, 16), (2, 5, 16, 48), 1, bf16,
             None, "cBa", "wmma", False),
            ("check bf16 A 128x64 B 64x128 fp32 out", (3, 5, 128, 64), (2, 5, 64, 128), 1, bf16,
             f32, "cba", "wgmma", False),
            ("check bf16 A 64x16 B 16x48 k_step 5", (3, 5, 64, 16), (2, 5, 16, 48), 5, bf16, None,
             "bca", "wgmma", False),
            ("check bf16 A 64x128 B 128x80", (2, 3, 64, 128), (3, 3, 128, 80), 1, bf16, None,
             "Bca", "wgmma", False),
            ("check bf16 A 128x32 B 32x256 bBcCa", (4, 6, 128, 32), (6, 6, 32, 256), 2, bf16, None,
             "bBcCa", "wgmma", False)):
        a = torch.randn(*a_shape, generator=gen, device="cuda").to(dt)
        b = torch.randn(*b_shape, generator=gen, device="cuda").to(dt)
        steps = {"b": (2,), "c": (3,)} if spec == "bBcCa" else None
        m, k, n = a_shape[0] * a_shape[2], a_shape[1] * a_shape[3], b_shape[0] * b_shape[3]
        name = "bfloat16" if (out or dt) == bf16 else "float32"
        before = getattr(brgemm, brgemm.BLOCKED_COUNTERS[variant])
        library = None
        if timed:     # torch.matmul on the same flat product, fp32 (no TF32)
            flat_a = a.permute(0, 2, 1, 3).reshape(m, k)
            flat_b = b.permute(1, 2, 0, 3).reshape(k, n)
            library = lambda: torch.matmul(flat_a, flat_b)
        bench.run("brgemm_blocked", label,
                  lambda: brgemm.brgemm_blocked(a, b, spec_string=spec, k_step=ks, block_steps=steps,
                                                out_dtype=out),
                  lambda: ref.brgemm_blocked_ref(a, b, out_dtype=out), library,
                  flops=2 * m * n * k,
                  nbytes=a.element_size() * (m * k + k * n) + m * n * (out or dt).itemsize,
                  dtype=name, tol_kind="gemm", timed=timed)
        after = getattr(brgemm, brgemm.BLOCKED_COUNTERS[variant])
        check(after > before, f"K11 {label}: the {variant} variant did not launch")


def gemm_spec_cases(torch, bench, ref, brgemm):
    """K1 under spec strings at llama2-13b's 5120x5120 projection at M 2048
    (bf16, tiles = the wgmma variant's 128x128 CTA tile and K 32, so that a
    plan block is a CTA tile), ``spec_strings``' specs plus "bca" on
    ``pick_tiles``' 512x512 blocks: every output bitwise equal to the fixed
    grid's (whose raster is grouped), each spec's time beside the fixed
    grid's.  Then bitwise checks on the decode tile (M 16, wgmma_decode) and
    the fp32 tile."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    m, k, n = 2048, 5120, 5120
    a = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    b = (torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)).to(torch.bfloat16)
    base = brgemm.matmul(a, b)
    times = {"fixed grid": time_ms(torch, lambda: brgemm.matmul(a, b))}
    cases = [(spec, (128, 32, 128), steps) for spec, steps in spec_strings(16)]
    cases.append(("bca", None, None))
    for spec, tiles, steps in cases:
        label = f"spec {spec} {steps or ''} tiles {tiles or 'pick_tiles'}"
        got = bench.run("gemm", f"{m}x{k}x{n} {label}",
                        lambda: brgemm.matmul(a, b, spec_string=spec, tiles=tiles,
                                              block_steps=steps),
                        lambda: ref.matmul_ref(a, b), lambda: torch.matmul(a, b),
                        flops=2 * m * n * k, nbytes=2 * (m * k + k * n + m * n),
                        dtype="bfloat16", tol_kind="gemm")
        check(torch.equal(got, base), f"K1 under {label} differs from the fixed grid")
        times[label] = bench.cases["gemm"][-1]["ms"]
    bench.extra["gemm_by_spec_ms"] = times
    print(f"    K1 {m}x{k}x{n} by spec (bitwise equal): "
          + ", ".join(f"{s} {t:.4f}" for s, t in times.items()) + " ms", flush=True)
    for m, k, n, dt, tiles, spec in ((16, 256, 512, torch.bfloat16, (16, 64, 64), "cba"),
                                     (256, 128, 192, torch.float32, (64, 32, 64), "cBa")):
        a = torch.randn(m, k, generator=gen, device="cuda").to(dt)
        b = torch.randn(k, n, generator=gen, device="cuda").to(dt)
        check(torch.equal(brgemm.matmul(a, b, spec_string=spec, tiles=tiles), brgemm.matmul(a, b)),
              f"K1 {m}x{k}x{n} {dt} under {spec} differs from the fixed grid")


# Tile choices of K1's wgmma variants that ``--gemm-tiles`` times beside
# the default build (csrc/gemm.cu's K1_BN, K1_STAGES, K1_DECODE_STAGES).
GEMM_TILE_CHOICES = (
    {"K1_BN": 128, "K1_STAGES": 3, "K1_CTAS": 2, "K1_GROUP": 8},     # the default build
    {"K1_BN": 256, "K1_STAGES": 4, "K1_CTAS": 1, "K1_GROUP": 1},
    {"K1_BN": 256, "K1_STAGES": 4, "K1_CTAS": 1, "K1_GROUP": 8},
    {"K1_BN": 128, "K1_STAGES": 6, "K1_CTAS": 1, "K1_GROUP": 1},
    {"K1_BN": 128, "K1_STAGES": 7, "K1_CTAS": 1, "K1_GROUP": 8},
    {"K1_BN": 128, "K1_STAGES": 3, "K1_CTAS": 2, "K1_GROUP": 1},
    {"K1_BN": 128, "K1_STAGES": 3, "K1_CTAS": 2, "K1_GROUP": 16},
    {"K1_WG": 4, "K1_BN": 128, "K1_STAGES": 4, "K1_CTAS": 1, "K1_GROUP": 8},
    {"K1_WG": 3, "K1_BN": 128, "K1_STAGES": 5, "K1_CTAS": 1, "K1_GROUP": 8},
    {"K1_WG": 4, "K1_BN": 64, "K1_STAGES": 5, "K1_CTAS": 1, "K1_GROUP": 8},
)


def llama_layer(d=5120, ff=13824):
    """(K, N, activation, occurrences) of one llama2-13b layer's projections:
    wq wk wv wo | wg (silu) | wu | wd."""
    return [(d, d, None, 4), (d, ff, "silu", 1), (d, ff, None, 1), (ff, d, None, 1)]


def gemm_tile_sweep(torch, build, brgemm):
    """K1's wgmma tile choices (``GEMM_TILE_CHOICES``, each a build of
    csrc/gemm.cu with -D macros) at one llama2-13b layer's 7 projections,
    prefill (M 2048) and decode (M 4): device ms per layer (``device_ms``)
    and one lone call's ms as phase 3 times it, each choice checked at
    ragged and transposed shapes against the plain product and compared
    bit for bit with the default build; plus the host's cost of one
    decode-shaped call and of its parts.  → the rows."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    libs = build.load_variants("gemm", list(GEMM_TILE_CHOICES))
    saved = build._LIBS.get("gemm")
    rows = []
    ops = {}
    for m in (2048, 4):
        ops[m] = [(torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16),
                   (torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)).to(torch.bfloat16),
                   act, count) for k, n, act, count in llama_layer()]
    # checks: ragged and transposed products against the plain version, and
    # each choice's bits against the default build's
    checks = []
    for m, k, n, ta, tb in ((2100, 136, 5120, False, False), (200, 136, 520, False, False),
                            (256, 192, 512, True, False), (256, 192, 512, False, True),
                            (384, 192, 512, True, True), (2048, 5120, 5120, False, False)):
        a = torch.randn(k, m, generator=gen, device="cuda").to(torch.bfloat16).T if ta else \
            torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        b = torch.randn(n, k, generator=gen, device="cuda").to(torch.bfloat16).T if tb else \
            torch.randn(k, n, generator=gen, device="cuda").to(torch.bfloat16)
        checks.append((f"{m}x{k}x{n} trans {ta} {tb}", a, b))
    first = None
    try:
        for choice, lib in zip(GEMM_TILE_CHOICES, libs):
            build._LIBS["gemm"] = lib
            outs = [brgemm.matmul(a, b) for _, a, b in checks]
            torch.cuda.synchronize()
            for (label, a, b), got in zip(checks, outs):
                err, ok = compare(torch, got, a.float() @ b.float(), 1e-2, 1e-2)
                check(ok, f"K1 tiles {choice} {label}: max abs err {err:.3e}")
            if first is None:
                first = outs
            row = {"tiles": choice,
                   "bits_equal_to_default": all(torch.equal(x, y) for x, y in zip(outs, first))}
            for m, label in ((2048, "prefill"), (4, "decode")):
                dev = lone = 0.0
                for a, b, act, count in ops[m]:
                    fn = lambda: brgemm.matmul(a, b, activation=act)
                    dev += count * device_ms(torch, fn)
                    lone += count * time_ms(torch, fn)
                row[f"{label}_device_ms"], row[f"{label}_lone_ms"] = dev, lone
            rows.append(row)
            print(f"  K1 tiles {choice}: prefill layer {row['prefill_device_ms']:.4f} ms on the"
                  f" device ({row['prefill_lone_ms']:.4f} lone calls), decode layer"
                  f" {row['decode_device_ms']:.4f} ({row['decode_lone_ms']:.4f}); bits equal to"
                  f" the default build: {row['bits_equal_to_default']}", flush=True)
    finally:
        if saved is not None:
            build._LIBS["gemm"] = saved
        else:
            build._LIBS.pop("gemm", None)
    a, b, _, _ = ops[4][0]
    dev = a.device
    parts = {"matmul wgmma_decode": lambda: brgemm.matmul(a, b),
             "matmul wmma": lambda: brgemm.matmul(a, b, variant="wmma"),
             "torch.matmul": lambda: torch.matmul(a, b),
             "torch.empty": lambda: torch.empty(4, 5120, dtype=torch.bfloat16, device=dev),
             "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
             "variant_of": lambda: brgemm.variant_of(a, b)}
    host = {k: host_us(torch, f) for k, f in parts.items()}
    print("  host us a call (20 back to back): "
          + ", ".join(f"{k} {v:.1f}" for k, v in host.items()), flush=True)
    return {"choices": rows, "host_us": host}


# ResNet-50's 1x1 layers (He et al., arXiv:1512.03385, Table 1): (H = W of
# the input, C, K, stride)
RESNET_1X1 = ((56, 64, 256, 1), (56, 256, 64, 1), (56, 256, 512, 2), (28, 512, 128, 1),
              (14, 1024, 256, 1), (7, 512, 2048, 1), (7, 2048, 512, 1))
# and its 3x3 layers (output H = W, C = K), VALID on an input of H + 2
RESNET_3X3 = ((56, 64), (28, 128), (14, 256), (7, 512))


def conv_operands(torch, gen, n, hw, c, k, r, dtype):
    x = torch.randn(n, hw, hw, c, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(r, r, c, k, generator=gen, device="cuda") / math.sqrt(r * r * c)).to(dtype)
    return x, w


def conv1x1_cases(torch, bench, ref, ops):
    """K12 (``ops.conv2d`` with a 1x1 filter: the blocking, the reshape and
    K1 under "bca") on ResNet-50's 1x1 layers at N 32, bf16, against
    ``conv2d_ref``, timed beside it and beside ``F.conv2d`` in bf16 on
    channels-last tensors (cuDNN, the library); plus one fp32 layer."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(20)
    n = 32
    for hw, c, k, st in RESNET_1X1:
        x, w = conv_operands(torch, gen, n, hw, c, k, 1, torch.bfloat16)
        p = (hw - 1) // st + 1
        x_nchw = x.permute(0, 3, 1, 2)      # channels-last as stored
        w_kcrs = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        bench.run("conv2d_1x1", f"{hw}x{hw} {c}->{k} stride {st} N {n}",
                  lambda: ops.conv2d(x, w, stride=st), lambda: ref.conv2d_ref(x, w, stride=st),
                  lambda: F.conv2d(x_nchw, w_kcrs, stride=st),
                  # the strided input pixels the layer reads, w and the output once
                  flops=2 * n * p * p * c * k, nbytes=2 * (n * p * p * c + c * k + n * p * p * k),
                  dtype="bfloat16", tol_kind="gemm", weight=1)
    x, w = conv_operands(torch, gen, 4, 14, 1024, 256, 1, torch.float32)
    bench.run("conv2d_1x1", "check fp32 14x14 1024->256 N 4",
              lambda: ops.conv2d(x, w), lambda: ref.conv2d_ref(x, w), None,
              flops=2 * 4 * 14 * 14 * 1024 * 256, nbytes=4 * (4 * 196 * 1024 + 1024 * 256 + 4 * 196 * 256),
              dtype="float32", tol_kind="gemm", timed=False)


def bert_attention_cases(torch, bench, fusion):
    """Bidirectional attention at bert-large's training shape (B 16, H 16,
    S 512, D 64, bf16) through K5's chained root and its six derived
    backward graphs (each fed the plain version's outputs of the graphs
    before it), beside SDPA and SDPA's backward; K2 and K6 at this shape
    are cases of ``attention_cases`` and ``attention_bwd_cases``."""
    import torch.nn.functional as F
    from repro_torch.kernels import fused_gemm
    gen = torch.Generator(device="cuda").manual_seed(16)
    f32 = torch.float32
    b, h, s, d = 16, 16, 512, 64

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    def run(kernel, label, graph, ops, *, flops, nbytes, library=None, out_dtype=None):
        k5, plain = _graph_run(torch, fusion, graph, out_dtype)
        tol = "bfloat16" if out_dtype is None else "float32"
        return bench.run(kernel, f"{graph.name} {label}", lambda: k5(**ops), lambda: plain(**ops),
                         library, flops=flops, nbytes=nbytes, dtype=tol, tol_kind="gemm",
                         peak=k5_peak(torch, fusion, fused_gemm, graph, ops))

    q = randn(b, s, h, d).transpose(1, 2)
    k, v, dy = randn(b, h, s, d), randn(b, h, s, d), randn(b, h, s, d)
    graph = fusion.fused_attention_graph(causal=False, scale=d ** -0.5)
    full = 2 * b * h * s * s * d
    run("fused_chain", f"bert B{b} H{h} S{s} D{d} bidirectional", graph, dict(q=q, k=k, v=v),
        flops=2 * full, nbytes=_nbytes(q, k, v, dy),
        library=lambda: F.scaled_dot_product_attention(q, k, v))
    g = {fusion.derive_vjp(graph).graph_role(nm): gr for nm, gr in fusion.backward_graphs(graph).items()}
    label = f"bert B{b} H{h} S{s} D{d}"
    p = run("fused_attention_bwd", f"P {label}", g["p"], dict(q=q, k=k), out_dtype=f32, flops=full,
            nbytes=_nbytes(q, k) + 4 * b * h * s * s)
    dp = run("fused_attention_bwd", f"dP {label}", g["dp"], dict(dy=dy, v=v), out_dtype=f32,
             flops=full, nbytes=_nbytes(dy, v) + 4 * b * h * s * s)
    dz = run("fused_attention_bwd", f"dZ {label}", g["dz"], dict(q=q, k=k, dp=dp), out_dtype=f32,
             flops=full, nbytes=_nbytes(q, k, dp, dp))
    del dp
    for role, ops in (("dq", dict(dz=dz, k=k)), ("dk", dict(dz=dz, q=q)), ("dv", dict(p=p, dy=dy))):
        run("fused_attention_bwd", f"{role} {label}", g[role], ops, out_dtype=f32, flops=full,
            nbytes=_nbytes(*ops.values()) + 4 * b * h * s * d)
    del p, dz
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qg, kg, vg)
    rows = bench.cases["fused_attention_bwd"][-6:]
    bench.extra["bert_attention_bwd"] = {
        "six_graphs_ms": sum(r["ms"] for r in rows), "bound_ms": sum(r["bound_ms"] for r in rows),
        "sdpa_backward_ms": time_ms(torch, lambda: torch.autograd.grad(sdpa, (qg, kg, vg), dy,
                                                                        retain_graph=True))}
    print(f"  bert's six derived attention-backward graphs: {bench.extra['bert_attention_bwd']['six_graphs_ms']:.4f}"
          f" ms against SDPA's backward {bench.extra['bert_attention_bwd']['sdpa_backward_ms']:.4f} ms",
          flush=True)


# K5's chained backward in phase 3: label, B, H, Sq, Skv, D, causal, window,
# dtype, weight, timed (the graph: fused_attention_graph at scale D^-0.5 and
# offset Skv - Sq)
CHAINED_BWD_CASES = [
    ("minicpm B4 H36 S1024 D64 causal", 4, 36, 1024, 1024, 64, True, 0, "bfloat16", 1, True),
    ("bert B16 H16 S512 D64 bidirectional", 16, 16, 512, 512, 64, False, 0, "bfloat16", 0, True),
    ("window256 B4 H36 S1024 D64", 4, 36, 1024, 1024, 64, True, 256, "bfloat16", 0, True),
    ("check Sq53 Skv80 H3 D16 window24", 2, 3, 53, 80, 16, True, 24, "bfloat16", 0, False),
    ("check Sq70 Skv40 H4 D32 masked rows", 2, 4, 70, 40, 32, True, 0, "bfloat16", 0, False),
    ("check Sq100 H6 D16 window7 fp32", 2, 6, 100, 100, 16, True, 7, "float32", 0, False),
    ("check Sq70 Skv100 H3 D16 fp32", 1, 3, 70, 100, 16, True, 0, "float32", 0, False),
    ("check Sq97 H2 D128 bidirectional", 1, 2, 97, 97, 128, False, 0, "bfloat16", 0, False),
    ("check Sq33 H2 D256 causal", 1, 2, 33, 33, 256, True, 0, "bfloat16", 0, False),
]


def chained_bwd_graph(fusion, sq, skv, d, causal, window):
    return fusion.fused_attention_graph(causal=causal, window=window, scale=d ** -0.5,
                                        offset=skv - sq)


def chained_backward_sources(fusion, fused_gemm):
    """name → generated chained-backward source (csrc/attention_bwd.cuh) of
    every chained graph the fused training paths and phase 3 differentiate
    on the card, at its head dim: one source per graph structure and head
    dim."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm

    pairs = [(fusion.fused_attention_graph(causal=True, window=256, scale=0.125), 64)]
    for cfg in (get_config("minicpm_2b"), get_config("minicpm_2b").reduced(),
                get_config("gptj_6b"), get_config("gptj_6b").reduced(), get_config("bert_large"),
                get_config("bert_large").reduced()):
        for kind in sorted(set(lm.layer_kinds(cfg))):
            pairs.append((attention_graph(fusion, cfg, kind), cfg.head_dim))
    for _, _, _, sq, skv, d, causal, window, *_ in CHAINED_BWD_CASES:
        pairs.append((chained_bwd_graph(fusion, sq, skv, d, causal, window), d))
    pairs.append((fusion.fused_attention_graph(causal=True, scale=0.125), 64))   # the GQA check
    out = {}
    for g, d in pairs:
        src = fused_gemm.generate_backward_source(fusion.derive_vjp(g), d)
        out[fused_gemm.backward_source_name(src)] = src
    return out


def chained_bwd_cases(torch, bench, fusion, fused_gemm, ops):
    """K5's chained backward (one generated kernel on csrc/attention_bwd.cuh
    for the graph's own epilogue) against its plain version
    (``ChainedBackward.plain``: ``ref.flash_bwd_ref`` on the graph's nodes)
    from the chained forward's output and row lse, at minicpm-2b's training
    shape (causal, and window 256) and bert-large's (bidirectional), beside
    SDPA's backward; at those two shapes also against the six derived graphs
    the CPU runs (on K5's card kernels); two calls bitwise equal; small fp32
    and bf16 checks (ragged, Sq < Skv, rows with no key, D 16 to 256, each
    from K5's own chained forward); and
    GQA through ``fused_attention_apply`` under autograd against K6 through
    ``ops.attention``, one chained-backward launch and none of the six."""
    import torch.nn.functional as F
    from repro_torch.fusion import autodiff

    gen = torch.Generator(device="cuda").manual_seed(22)
    for label, b, h, sq, skv, d, causal, window, dtname, weight, timed in CHAINED_BWD_CASES:
        dt = torch.bfloat16 if dtname == "bfloat16" else torch.float32
        q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dt).transpose(1, 2)
        k, v = (torch.randn(b, h, skv, d, generator=gen, device="cuda").to(dt) for _ in range(2))
        dy = torch.randn(b, h, sq, d, generator=gen, device="cuda").to(dt)
        graph = chained_bwd_graph(fusion, sq, skv, d, causal, window)
        plan = fusion.derive_vjp(graph)
        kern = fused_gemm.ChainedBackward(plan)
        y, lse = fusion.compile(graph, path="cuda").with_lse(q=q, k=k, v=v)
        library = None
        if timed:
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            if window:
                keep = torch.ones(sq, skv, dtype=torch.bool, device="cuda").tril().triu(-(window - 1))
                out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep)
            else:
                out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
            library = lambda: torch.autograd.grad(out, (qg, kg, vg), dy, retain_graph=True)
        fn = lambda: kern(q, k, v, y, lse, dy)
        got = bench.run("fused_attention_bwd", f"{graph.name} {label}", fn,
                        lambda: kern.plain(q, k, v, y, lse, dy), library,
                        flops=10 * b * h * d * _pairs(torch, sq, skv, causal, window or None),
                        nbytes=q.element_size() * (4 * b * h * sq * d + 4 * b * h * skv * d)
                        + 4 * b * h * sq, dtype=dtname, tol_kind="attn", weight=weight,
                        timed=timed)
        check(all(torch.equal(a, c) for a, c in zip(got, fn())),
              f"chained backward {label}: two identical calls differ")
        if timed and window == 0:
            # the six derived graphs on the card, as the CPU path runs them.
            # They take D = rowsum(P * dP) from their fp32 panels, the kernel
            # (and its plain version) D = rowsum(dO * O) from the bf16
            # output: 2^-9 apart, which moves small gradients by ~1.6e-2, so
            # this cross-check holds the repo's bf16 test tolerance
            six = autodiff._run_backward_chained(plan, {"q": q, "k": k, "v": v}, dy)
            torch.cuda.synchronize()
            err, ok = compare(torch, got, (six["q"], six["k"], six["v"]), *BF16_LOGITS)
            six_ms = time_ms(torch, lambda: autodiff._run_backward_chained(
                plan, {"q": q, "k": k, "v": v}, dy), warmup=1, reps=3)
            bench.extra.setdefault("chained_bwd_vs_six_graphs", {})[label] = {
                "max_abs_err": err, "six_graphs_ms": six_ms, "kernel_ms": bench.cases[
                    "fused_attention_bwd"][-1]["ms"]}
            print(f"  {'':15s} {label:38s} against the six derived graphs: max_abs_err"
                  f" {err:.3e}; six graphs {six_ms:.4f} ms", flush=True)
            check(ok, f"chained backward {label}: disagrees with the six derived graphs ({err:.3e})")
            del six
        if sq > skv and causal:
            check(all(bool((t[..., :sq - skv, :] == 0).all()) for t in got[:1]),
                  f"chained backward {label}: a row with no key got a gradient")

    # GQA through the library helper under autograd, beside K6
    b, h, hk, s, d = 2, 8, 2, 256, 64
    q, k, v, dy = (torch.randn(b, hh, s, d, generator=gen, device="cuda").to(torch.bfloat16)
                   .requires_grad_(i < 3) for i, hh in enumerate((h, hk, hk, h)))
    before = dict(fused_gemm.GRAPH_LAUNCHES)
    got = torch.autograd.grad(fusion.fused_attention_apply(q, k, v, causal=True), (q, k, v), dy)
    launched = {g: n - before.get(g, 0) for g, n in fused_gemm.GRAPH_LAUNCHES.items()
                if n != before.get(g, 0)}
    want = torch.autograd.grad(ops.attention(q, k, v, causal=True), (q, k, v), dy)
    # two kernels' bf16 results, each within (1e-2, 1e-2) of its own plain
    # version, from different forwards (K5's o against K2's) and with dk and
    # dv summed over the group in bf16 by autograd's repeat: the repo's bf16
    # test tolerance
    err, ok = compare(torch, got, want, *BF16_LOGITS)
    print(f"  GQA B{b} H{h} Hk{hk} S{s} D{d} through fused_attention_apply: gradients against K6's"
          f" max_abs_err {err:.3e}; K5 launches {launched}", flush=True)
    check(ok, f"chained backward under autograd (GQA) disagrees with K6: {err:.3e}")
    check(sorted(launched.values()) == [1, 1]
          and any(g.endswith(fused_gemm.BACKWARD_SUFFIX) for g in launched)
          and not any("@bwd_" in g and not g.endswith(fused_gemm.BACKWARD_SUFFIX) for g in launched),
          f"the chained attention under autograd launched {launched}: want its forward and one"
          " chained backward")


# K5's chained forward beside K2 in phase 3: label, B, H, Sq, Skv, D, causal,
# window (the graph: fused_attention_graph at scale D^-0.5, offset Skv - Sq;
# q a strided view of the (B, S, H, D) projection, k and v contiguous)
CHAINED_FWD_ROWS = [
    ("minicpm B4 H36 S1024 D64 causal", 4, 36, 1024, 1024, 64, True, 0),
    ("window256 B4 H36 S1024 D64", 4, 36, 1024, 1024, 64, True, 256),
    ("bert B16 H16 S512 D64 bidirectional", 16, 16, 512, 512, 64, False, 0),
    ("gptj B2 H16 S2048 D256 causal", 2, 16, 2048, 2048, 256, True, 0),
]


def chained_forward_cases(torch, bench, fusion, fused_gemm, fa):
    """K5's chained forward (csrc/attention_fwd.cuh on the generated
    epilogue) against its plain version at gpt-j-6b's row (B 2, H 16, S
    2048, D 256, causal: the repaired D 256), then at the four rows of
    ``CHAINED_FWD_ROWS`` beside K2 and SDPA on the same inputs, each timed
    alone and 20 calls back to back (the minicpm-2b, window and bert-large
    rows' checks are ``fused_training_cases``' and ``bert_attention_cases``');
    every bf16 launch on wgmma (``CHAIN_WGMMA_LAUNCHES``).  Untimed checks:
    D 16, 32 and 128; Sq < Skv; offset -1, whose first row has no key (0
    and lse -inf, where the plain version's composed path gives a uniform
    row); k and v shared by every problem (2-D) and by the heads (stride 0);
    fp32 at D 256 on the SIMT variant; a misaligned bf16 operand, which must
    raise ValueError; two calls bitwise equal."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(41)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    def counted(fn):
        before = fused_gemm.CHAIN_WGMMA_LAUNCHES
        out = fn()
        torch.cuda.synchronize()
        return out, fused_gemm.CHAIN_WGMMA_LAUNCHES - before

    def back_to_back(fn):
        return time_ms(torch, lambda: [fn() for _ in range(20)], warmup=1, reps=5) / 20

    rows = {}
    for label, b, h, sq, skv, d, causal, window in CHAINED_FWD_ROWS:
        q = randn(b, sq, h, d).transpose(1, 2)
        k, v = randn(b, h, skv, d), randn(b, h, skv, d)
        graph = fusion.fused_attention_graph(causal=causal, window=window, scale=d ** -0.5,
                                             offset=skv - sq)
        k5, plain = _graph_run(torch, fusion, graph)
        chain = lambda: k5(q=q, k=k, v=v)
        k2 = lambda: fa.flash_attention(q, k, v, causal=causal, window=window or None)
        if window:
            keep = torch.ones(sq, skv, dtype=torch.bool, device="cuda").tril().triu(-(window - 1))
            library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
        else:
            library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        pairs = _pairs(torch, sq, skv, causal, window or None)
        got, n = counted(chain)
        check(n == 1, f"chained forward {label}: {n} wgmma launches, want 1")
        check(torch.equal(got, chain()), f"chained forward {label}: two identical calls differ")
        if d == 256:
            bench.run("fused_chain", f"{graph.name} {label}", chain, lambda: plain(q=q, k=k, v=v),
                      library, flops=4 * b * h * d * pairs, nbytes=_nbytes(q, k, v, q),
                      dtype="bfloat16", tol_kind="attn")
        row = {"chain_ms": time_ms(torch, chain), "k2_ms": time_ms(torch, k2),
               "sdpa_ms": time_ms(torch, library), "chain_back_to_back_ms": back_to_back(chain),
               "k2_back_to_back_ms": back_to_back(k2), "sdpa_back_to_back_ms": back_to_back(library),
               "bound_ms": bench.bound(4 * b * h * d * pairs, _nbytes(q, k, v, q), "bf16")[0]}
        rows[label] = row
        print(f"  {'fused_chain':15s} {label:38s} chained {row['chain_ms']:.4f} ms, K2"
              f" {row['k2_ms']:.4f}, SDPA {row['sdpa_ms']:.4f}; 20 back to back: chained"
              f" {row['chain_back_to_back_ms']:.4f}, K2 {row['k2_back_to_back_ms']:.4f}, SDPA"
              f" {row['sdpa_back_to_back_ms']:.4f}; bound {row['bound_ms']:.4f} ms", flush=True)
        del q, k, v, got
    bench.extra["chained_forward_vs_k2"] = rows

    def check_case(label, graph, ops, *, dtype="bfloat16", wgmma=1, no_key_rows=0):
        k5, plain = _graph_run(torch, fusion, graph)
        if no_key_rows:
            # the kernel gives 0 there, the plain version (the composed
            # path) a uniform row: compare the rows that have a key
            def want():
                return torch.cat([torch.zeros_like(k5(**ops)[..., :no_key_rows, :]),
                                  plain(**ops)[..., no_key_rows:, :]], dim=-2)
        else:
            want = lambda: plain(**ops)
        got, n = counted(lambda: k5(**ops))
        check(n == wgmma, f"chained forward {label}: {n} wgmma launches, want {wgmma}")
        bench.run("fused_chain", f"check {label}", lambda: k5(**ops), want, None, flops=0,
                  nbytes=0, dtype=dtype, tol_kind="attn", timed=False)
        check(torch.equal(got, k5(**ops)), f"chained forward {label}: two identical calls differ")
        return k5

    for d in (16, 32, 128):
        check_case(f"D{d} B2 H3 Sq150", fusion.fused_attention_graph(causal=True, scale=d ** -0.5),
                   dict(q=randn(2, 150, 3, d).transpose(1, 2), k=randn(2, 3, 150, d),
                        v=randn(2, 3, 150, d)))
    check_case("Sq70 Skv200 D64", fusion.fused_attention_graph(causal=True, scale=0.125, offset=130),
               dict(q=randn(1, 4, 70, 64), k=randn(1, 4, 200, 64), v=randn(1, 4, 200, 64)))
    ops = dict(q=randn(1, 2, 100, 32), k=randn(1, 2, 100, 32), v=randn(1, 2, 100, 32))
    one = check_case("offset -1 D32, row 0 with no key",
                     fusion.fused_attention_graph(causal=True, scale=32 ** -0.5, offset=-1), ops,
                     no_key_rows=1)
    out, lse = one.with_lse(**ops)
    check(bool((out[..., 0, :] == 0).all()) and bool(torch.isneginf(lse[..., 0]).all())
          and bool(torch.isfinite(lse[..., 1:]).all()),
          "chained forward offset -1: the row with no key is not 0 with lse -inf")
    check_case("k, v shared by every problem", fusion.fused_attention_graph(causal=True, scale=0.125),
               dict(q=randn(2, 3, 200, 64), k=randn(200, 64), v=randn(200, 64)))
    check_case("k, v shared by the heads (stride 0)",
               fusion.fused_attention_graph(causal=False, scale=0.125),
               dict(q=randn(2, 200, 3, 64).transpose(1, 2), k=randn(2, 1, 200, 64).expand(2, 3, 200, 64),
                    v=randn(2, 1, 200, 64).expand(2, 3, 200, 64)))
    check_case("D256 fp32 (SIMT)", fusion.fused_attention_graph(causal=True, scale=1 / 16),
               dict(q=randn(1, 2, 70, 256, dtype=torch.float32),
                    k=randn(1, 2, 70, 256, dtype=torch.float32),
                    v=randn(1, 2, 70, 256, dtype=torch.float32)), dtype="float32", wgmma=0)
    bad = torch.empty(2 * 64 * 64 + 8, dtype=torch.bfloat16, device="cuda")[1:1 + 2 * 64 * 64]
    try:
        fusion.compile(fusion.fused_attention_graph(causal=True, scale=0.125), path="cuda")(
            q=bad.view(2, 64, 64), k=randn(2, 64, 64), v=randn(2, 64, 64))
    except ValueError as e:
        print(f"  a misaligned bf16 q (2 bytes off): ValueError, {str(e)[:60]}...", flush=True)
    else:
        check(False, "a misaligned bf16 operand of the chained forward did not raise ValueError")


def sweep_graphs(fusion):
    """Small graphs that between them use every pointwise op K5's generator
    takes (and a graph of two distinct lhs operands)."""
    Root, Node, Op, TppGraph = (fusion.ContractionRoot, fusion.Node, fusion.OperandSpec,
                                fusion.TppGraph)
    unary = TppGraph(
        "sweep_unary", (Op("x", "lhs"), Op("w", "rhs")),
        nodes=(Node("n0", "scale", ("acc",), (("s", 0.37),)), Node("n1", "gelu", ("n0",)),
               Node("n2", "silu", ("acc",)), Node("n3", "sigmoid", ("n2",)),
               Node("n4", "relu", ("n1",)), Node("n5", "identity", ("n3",))),
        outputs=("n4", "n5", "n0"))
    binary = TppGraph(
        "sweep_binary", (Op("x", "lhs"), Op("wa", "rhs"), Op("wb", "rhs"), Op("t", "tile"),
                         Op("bias", "rowvec"), Op("s", "rowvec"), Op("keep", "mask")),
        roots=(Root("a", "x", "wa"), Root("b", "x", "wb")),
        nodes=(Node("n0", "add", ("a", "b")), Node("n1", "sub", ("n0", "t")),
               Node("n2", "mul", ("n1", "b")), Node("n3", "residual_add", ("n2", "t")),
               Node("n4", "bias_add", ("n3", "bias")), Node("n5", "scale_rowvec", ("n4", "s")),
               Node("n6", "dropout", ("n5", "keep"), (("rate", 0.3),))),
        outputs=("n6", "n1"))
    grads = TppGraph(
        "sweep_grads", (Op("x", "lhs"), Op("wd", "rhs"), Op("wz", "rhs"), Op("keep", "mask")),
        roots=(Root("dv", "x", "wd"), Root("z", "x", "wz")),
        nodes=(Node("n0", "relu_grad", ("dv", "z")), Node("n1", "gelu_grad", ("dv", "z")),
               Node("n2", "silu_grad", ("dv", "z")), Node("n3", "sigmoid_grad", ("dv", "z")),
               Node("n4", "dropout_grad", ("n0", "keep"), (("rate", 0.25),))),
        outputs=("n4", "n1", "n2", "n3"))
    two_lhs = TppGraph(
        "sweep_two_lhs", (Op("x1", "lhs"), Op("x2", "lhs"), Op("w", "rhs")),
        roots=(Root("a1", "x1", "w"), Root("a2", "x2", "w")),
        nodes=(Node("n0", "add", ("a1", "a2")),))
    return [unary, binary, grads, two_lhs]


def fused_graphs(fusion):
    """Every graph phase 3 and the fused serving path launch: the path's
    (llama2-13b, gpt-j-6b), fused_qkv, the op sweep, Listing 6's keep-mask
    graph beside K7, and K13's graphs (with Listing 6 at rate 0)."""
    return [fusion.fused_gated_mlp_graph("silu"), fusion.fused_attn_out_graph(True),
            fusion.fused_mlp_graph("gelu"), fusion.fused_qkv_graph(), *sweep_graphs(fusion),
            fusion.fused_output_graph(0.1, rng_dropout=False), *k13_graphs(fusion),
            fusion.fused_output_graph(0.0)]


def training_graphs(fusion):
    """Every K5 graph the fused training path launches for full-width
    minicpm-2b, gpt-j-6b and bert-large and the reduced minicpm-2b, gpt-j-6b and
    bert-large of phase 8 (the chained attention at each config's scale and
    kind, causal or bidirectional, fused_attn_out with and without dropout,
    the gated and plain MLP up projections, and all their derived backward
    graphs), and phase 3's row-panel and windowed checks."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm

    fwd = [fusion.fused_attn_out_graph(True), fusion.fused_attn_out_graph(True, dropout_rate=0.15),
           fusion.fused_gated_mlp_graph("silu"), fusion.fused_mlp_graph("gelu"),
           fusion.fused_attention_graph(causal=True, window=256, scale=0.125),
           fusion.fused_output_graph(0.1), fusion.fused_attn_out_graph(True, "rmsnorm", 1e-6)]
    for cfg in (get_config("minicpm_2b"), get_config("minicpm_2b").reduced(),
                get_config("gptj_6b"), get_config("gptj_6b").reduced(), get_config("bert_large"),
                get_config("bert_large").reduced()):
        for kind in sorted(set(lm.layer_kinds(cfg))):
            fwd.append(attention_graph(fusion, cfg, kind))
    out = []
    for g in fwd:
        out.append(g)
        out.extend(fusion.backward_graphs(g).values())
    return out


def attention_graph(fusion, cfg, kind):
    """The chained-root attention graph a ``kind`` layer of ``cfg`` runs
    with ``use_fusion``: causal (and windowed for a local layer), or
    bidirectional for bert's ``bidir`` layers."""
    return fusion.fused_attention_graph(
        causal=kind != "bidir", window=cfg.sliding_window if kind == "local" else 0,
        scale=1.0 / math.sqrt(cfg.head_dim))


def fused_sources(fusion, fused_gemm, graphs=None):
    """name → generated CUDA source of every graph in ``graphs`` (default:
    ``fused_graphs`` and ``training_graphs``); graphs of one structure
    share a source."""
    out = {}
    for g in graphs if graphs is not None else fused_graphs(fusion) + training_graphs(fusion):
        src = fused_gemm.generate_source(fusion.simplify_graph(g))
        out[fused_gemm.source_name(fusion.simplify_graph(g), src)] = src
    return out


def fused_gemm_cases(torch, bench, fusion, fused_gemm):
    """K5 (each graph's generated kernel) against its plain version, the
    composed reference path, on the card: llama2-13b's fused_gated_mlp_silu
    and fused_attn_out_res at prefill (M 2048) and decode (M 4), gpt-j-6b's
    fused_mlp_gelu, fused_qkv at llama2 GQA widths (5120 → 5120/1024/1024),
    each timed beside the WMMA variant it replaced (``k5_beside``); decoded
    rows bitwise equal at M 1, 3, 8 and 16 (wgmma_decode); ragged
    TMA-readable shapes on wgmma (narrow roots, both operands stored
    transposed, two batch axes with a shared rhs, at M <= 16 too), ragged
    misaligned (wmma) and fp32 cases, and the op sweep in fp32 and bf16."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(11)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    def run(label, graph, ops, *, flops, nbytes, library=None, weight=0, timed=True,
            out_dtype=None):
        dt = next(iter(ops.values())).dtype
        name = "bfloat16" if dt == torch.bfloat16 else "float32"
        kernel = fusion.compile(graph, path="cuda", out_dtype=out_dtype)
        plain = fusion.compile(graph, path="reference", out_dtype=out_dtype)
        g = fusion.simplify_graph(graph)
        variant = fused_gemm.variant_of(g, {k: v for k, v in ops.items() if k in g.operand_names})
        bench.run("fused_gemm", f"{graph.name} {label} [{variant}]", lambda: kernel(**ops),
                  lambda: plain(**ops), library if timed else None, flops=flops,
                  nbytes=nbytes, dtype=name, tol_kind="gemm", weight=weight, timed=timed,
                  peak=k5_peak(torch, fusion, fused_gemm, graph, ops))
        if timed:
            k5_beside(torch, bench, fusion, fused_gemm, f"{graph.name} {label}", graph, ops,
                      out_dtype)

    d, ff = 5120, 13824
    gated = fusion.fused_gated_mlp_graph("silu")
    attn_out = fusion.fused_attn_out_graph(True)
    for m in (2048, 4):          # llama2-13b prefill (B 4 x 512) and decode (B 4)
        x, wg, wu = randn(m, d), randn(d, ff, scale=d ** -0.5), randn(d, ff, scale=d ** -0.5)
        run(f"M{m} {d}->{ff}", gated, dict(x=x, wg=wg, wu=wu), weight=1,
            flops=4 * m * d * ff, nbytes=2 * (m * d + 2 * d * ff + m * ff),
            library=lambda: F.silu(x @ wg) * (x @ wu))
        del x, wg, wu
        o, wo, res = randn(m, d), randn(d, d, scale=d ** -0.5), randn(m, d)
        run(f"M{m} {d}->{d}", attn_out, dict(o=o, wo=wo, residual=res), weight=1,
            flops=2 * m * d * d, nbytes=2 * (m * d + d * d + 2 * m * d),
            library=lambda: torch.addmm(res, o, wo))
        del o, wo, res
    # decoded rows: bitwise the same at every M <= 16 (the K split is (K, N)'s)
    x, wg, wu = randn(16, d), randn(d, ff, scale=d ** -0.5), randn(d, ff, scale=d ** -0.5)
    wo, res = randn(d, d, scale=d ** -0.5), randn(16, d)
    kg, ka = fusion.compile(gated, path="cuda"), fusion.compile(attn_out, path="cuda")
    full_g, full_a = kg(x=x, wg=wg, wu=wu), ka(o=x, wo=wo, residual=res)
    for m in (1, 3, 8):
        check(torch.equal(kg(x=x[:m], wg=wg, wu=wu), full_g[:m])
              and torch.equal(ka(o=x[:m], wo=wo, residual=res[:m]), full_a[:m]),
              f"K5 decode: rows of M {m} differ from the same rows at M 16")
    print("  K5 decode (wgmma_decode): rows bitwise equal at M 1, 3, 8 and 16 for both graphs",
          flush=True)
    del x, wg, wu, wo, res, full_g, full_a
    # gpt-j-6b's up projection, 4096 -> 16384 with bias and tanh gelu
    m, k, n = 2048, 4096, 16384
    x, w, b = randn(m, k), randn(k, n, scale=k ** -0.5), randn(n)
    run(f"M{m} {k}->{n}", fusion.fused_mlp_graph("gelu"), dict(x=x, w=w, bias=b),
        flops=2 * m * k * n, nbytes=2 * (m * k + k * n + n + m * n),
        library=lambda: F.gelu(x @ w + b, approximate="tanh"))
    del x, w, b
    # fused_qkv at llama2 GQA widths (8 kv heads of 128): one stacked output
    m, nk = 2048, 1024
    x, wq, wk, wv = randn(m, d), randn(d, d, scale=d ** -0.5), randn(d, nk, scale=d ** -0.5), \
        randn(d, nk, scale=d ** -0.5)
    wqkv = torch.cat([wq, wk, wv], 1)
    run(f"M{m} {d}->{d}/{nk}/{nk}", fusion.fused_qkv_graph(), dict(x=x, wq=wq, wk=wk, wv=wv),
        flops=2 * m * d * (d + 2 * nk), nbytes=2 * (m * d + d * (d + 2 * nk) + 3 * m * d),
        library=lambda: x @ wqkv)
    del x, wq, wk, wv, wqkv
    # ragged, M <= 16, fp32, fp32 out, narrow roots
    for dt in (torch.bfloat16, torch.float32):
        for m, k, n in ((37, 200, 100), (5, 72, 130), (70, 300, 96)):
            x, wg, wu = randn(m, k, dtype=dt), randn(k, n, dtype=dt), randn(k, n, dtype=dt)
            run(f"check M{m} K{k} N{n}", gated, dict(x=x, wg=wg, wu=wu), timed=False,
                flops=4 * m * k * n, nbytes=x.element_size() * (m * k + 2 * k * n + m * n))
            o, wo, res = randn(m, k, dtype=dt), randn(k, n, dtype=dt), randn(m, n, dtype=dt)
            run(f"check M{m} K{k} N{n}", attn_out, dict(o=o, wo=wo, residual=res), timed=False,
                flops=2 * m * k * n, nbytes=x.element_size() * (m * k + k * n + 2 * m * n))
        x, wq, wk, wv = randn(33, 64, dtype=dt), randn(64, 96, dtype=dt), \
            randn(64, 32, dtype=dt), randn(64, 32, dtype=dt)
        run("check narrow M33 K64 N96/32/32", fusion.fused_qkv_graph(),
            dict(x=x, wq=wq, wk=wk, wv=wv), timed=False, flops=2 * 33 * 64 * 160,
            nbytes=x.element_size() * (33 * 64 + 64 * 160 + 3 * 33 * 96))
        m, k, n = 48, 96, 80
        for g in sweep_graphs(fusion):
            ops = {}
            for spec in g.operands:
                shape = {"lhs": (m, k), "rhs": (k, n), "tile": (m, n), "rowvec": (n,)}.get(spec.kind)
                ops[spec.name] = (torch.rand(m, n, generator=gen, device="cuda") > 0.4
                                  if spec.kind == "mask" else randn(*shape, dtype=dt))
            run(f"check sweep M{m} K{k} N{n}", g, ops, timed=False,
                flops=2 * m * k * n * len(g.base_roots), nbytes=0)
    x, wg, wu = randn(37, 200), randn(200, 100), randn(200, 100)
    run("check bf16 in, fp32 out", gated, dict(x=x, wg=wg, wu=wu), timed=False,
        flops=4 * 37 * 200 * 100, nbytes=0, out_dtype=torch.float32)
    # the tensor-core variants at ragged TMA-readable shapes
    for m, k, n in ((70, 136, 200), (300, 64, 72), (5, 200, 136), (16, 72, 520)):
        x, wg, wu = randn(m, k), randn(k, n, scale=k ** -0.5), randn(k, n, scale=k ** -0.5)
        run(f"check aligned M{m} K{k} N{n}", gated, dict(x=x, wg=wg, wu=wu), timed=False,
            flops=0, nbytes=0)
        run(f"check aligned M{m} K{k} N{n} fp32 out", attn_out,
            dict(o=x, wo=wg, residual=randn(m, n)), timed=False, flops=0, nbytes=0,
            out_dtype=torch.float32)
    for m in (130, 6):
        run(f"check narrow aligned M{m} K64 N96/32/32", fusion.fused_qkv_graph(),
            dict(x=randn(m, 64), wq=randn(64, 96), wk=randn(64, 32), wv=randn(64, 32)),
            timed=False, flops=0, nbytes=0)
    Op, Node = fusion.OperandSpec, fusion.Node
    both = fusion.TppGraph("trans_both", (Op("x", "lhs", trans=True), Op("w", "rhs", trans=True),
                                          Op("b", "rowvec")),
                           nodes=(Node("n0", "bias_add", ("acc", "b")), Node("n1", "gelu", ("n0",))))
    for m, k, n in ((304, 136, 200), (16, 256, 520), (2048, 512, 384)):
        run(f"check both transposed M{m} K{k} N{n}", both,
            dict(x=randn(k, m), w=randn(n, k, scale=k ** -0.5), b=randn(n)), timed=False,
            flops=0, nbytes=0)
    for m in (96, 8):
        run(f"check batch (3, 5) shared rhs M{m} K128 N192", gated,
            dict(x=randn(3, 5, m, 128), wg=randn(128, 192), wu=randn(128, 192)), timed=False,
            flops=0, nbytes=0)


# The variant each of K5's tensor-core variants replaced, timed beside it
# on the same operands.
OLD_VARIANT = {"wgmma": "wmma", "wgmma_decode": "wmma", "wgmma_split": "simt"}


def k5_beside(torch, bench, fusion, fused_gemm, label, graph, ops, out_dtype=None):
    """Time K5's planned variant of ``graph`` (without a chained root), a
    lone call and its device time without the host's launch cost
    (``device_ms``), and the variant it replaced (``OLD_VARIANT``: WMMA for
    bf16 operands, SIMT for fp32 ones) on the same operands, the old one
    also within the tolerance of the new; → the record kept in
    bench.extra["k5_beside"]."""
    g = fusion.simplify_graph(graph)
    kern = fused_gemm.FusedKernel(g)
    feed = {k: v for k, v in ops.items() if k in g.operand_names}
    variant = fused_gemm.variant_of(g, feed)
    rec = {"variant": variant, "ms": time_ms(torch, lambda: kern(feed, out_dtype=out_dtype)),
           "device_ms": device_ms(torch, lambda: kern(feed, out_dtype=out_dtype))}
    old = OLD_VARIANT.get(variant)
    if old:
        new, was = kern(feed, out_dtype=out_dtype), kern(feed, out_dtype=out_dtype, variant=old)
        dtype = "bfloat16" if (out_dtype or new.dtype) == torch.bfloat16 else "float32"
        err, ok = compare(torch, was, new, *TOL[dtype]["gemm"])
        check(ok, f"K5 {label}: the {old} variant differs from {variant} by {err:.3e}")
        rec.update(old_variant=old, old_ms=time_ms(torch, lambda: kern(feed, out_dtype=out_dtype,
                                                                       variant=old)))
    bench.extra.setdefault("k5_beside", {})[label] = rec
    print(f"    beside: {variant} {rec['ms']:.4f} ms [device {rec['device_ms']:.4f}]"
          + (f", the {old} variant it replaced {rec['old_ms']:.4f} ms" if old else ""), flush=True)
    return rec


def _graph_run(torch, fusion, graph, out_dtype=None):
    """(K5's launch, the composed reference path) of ``graph``."""
    return (fusion.compile(graph, path="cuda", out_dtype=out_dtype),
            fusion.compile(graph, path="reference", out_dtype=out_dtype))


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def k5_peak(torch, fusion, fused_gemm, graph, ops):
    """The rate K5's bound takes for ``graph`` on ``ops``: bf16 operands at
    the bf16 rate; an fp32 operand against bf16 ones on wgmma_split at the
    tensor cores' TF32 rate (the same as the hi + lo pieces' two bf16
    products at the bf16 rate); fp32 on SIMT at the fp32 rate."""
    if all(ops[sp.name].dtype == torch.bfloat16 for sp in graph.contraction_operands):
        return "bf16"
    if graph.chained_root() is None:
        g = fusion.simplify_graph(graph)
        if fused_gemm.variant_of(g, {k: v for k, v in ops.items() if k in g.operand_names}) \
                == "wgmma_split":
            return "tf32"
    return "fp32"


def fused_training_cases(torch, bench, fusion, rng):
    """K5's graphs of the fused training path against their plain version
    (the composed reference path) on the card, at minicpm-2b's training
    shapes (B 4 x S 1024, 36 heads of 64, d 2304, d_ff 5760): the chained
    attention (causal, and window 256), its six derived backward graphs
    (each fed the plain version's outputs of the graphs before it; their sum
    beside SDPA's backward), the derived backward graphs of fused_attn_out_res
    and fused_gated_mlp_silu, fused_attn_out with dropout_rng at M 4096 x N
    2304 (keep pattern checked bit for bit, forward and a backward graph's
    regeneration), fused_output_graph(0.1) at N 1024 and 5120 (layernorm
    panels) and its dz graph, an rmsnorm panel, and small fp32 checks
    (ragged, Sq != Skv, one batch axis, a chain of 128).  Each graph without
    a chained root is timed beside the variant it replaced (WMMA for bf16
    operands, SIMT for the fp32 dz of the backward graphs: ``k5_beside``),
    and ragged fp32-operand graphs check wgmma_split at the fp32 tolerance."""
    import torch.nn.functional as F
    from repro_torch.kernels import fused_gemm
    gen = torch.Generator(device="cuda").manual_seed(21)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    def run(kernel, label, graph, ops, *, flops, nbytes, weight=0, timed=True, library=None,
            out_dtype=None, tol=None):
        k5, plain = _graph_run(torch, fusion, graph, out_dtype)
        dts = [ops[sp.name].dtype for sp in graph.contraction_operands]
        tol = tol or ("bfloat16" if (out_dtype or dts[0]) == torch.bfloat16 else "float32")
        chained = graph.chained_root() is not None
        if not chained:
            g = fusion.simplify_graph(graph)
            label += f" [{fused_gemm.variant_of(g, {k: v for k, v in ops.items() if k in g.operand_names})}]"
        got = bench.run(kernel, f"{graph.name} {label}", lambda: k5(**ops), lambda: plain(**ops),
                        library if timed else None, flops=flops, nbytes=nbytes, dtype=tol,
                        tol_kind="gemm", weight=weight, timed=timed,
                        peak=k5_peak(torch, fusion, fused_gemm, graph, ops))
        if timed and not chained:
            k5_beside(torch, bench, fusion, fused_gemm, f"{graph.name} {label}", graph, ops,
                      out_dtype)
        return got

    f32 = torch.float32
    b, h, s, d = 4, 36, 1024, 64
    # q as the strided view of the (B, S, H, D) projection, k and v as the
    # contiguous copies the GQA repeat would give
    q = randn(b, s, h, d).transpose(1, 2)
    k, v, dy = randn(b, h, s, d), randn(b, h, s, d), randn(b, h, s, d)
    causal = fusion.fused_attention_graph(causal=True, scale=d ** -0.5)
    pairs = s * (s + 1) // 2
    run("fused_chain", f"B{b} H{h} S{s} D{d} causal", causal, dict(q=q, k=k, v=v), weight=1,
        flops=4 * b * h * d * pairs, nbytes=_nbytes(q, k, v, dy),
        library=lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    win = fusion.fused_attention_graph(causal=True, window=256, scale=d ** -0.5)
    keep = torch.ones(s, s, dtype=torch.bool, device="cuda").tril().triu(-255)
    run("fused_chain", f"B{b} H{h} S{s} D{d} window 256", win, dict(q=q, k=k, v=v),
        flops=4 * b * h * d * int(keep.sum()), nbytes=_nbytes(q, k, v, dy),
        library=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep))
    del keep
    # the six derived backward graphs, each on the plain version's outputs
    g = {fusion.derive_vjp(causal).graph_role(nm): gr
         for nm, gr in fusion.backward_graphs(causal).items()}
    full = 2 * b * h * s * s * d
    # (checks now: the chained backward kernel replaces them on the path)
    p = run("fused_attention_bwd", "P", g["p"], dict(q=q, k=k), out_dtype=f32,
            flops=full, nbytes=_nbytes(q, k) + 4 * b * h * s * s)
    dp = run("fused_attention_bwd", "dP = dy v^T", g["dp"], dict(dy=dy, v=v),
             out_dtype=f32, flops=full, nbytes=_nbytes(dy, v) + 4 * b * h * s * s)
    dz = run("fused_attention_bwd", "dZ (softmax_grad panel)", g["dz"], dict(q=q, k=k, dp=dp),
             out_dtype=f32, flops=full, nbytes=_nbytes(q, k, dp, dp))
    del dp
    for role, ops in (("dq", dict(dz=dz, k=k)), ("dk", dict(dz=dz, q=q)), ("dv", dict(p=p, dy=dy))):
        run("fused_attention_bwd", role, g[role], ops, out_dtype=f32, flops=full,
            nbytes=_nbytes(*ops.values()) + 4 * b * h * s * d)
    del p, dz
    rows = bench.cases["fused_attention_bwd"][-6:]
    bench.extra["minicpm_six_graphs"] = {"ms": sum(r["ms"] for r in rows),
                                         "bound_ms": sum(r["bound_ms"] for r in rows)}
    del q, k, v, dy

    # the projections' backward graphs at 4096 tokens
    t, ff = b * s, 5760
    dm = h * d
    out_res = fusion.fused_attn_out_graph(True)
    gb = fusion.backward_graphs(out_res)
    o, wo, dyo = randn(t, dm), randn(dm, dm, scale=dm ** -0.5), randn(t, dm)
    run("fused_proj_bwd", "dO = dy wo^T", gb["fused_attn_out_res@bwd_dlhs[o]"],
        dict(dz_acc=dyo, wo=wo), weight=1, out_dtype=f32, flops=2 * t * dm * dm,
        nbytes=_nbytes(dyo, wo) + 4 * t * dm, library=lambda: dyo @ wo.T)
    run("fused_proj_bwd", "dW = o^T dy", gb["fused_attn_out_res@bwd_drhs"],
        dict(o=o, dz_acc=dyo), weight=1, out_dtype=f32, flops=2 * t * dm * dm,
        nbytes=_nbytes(o, dyo) + 4 * dm * dm, library=lambda: o.T @ dyo)
    del o, wo
    gated = fusion.fused_gated_mlp_graph("silu")
    gb = fusion.backward_graphs(gated)
    x, wg, wu, dyg = randn(t, dm), randn(dm, ff, scale=dm ** -0.5), randn(dm, ff, scale=dm ** -0.5), \
        randn(t, ff)
    dz0 = run("fused_proj_bwd", "dz (2 roots)", gb["fused_gated_mlp_silu@bwd_dz0"],
              dict(x=x, wg=wg, wu=wu, dy=dyg), weight=1, out_dtype=f32, flops=4 * t * dm * ff,
              nbytes=_nbytes(x, wg, wu, dyg) + 8 * t * ff,
              library=lambda: x @ torch.cat([wg, wu], 1))
    dzg, dzu = dz0[0], dz0[1]
    run("fused_proj_bwd", "dX (fp32 dz, 2 roots)", gb["fused_gated_mlp_silu@bwd_dlhs[x]"],
        dict(dz_g=dzg, wg=wg, dz_u=dzu, wu=wu), weight=1, out_dtype=f32,
        flops=4 * t * dm * ff, nbytes=_nbytes(dzg, wg, dzu, wu) + 4 * t * dm,
        library=lambda: torch.cat([dzg, dzu], 1) @ torch.cat([wg, wu], 1).float().T)
    run("fused_proj_bwd", "dW (fp32 dz, 2 roots)", gb["fused_gated_mlp_silu@bwd_drhs"],
        dict(x=x, dz_g=dzg, dz_u=dzu), weight=1, out_dtype=f32, flops=4 * t * dm * ff,
        nbytes=_nbytes(x, dzg, dzu) + 8 * dm * ff,
        library=lambda: x.float().T @ torch.cat([dzg, dzu], 1))
    del x, wg, wu, dyg, dz0, dzg, dzu
    # wgmma_split at ragged shapes: fp32 dz against bf16 weights read in
    # place (dX) and bf16 x read transposed (dW), the fp32 tolerance
    for mm, kk, nn in ((100, 200, 72), (256, 40, 136), (9, 128, 64)):
        xs, ws_g, ws_u = randn(mm, nn), randn(nn, kk), randn(nn, kk)
        dz_g, dz_u = randn(mm, kk, dtype=f32), randn(mm, kk, dtype=f32)
        run("fused_proj_bwd", f"check split dX M{mm} K{kk} N{nn}",
            gb["fused_gated_mlp_silu@bwd_dlhs[x]"], dict(dz_g=dz_g, wg=ws_g, dz_u=dz_u, wu=ws_u),
            timed=False, out_dtype=f32, flops=0, nbytes=0)
        run("fused_proj_bwd", f"check split dW M{mm} K{kk} N{nn}",
            gb["fused_gated_mlp_silu@bwd_drhs"], dict(x=xs, dz_g=dz_g, dz_u=dz_u), timed=False,
            out_dtype=f32, flops=0, nbytes=0)
    del xs, ws_g, ws_u, dz_g, dz_u

    # dropout_rng in the kernel: the forward's keep pattern and a backward
    # graph's regeneration, bit for bit, against fusion.rng at M 4096 x N 2304
    rate, salt, seed = 0.15, fusion.library.ATTN_OUT_DROPOUT_SALT, 1234567
    do_res = fusion.fused_attn_out_graph(True, dropout_rate=rate)
    o, wo = randn(t, dm), randn(dm, dm, scale=dm ** -0.5)
    zero = torch.zeros(t, dm, dtype=torch.bfloat16, device="cuda")
    y = run("fused_gemm", f"M{t} N{dm} dropout {rate}", do_res,
            dict(o=o, wo=wo, seed=seed, residual=zero), flops=2 * t * dm * dm,
            nbytes=_nbytes(o, wo, zero, zero), library=lambda: torch.addmm(zero, o, wo))
    keep = rng.keep_mask(seed, salt, (t, dm), rate=rate, device="cuda")
    acc = (o.float() @ wo.float()).abs() > 1e-2
    check(torch.equal((y != 0) & acc, keep & acc),
          "fused_attn_out_do_res: the kernel's keep pattern differs from fusion.rng's")
    bits = fusion.TppGraph.chain("dropout_rng_grad_bits",
                                 [("dropout_rng_grad", ("seed",), {"rate": rate, "salt": salt})],
                                 [("o", "lhs"), ("wo", "rhs"), ("seed", "scalar")])
    yb = run("fused_gemm", f"M{t} N{dm} dropout_rng_grad", bits, dict(o=o, wo=wo, seed=seed),
             flops=2 * t * dm * dm, nbytes=_nbytes(o, wo, zero), timed=False)
    check(torch.equal((yb != 0) & acc, keep & acc),
          "the backward graph's regenerated keep pattern differs from the forward's")
    print(f"  dropout_rng keep pattern, forward and backward graph: equal to fusion.rng's on"
          f" {int(acc.sum())} of {t * dm} elements (|x w| > 1e-2), kept share"
          f" {float(keep.float().mean()):.4f}", flush=True)
    del o, wo, zero, y, yb, acc, keep

    # row panels: Listing 6 at N 1024 and 5120 (layernorm), its dz graph
    # (layernorm_grad, then the regenerated dropout), an rmsnorm panel
    out_g = fusion.fused_output_graph(0.1)
    for kk, n in ((1024, 1024), (1024, 5120)):
        x, w, res = randn(t, kk), randn(kk, n, scale=kk ** -0.5), randn(t, n)
        bias, gamma, beta = randn(n, dtype=f32), randn(n, dtype=f32), randn(n, dtype=f32)
        ops = dict(x=x, w=w, bias=bias, seed=seed, residual=res, gamma=gamma, beta=beta)
        run("fused_gemm", f"M{t} K{kk} N{n}", out_g, ops, flops=2 * t * kk * n,
            nbytes=_nbytes(x, w, res, res))
        if n == 1024:
            dz_g = next(gr for nm, gr in fusion.backward_graphs(out_g).items() if "dz0" in nm)
            dyo = randn(t, n)
            ops = dict(x=x, w=w, bias=bias, seed=seed, residual=res, gamma=gamma, dy=dyo)
            run("fused_gemm", f"M{t} K{kk} N{n} fp32 out", dz_g, ops, out_dtype=f32,
                flops=2 * t * kk * n, nbytes=_nbytes(x, w, res, dyo) + 8 * t * n)
    del x, w, res
    rms = fusion.fused_attn_out_graph(True, "rmsnorm", 1e-6)
    o, wo, res, gamma = randn(t, dm), randn(dm, dm, scale=dm ** -0.5), randn(t, dm), \
        randn(dm, dtype=f32)
    run("fused_gemm", f"M{t} N{dm}", rms, dict(o=o, wo=wo, residual=res, gamma=gamma),
        flops=2 * t * dm * dm, nbytes=_nbytes(o, wo, res, res))
    del o, wo, res

    # a row with every key masked (causal, Sq 2 > Skv 1): the kernel gives
    # 0, as the reference's chained Pallas kernel does; the plain version
    # follows the reference's composed path (a uniform softmax over the
    # masked keys); ROADMAP.md Queue 3
    one = fusion.fused_attention_graph(causal=True, scale=0.5, offset=-1)
    k5, plain = _graph_run(torch, fusion, one)
    qs = torch.arange(8, dtype=f32, device="cuda").reshape(2, 4) / 8
    ks, vs = torch.ones(1, 4, device="cuda"), torch.tensor([[1.0, 2.0, 3.0, 4.0]], device="cuda")
    got, want = k5(q=qs, k=ks, v=vs), plain(q=qs, k=ks, v=vs)
    check(torch.equal(got[0], torch.zeros(4, device="cuda")) and torch.equal(got[1], vs[0])
          and torch.equal(want[0], vs[0]),
          f"fully masked row: kernel {got.tolist()}, plain version {want.tolist()}")
    print(f"  a fully masked row (causal, Sq 2, Skv 1): kernel {got[0].tolist()}, plain version"
          f" {want[0].tolist()} (the reference's Pallas and composed paths differ the same way)",
          flush=True)

    # small fp32 and mixed checks: ragged, Sq < Skv, one batch axis, N2 128
    def qkv(bt, sq, skv, dd, dt=f32):
        return randn(*bt, sq, dd, dtype=dt), randn(*bt, skv, dd, dtype=dt), \
            randn(*bt, skv, dd, dtype=dt)

    for label, bt, sq, skv, dd, win, dt in (
            ("ragged fp32", (2, 3), 100, 100, 24, 7, f32), ("Sq 70 Skv 100 fp32", (3,), 70, 100, 16, 0, f32),
            ("chain 128 bf16", (1, 2), 200, 200, 128, 0, torch.bfloat16)):
        qs, ks, vs = qkv(bt, sq, skv, dd, dt)
        cg = fusion.fused_attention_graph(causal=True, window=win, scale=dd ** -0.5, offset=skv - sq)
        run("fused_chain", f"check {label}", cg, dict(q=qs, k=ks, v=vs), timed=False, flops=0, nbytes=0)
        for role, gr in ((fusion.derive_vjp(cg).graph_role(nm), gr)
                         for nm, gr in fusion.backward_graphs(cg).items()):
            if role == "p":
                pp = run("fused_attention_bwd", f"check {label}", gr, dict(q=qs, k=ks), timed=False,
                         out_dtype=f32, flops=0, nbytes=0)
            elif role == "dq":
                run("fused_attention_bwd", f"check {label}", gr, dict(dz=pp, k=ks), timed=False,
                    out_dtype=f32, flops=0, nbytes=0)
            elif role == "dk":
                run("fused_attention_bwd", f"check {label}", gr, dict(dz=pp, q=qs), timed=False,
                    out_dtype=f32, flops=0, nbytes=0)
    for gname, graph in (("out", fusion.fused_output_graph(0.1)),
                         ("rms", fusion.fused_attn_out_graph(True, "rmsnorm", 1e-6))):
        m, kk, n = 77, 50, 130
        shape = {"lhs": (m, kk), "rhs": (kk, n), "tile": (m, n), "rowvec": (n,)}
        ops = {sp.name: seed if sp.kind == "scalar" else randn(*shape[sp.kind], dtype=f32)
               for sp in graph.operands}
        run("fused_gemm", f"check fp32 M{m} K{kk} N{n}", graph, ops, timed=False, flops=0, nbytes=0)
        ops["dy"] = randn(m, n, dtype=f32)
        for nm, gr in fusion.backward_graphs(graph).items():
            if "@bwd_dz" in nm:
                run("fused_proj_bwd", f"check fp32 {gname}", gr,
                    {sp.name: ops[sp.name] for sp in gr.operands}, timed=False, out_dtype=f32,
                    flops=0, nbytes=0)


def k13_graphs(fusion):
    """The graphs phase 3's K13 cases launch besides the paths' own: the
    pre-norm half of Listing 6 (bias and dropout, whose keep pattern shows
    in its output) and a dropout after a row panel's close (full-row
    tiles)."""
    salt = fusion.library.OUTPUT_DROPOUT_SALT
    return [fusion.TppGraph.chain("fused_output_keep",
                                  [("bias_add", ("bias",), {}),
                                   ("dropout_rng", ("seed",), {"rate": 0.1, "salt": salt})],
                                  [("x", "lhs"), ("w", "rhs"), ("bias", "rowvec"),
                                   ("seed", "scalar")]),
            fusion.TppGraph.chain("softmax_dropout",
                                  [("softmax", (), {}),
                                   ("dropout_rng", ("seed",), {"rate": 0.2, "salt": 7})],
                                  [("x", "lhs"), ("w", "rhs"), ("seed", "scalar")])]


def _k5_counted(torch, fused_gemm, fn):
    """``fn()`` with K5's counters read around it: → (output, launches,
    K13 launches)."""
    fused_gemm.LAUNCHES = fused_gemm.HW_PRNG_LAUNCHES = 0
    out = fn()
    torch.cuda.synchronize()
    return out, fused_gemm.LAUNCHES, fused_gemm.HW_PRNG_LAUNCHES


def fused_spec_cases(torch, bench, fusion, fused_gemm, rng):
    """K5 scheduled from spec strings (``fusion.compile(graph,
    spec_string=, tiles=, block_steps=)``), each output bitwise equal to
    the fixed grid's and each case one K5 launch: llama2-13b's
    fused_gated_mlp_silu at prefill (M 2048, 5120 -> 13824) on K5's CTA
    tiles, bert-large's Listing 6 (fused_output_graph(0.1), M 4096, K 1024,
    N 1024: row panels) and minicpm-2b's chained attention (B 4, H 36, S
    1024, D 64, causal) on pick_tiles' blocks; then the counter draw of
    fused_attn_out_do_res (M 4096, N 2304) under three (spec, tiles) pairs,
    its keep bits equal to ``fusion.rng.tile_bits``'s."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(bf16)

    times = {}

    def by_spec(kernel, label, graph, ops, cases, *, flops, nbytes, library):
        fixed = fusion.compile(graph, path="cuda")
        base = fixed(**ops)
        plain = fusion.compile(graph, path="reference")
        times[f"{label} fixed grid"] = time_ms(torch, lambda: fixed(**ops))
        for spec, tiles, steps in cases:
            k5 = fusion.compile(graph, path="cuda", spec_string=spec, tiles=tiles, block_steps=steps)
            name = f"{label} spec {spec} {steps or ''} tiles {tiles or 'pick_tiles'}"
            got, n, _ = _k5_counted(torch, fused_gemm, lambda: k5(**ops))
            check(n == 1, f"K5 {name}: {n} launches, want 1")
            check(torch.equal(got, base), f"K5 under {name} differs from the fixed grid")
            bench.run(kernel, name, lambda: k5(**ops), lambda: plain(**ops), library,
                      flops=flops, nbytes=nbytes, dtype="bfloat16", tol_kind="gemm")
            times[name] = bench.cases[kernel][-1]["ms"]

    m, d, ff = 2048, 5120, 13824
    x, wg, wu = randn(m, d), randn(d, ff, scale=d ** -0.5), randn(d, ff, scale=d ** -0.5)
    by_spec("fused_gemm", f"fused_gated_mlp_silu M{m} {d}->{ff}", fusion.fused_gated_mlp_graph("silu"),
            dict(x=x, wg=wg, wu=wu),
            [(spec, (128, 32, 64), steps) for spec, steps in
             (("bca", None), ("cba", None), ("BCa", None), ("bcba", {"b": (4,)}))],
            flops=4 * m * d * ff, nbytes=2 * (m * d + 2 * d * ff + m * ff),
            library=lambda: torch.nn.functional.silu(x @ wg) * (x @ wu))
    del x, wg, wu
    m, k, n = 4096, 1024, 1024
    x, w, res = randn(m, k), randn(k, n, scale=k ** -0.5), randn(m, n)
    bias, gamma, beta = (torch.randn(n, generator=gen, device="cuda") for _ in range(3))
    by_spec("fused_gemm", f"fused_output_graph(0.1) M{m} K{k} N{n}", fusion.fused_output_graph(0.1),
            dict(x=x, w=w, bias=bias, seed=99, residual=res, gamma=gamma, beta=beta),
            [("bca", None, None), ("bcca", None, {"c": (2,)}), ("bbca", None, {"b": (2,)})],
            flops=2 * m * k * n, nbytes=_nbytes(x, w, res, res), library=None)
    del x, w, res
    b, h, sq, hd = 4, 36, 1024, 64
    q = randn(b, sq, h, hd).transpose(1, 2)
    kk, v = randn(b, h, sq, hd), randn(b, h, sq, hd)
    by_spec("fused_chain", f"attention B{b} H{h} S{sq} D{hd} causal",
            fusion.fused_attention_graph(causal=True, scale=hd ** -0.5), dict(q=q, k=kk, v=v),
            [("bca", None, None), ("bbca", None, {"b": (2,)})],
            flops=4 * b * h * hd * sq * (sq + 1) // 2, nbytes=_nbytes(q, kk, v, v),
            library=lambda: torch.nn.functional.scaled_dot_product_attention(q, kk, v, is_causal=True))
    del q, kk, v

    rate, salt, seed = 0.15, fusion.library.ATTN_OUT_DROPOUT_SALT, 4242
    t, dm = 4096, 2304
    g = fusion.fused_attn_out_graph(True, dropout_rate=rate)
    o, wo = randn(t, dm), randn(dm, dm, scale=dm ** -0.5)
    zero = torch.zeros(t, dm, dtype=bf16, device="cuda")
    keep = rng.keep_mask(seed, salt, (t, dm), rate=rate, device="cuda")
    acc = (o.float() @ wo.float()).abs() > 1e-2
    for spec, tiles, steps in (("bca", None, None), ("cba", (128, 32, 128), None),
                               ("bcca", (256, 64, 128), {"c": (2,)})):
        y = fusion.compile(g, path="cuda", spec_string=spec, tiles=tiles, block_steps=steps)(
            o=o, wo=wo, seed=seed, residual=zero)
        check(torch.equal((y != 0) & acc, keep & acc),
              f"the counter draw under {spec} {tiles} differs from fusion.rng.tile_bits")
    print(f"  counter draw of fused_attn_out_do_res M{t} N{dm} under bca, cba (128,32,128) and"
          f" bcca (256,64,128): keep bits equal to fusion.rng.tile_bits on {int(acc.sum())} of"
          f" {t * dm} elements", flush=True)
    bench.extra["k5_by_spec_ms"] = times
    print("    K5 by spec (bitwise equal to the fixed grid): "
          + "; ".join(f"{k} {v:.4f}" for k, v in times.items()) + " ms", flush=True)


def _sigma(p, n):
    return math.sqrt(p * (1 - p) / n)


def _rate0(fusion, graph):
    """``graph`` with its dropout_rng nodes at rate 0 (simplified away)."""
    import dataclasses
    nodes = tuple(dataclasses.replace(nd, attrs=tuple((a, 0.0 if a == "rate" else v)
                                                      for a, v in nd.attrs))
                  if nd.op == "dropout_rng" else nd for nd in graph.nodes)
    return dataclasses.replace(graph, name=f"{graph.name}_rate0", nodes=nodes)


def hw_prng_cases(torch, bench, fusion, fused_gemm, rng):
    """K13: K5 under ``hw_prng=True`` against its plain version on the card
    (``fusion.plain_version``, the composed reference drawing
    ``rng.hw_bits`` per plan tile) under pick_tiles' plan and one other
    tile choice: minicpm-2b's fused_attn_out_do_res (M 4096, K 2304 -> N
    2304, rate 0.15), bert-large's fused_output_graph(0.1) at phase 10b's
    batch (M 8192, K 4096 -> N 1024; its keep pattern through its pre-norm
    half, ``k13_graphs``), and small ragged, fp32 and post-reduce checks.
    Each: the keep pattern bit for bit, the keep share within 5 sigma of
    1 - rate, agreement with the counter pattern within 5 sigma of p^2 +
    (1 - p)^2, the same bits in two runs, one K13 launch a call; timed
    beside the counter path, the graph at rate 0 and F.dropout on the
    output."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(41)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}

    def randn(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    def draw_checks(label, keep, counter_keep, rate):
        n = keep.numel()
        p = 1 - rate
        share = float(keep.float().mean())
        check(abs(share - p) <= 5 * _sigma(p, n),
              f"K13 {label}: keep share {share:.5f}, want {p} within 5 sigma")
        agree = float((keep == counter_keep).float().mean())
        q = p * p + (1 - p) ** 2
        check(abs(agree - q) <= 5 * _sigma(q, n),
              f"K13 {label}: agreement with the counter pattern {agree:.5f}, want {q:.5f}")
        return share, agree

    def case(label, graph, ops, tiles, *, rate, salt, seed, shape, keep_graph=None,
             keep_ops=None, weight=0, timed=True, flops=0, nbytes=0, dtype="bfloat16",
             rate0=None, full_row=False):
        hw = fusion.compile(graph, path="cuda", hw_prng=True, tiles=tiles)
        plain = fusion.plain_version(graph, hw_prng=True, tiles=tiles)
        y, n, n_hw = _k5_counted(torch, fused_gemm, lambda: hw(**ops))
        check(n == 1 and n_hw == 1, f"K13 {label}: K5 {n} and K13 {n_hw} launches, want 1 each")
        check(torch.equal(y, hw(**ops)), f"K13 {label}: two runs gave different bits")
        gp = fusion.lowering.plan_graph(fusion.simplify_graph(graph), *shape, ops[graph.roots[0].lhs].dtype,
                                        tiles=tiles)
        m, n_cols = shape[0], shape[2]
        tile = (gp.prng_tile[0], n_cols) if full_row else gp.prng_tile
        keep = rng.hw_bits(seed, salt, (m, n_cols), tile, device="cuda") < rng.keep_threshold(rate)
        counter_keep = rng.keep_mask(seed, salt, (m, n_cols), rate=rate, device="cuda")
        # the keep pattern: in the output, or through the graph's pre-norm
        # half, where the value before the draw is not near 0
        kg, kops = (keep_graph, keep_ops) if keep_graph is not None else (graph, ops)
        ky = fusion.compile(kg, path="cuda", hw_prng=True, tiles=tiles)(**kops)
        kp = fusion.plain_version(kg, hw_prng=True, tiles=tiles)(**kops)
        before = fusion.plain_version(_rate0(fusion, kg))(**kops).float().abs()
        live = before > 1e-3 * float(before.max())
        check(torch.equal((ky != 0) & live, keep & live) and torch.equal((kp != 0) & live, keep & live),
              f"K13 {label}: the kernel's keep pattern differs from rng.hw_bits on tile {tile}")
        share, agree = draw_checks(label, keep, counter_keep, rate)
        bench.run("hw_tile_bits", f"{label} tiles {tiles or 'pick_tiles'}", lambda: hw(**ops),
                  lambda: plain(**ops), (lambda: F.dropout(y, rate)) if timed else None,
                  flops=flops, nbytes=nbytes, dtype=dtype, tol_kind="gemm", weight=weight,
                  timed=timed)
        row = {"prng_tile": list(tile), "keep_share": share, "agreement_with_counter": agree,
               "live_elements_checked": int(live.sum())}
        if timed:
            counter = fusion.compile(graph, path="cuda")
            zero_rate = fusion.compile(rate0, path="cuda")
            row.update(hw_ms=bench.cases["hw_tile_bits"][-1]["ms"],
                       counter_ms=time_ms(torch, lambda: counter(**ops)),
                       rate0_ms=time_ms(torch, lambda: zero_rate(**ops)),
                       dropout_library_ms=bench.cases["hw_tile_bits"][-1]["library_ms"],
                       bound_ms=bench.cases["hw_tile_bits"][-1]["bound_ms"])
            print(f"    {label} tiles {tiles or 'pick_tiles'} (K13 tile {tuple(tile)}): hw"
                  f" {row['hw_ms']:.4f} ms, counter {row['counter_ms']:.4f} ms, rate 0"
                  f" {row['rate0_ms']:.4f} ms, F.dropout {row['dropout_library_ms']:.4f} ms, bound"
                  f" {row['bound_ms']:.4f} ms; keep share {share:.5f}, agreement {agree:.5f}", flush=True)
        rows[f"{label} tiles {tiles or 'pick_tiles'}"] = row

    # minicpm-2b's attention output projection with dropout 0.15
    rate, salt, seed = 0.15, fusion.library.ATTN_OUT_DROPOUT_SALT, 777
    t, dm = 4096, 2304
    g = fusion.fused_attn_out_graph(True, dropout_rate=rate)
    o, wo, res = randn(t, dm), randn(dm, dm, scale=dm ** -0.5), randn(t, dm)
    zero = torch.zeros(t, dm, dtype=bf16, device="cuda")
    for tiles, weight in ((None, 1), ((128, 64, 128), 0)):
        case(f"fused_attn_out_do_res M{t} N{dm}", g, dict(o=o, wo=wo, seed=seed, residual=res),
             tiles, rate=rate, salt=salt, seed=seed, shape=(t, dm, dm), weight=weight,
             keep_ops=dict(o=o, wo=wo, seed=seed, residual=zero), keep_graph=g,
             flops=2 * t * dm * dm, nbytes=_nbytes(o, wo, res, res), rate0=_rate0(fusion, g))
    del o, wo, res, zero
    # bert-large's Listing 6 at phase 10b's batch (16 x 512 tokens), Bert-Output
    rate, salt = 0.1, fusion.library.OUTPUT_DROPOUT_SALT
    m, k, n = 8192, 4096, 1024
    x, w, res = randn(m, k), randn(k, n, scale=k ** -0.5), randn(m, n)
    bias, gamma, beta = (torch.randn(n, generator=gen, device="cuda") for _ in range(3))
    ops = dict(x=x, w=w, bias=bias, seed=seed, residual=res, gamma=gamma, beta=beta)
    for tiles, weight in ((None, 1), ((256, 64, 512), 0)):
        case(f"fused_output_graph(0.1) M{m} K{k} N{n}", fusion.fused_output_graph(rate), ops, tiles,
             rate=rate, salt=salt, seed=seed, shape=(m, k, n), weight=weight,
             keep_graph=k13_graphs(fusion)[0], keep_ops=dict(x=x, w=w, bias=bias, seed=seed),
             flops=2 * m * k * n, nbytes=_nbytes(x, w, res, res),
             rate0=_rate0(fusion, fusion.fused_output_graph(rate)))
    del x, w, res, ops
    # small checks: ragged fp32 (pick_tiles' odd blocks), bf16 on K5's SIMT
    # tile, and a draw after a row panel's close (full-row tiles)
    for label, graph, (m, k, n), dt, tiles, full in (
            ("check fp32 ragged", g, (77, 50, 130), f32, None, False),
            ("check fp32", g, (96, 64, 192), f32, (32, 32, 64), False),
            ("check bf16 M16", g, (16, 64, 256), bf16, (16, 32, 64), False),
            ("check post-reduce", k13_graphs(fusion)[1], (128, 64, 384), f32, (32, 32, 128), True)):
        ops = {"o" if "o" in graph.operand_names else "x": randn(m, k, dtype=dt),
               "wo" if "wo" in graph.operand_names else "w": randn(k, n, dtype=dt), "seed": seed}
        if "residual" in graph.operand_names:
            ops["residual"] = torch.zeros(m, n, dtype=dt, device="cuda")
        r = 0.2 if full else 0.15
        s = 7 if full else fusion.library.ATTN_OUT_DROPOUT_SALT
        case(f"{label} M{m} K{k} N{n}", graph, ops, tiles, rate=r, salt=s, seed=seed,
             shape=(m, k, n), timed=False, full_row=full,
             dtype="bfloat16" if dt == bf16 else "float32")
    bench.extra["k13"] = rows


def _to_cuda(tree):
    """A copy of a parameter tree (dicts and lists of tensors) on the GPU,
    each leaf a leaf that requires a gradient where the original does."""
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cuda(v) for v in tree]
    return tree.detach().cuda().requires_grad_(tree.requires_grad)


def reduced_models(torch, counters, *, fused=False):
    """Reduced fp32 configs: CUDA kernels against CPU plain versions; with
    ``fused``, ``use_fusion=True`` (K5 must launch on the card)."""
    import dataclasses
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    from repro_torch.serve.decode import ServeConfig, generate_loop

    rtol, atol = MODEL_TOL
    for arch in ("llama2_13b", "gptj_6b", "minicpm_2b", "falcon_mamba_7b"):
        cfg = dataclasses.replace(get_config(arch).reduced(), use_fusion=fused)
        counters.reset()
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
        k5, k8 = counters.read()["fused_gemm"], counters.read()["mamba_scan"]
        print(f"  {arch}-reduced fp32{' use_fusion' if fused else ''}: max logit diff {worst:.3e}"
              f" (rtol {rtol}, atol {atol}), greedy tokens equal: {same}, engine tokens and"
              f" statuses equal: {engine_same} ({len(served['cuda'][0])} requests);"
              f" K5 launches {k5}, K8 launches {k8}", flush=True)
        check((k5 > 0) == fused, f"{arch} reduced: K5 launched {k5} times (use_fusion={fused})")
        check((k8 > 0) == ("mamba" in cfg.layer_pattern), f"{arch} reduced: K8 launched {k8} times")
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
    k1_on_wgmma(launches, "phase 5 generate_loop")
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
    check(launches["flash_attention_wgmma"] == launches["flash_attention"] == cfg.num_layers,
          f"K2 launched {launches['flash_attention']} times, {launches['flash_attention_wgmma']}"
          f" of them on the bf16 wgmma kernel, in one prefill of {cfg.num_layers} layers")
    result["profile"] = k3_on_split(
        torch, counters, lambda: generate_loop(cfg, params, prompts, new, scfg=scfg), total_ms,
        "phase 5 generate_loop")
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


def gptj_engine(torch, counters):
    """gpt-j-6b at full width and depth (bf16, 28 layers of d 4096, 16 heads
    of 256, random weights from a seed; ~12 GB) through the serving engine:
    8 of phase 6's ragged requests, greedy and sampled, on 8 slots with
    ``validate()`` after every step and every launch counter set to 0 just
    before and read just after (K4, at head dim 256, once a layer a decode
    step), then on 3 slots: the tokens must be equal."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm

    cfg = get_config("gptj_6b")
    start = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  init {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, head dim"
          f" {cfg.head_dim}, {torch.cuda.memory_allocated() / 2**30:.2f} GiB of weights in"
          f" {time.perf_counter() - start:.2f} s", flush=True)
    reqs = engine_requests(cfg, n=8)
    counters.reset()
    eng, wall_ms = drain(torch, cfg, params, reqs, num_slots=ENGINE["num_slots"])
    launches = counters.read()
    k1_on_wgmma(launches, "phase 7f gpt-j-6b engine")
    steps = eng.decode_steps
    tokens = {uid: eng.collect(uid) for uid in range(len(reqs))}
    for uid, r in enumerate(reqs):
        check(eng.status(uid).value == "finished", f"gpt-j request {uid} ended {eng.status(uid).value}")
        check(len(tokens[uid]) == len(r["prompt"]) + r["max_new"],
              f"gpt-j request {uid}: {len(tokens[uid])} tokens")
    check(launches["paged_decode"] == cfg.num_layers * steps,
          f"K4 launched {launches['paged_decode']} times in {steps} decode steps of"
          f" {cfg.num_layers} layers")
    generated = eng.tokens_generated
    del eng
    eng3, wall3_ms = drain(torch, cfg, params, reqs, num_slots=3)
    tokens3 = {uid: eng3.collect(uid) for uid in range(len(reqs))}
    del eng3
    diff = first_difference(torch, cfg, params, tokens, tokens3)
    result = {"requests": len(reqs), "decode_steps": steps, "generated_tokens": generated,
              "drain_ms": wall_ms, "tokens_per_s": generated / (wall_ms / 1e3),
              "slots3_drain_ms": wall3_ms, "schedule_invariant": diff is None,
              "launches": launches}
    print(f"  drain of {len(reqs)} requests on {ENGINE['num_slots']} slots: {wall_ms:.1f} ms,"
          f" {generated} tokens, {steps} decode steps, validate() clean; K4 at D {cfg.head_dim}"
          f" launched {launches['paged_decode']} times; on 3 slots {wall3_ms:.1f} ms, tokens"
          f" equal: {diff is None}" + (f"; first difference {diff}" if diff else ""), flush=True)
    check(diff is None, f"gpt-j-6b tokens depend on the number of slots: {diff}")
    short = [dict(r, max_new=4) for r in reqs[:2]]
    result["k4_profile"] = k4_on_split(
        torch, counters, lambda: drain(torch, cfg, params, short, num_slots=ENGINE["num_slots"],
                                       validate=False), "phase 7f gpt-j-6b engine, 2 requests")
    del params
    torch.cuda.empty_cache()
    return result


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
    pools = lm.init_paged_cache(cfg, b, num_pages, ps, device="cuda")
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
    pools = lm.init_paged_cache(cfg, b, b * per_slot, ps, device="cuda")
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
    k1_on_wgmma(launches, "phase 6 engine")
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
    check(launches["flash_attention_wgmma"] == launches["flash_attention"],
          f"K2 launched {launches['flash_attention']} times in the engine's drain, only"
          f" {launches['flash_attention_wgmma']} of them on the bf16 wgmma kernel")
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
    result["profile"] = on_kernel(
        torch, counters, lambda: drain(torch, cfg, params, wave, num_slots=ENGINE["num_slots"],
                                       validate=False), wave_ms,
        "phase 6 engine", "paged_decode", "paged_decode_split_kernel")
    result["profile"]["requests"] = len(wave)
    return result


def fused_full_width(torch, counters, peaks, cfg, params, unfused):
    """llama2-13b at full width and depth with ``use_fusion=True`` on phase
    5's parameters: K5 launches 2 per layer per prefill and per decode step
    (fused_attn_out_res, fused_gated_mlp_silu) and K1 4 per layer plus the
    logits; timed through generate_loop beside the unfused path (``unfused``:
    phase 5's numbers, and one more unfused run in this phase)."""
    import dataclasses
    from repro_torch.models import lm
    from repro_torch.serve.decode import ServeConfig, generate_loop

    fcfg = dataclasses.replace(cfg, use_fusion=True)
    L = cfg.num_layers
    batch, prompt_len, new = 4, 512, 16
    gen = torch.Generator(device="cuda").manual_seed(1)     # phase 5's prompts
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device="cuda")

    caches = lm.init_cache(fcfg, batch, prompt_len + 1, device="cuda")
    counters.reset()
    logits, caches = lm.prefill(fcfg, params, caches, {"tokens": prompts})
    per_prefill = counters.read()
    counters.reset()
    step_logits, _ = lm.decode_step(fcfg, params, caches, logits.argmax(-1), prompt_len)
    per_step = counters.read()
    for what, n in (("prefill", per_prefill), ("decode step", per_step)):
        check(n["fused_gemm"] == 2 * L, f"K5 launched {n['fused_gemm']} times in one {what}, want {2 * L}")
        check(n["gemm"] == 4 * L + 1, f"K1 launched {n['gemm']} times in one {what}, want {4 * L + 1}")
    check(logits.shape == (batch, cfg.padded_vocab), f"fused prefill logits {tuple(logits.shape)}")
    check(bool(lm.finite_logits(logits).all()) and bool(lm.finite_logits(step_logits).all()),
          "fused logits are not finite")
    del caches
    ucaches = lm.init_cache(cfg, batch, prompt_len + 1, device="cuda")
    ulogits, _ = lm.prefill(cfg, params, ucaches, {"tokens": prompts})
    logit_diff = float((logits - ulogits).abs().max())
    del ucaches, ulogits, logits, step_logits

    scfg = ServeConfig(max_seq=prompt_len + new)

    def serve(c, n):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = generate_loop(c, params, prompts, n, scfg=scfg)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - start) * 1e3

    _, prefill_ms = serve(fcfg, 1)
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    out, total_ms = serve(fcfg, new)          # the fused main path
    launches = counters.read()
    k1_on_wgmma(launches, "phase 7 fused generate_loop")
    k5_on_wgmma(launches, "phase 7 fused generate_loop")
    by_graph = dict(counters.fused_gemm.GRAPH_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steps = launches["flash_decode"] // L
    check(steps == new - 1, f"{steps} decode steps, want {new - 1}")
    check(by_graph == {"fused_attn_out_res": L * (1 + steps), "fused_gated_mlp_silu": L * (1 + steps)},
          f"K5 launches by graph {by_graph} in 1 prefill + {steps} decode steps")
    check(out.shape == (batch, prompt_len + new) and torch.equal(out[:, :prompt_len], prompts),
          "fused generate_loop output")
    uout, unfused_total_ms = serve(cfg, new)
    agree = int((out[:, prompt_len:] == uout[:, prompt_len:]).sum())
    decode_ms = (total_ms - prefill_ms) / (new - 1)
    result = {"prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms, "total_ms": total_ms,
              "tokens_per_s": batch * new / (total_ms / 1e3),
              "max_memory_allocated_gib": peak / 2**30, "launches": launches,
              "launches_by_graph": by_graph, "launches_per_prefill": per_prefill, "launches_per_decode_step": per_step,
              "unfused_prefill_ms": unfused["prefill_ms"],
              "unfused_decode_ms_per_token": unfused["decode_ms_per_token"],
              "unfused_total_ms_this_phase": unfused_total_ms,
              "fused_vs_unfused_last_logits_max_abs": logit_diff,
              "greedy_tokens_agreeing": agree, "greedy_tokens": batch * new}
    result.update(serving_bounds(cfg, params, batch, prompt_len, new, peaks))
    print(f"  use_fusion generate_loop B{batch} P{prompt_len} +{new}: prefill {prefill_ms:.1f} ms"
          f" (unfused {unfused['prefill_ms']:.1f}, bound {result['prefill_bound_ms']:.2f}),"
          f" decode {decode_ms:.2f} ms/token (unfused {unfused['decode_ms_per_token']:.2f}, bound"
          f" {result['decode_bound_ms_per_token']:.2f}); total {total_ms:.1f} ms, unfused in this"
          f" phase {unfused_total_ms:.1f} ms; peak {peak / 2**30:.2f} GiB; launches {launches},"
          f" K5 by graph {by_graph};"
          f" per prefill {per_prefill}; per decode step {per_step}", flush=True)
    print(f"  fused vs unfused last-token prefill logits: max abs diff {logit_diff:.4f};"
          f" greedy tokens agreeing {agree} of {batch * new} (information, not a gate)", flush=True)
    result["profile"] = k3_on_split(
        torch, counters, lambda: generate_loop(fcfg, params, prompts, new, scfg=scfg), total_ms,
        "phase 7 fused generate_loop")
    return result


def fused_engine(torch, counters, cfg, params):
    """A short engine drain with ``use_fusion=True`` (phase 6's first 8
    requests) on 8 slots and on 3: every request finishes, ``validate()``
    stays clean, K5 launches 2 per layer per prefill and decode step, and
    the tokens are equal."""
    import dataclasses
    from repro_torch.obs.trace import Tracer

    fcfg = dataclasses.replace(cfg, use_fusion=True)
    L = cfg.num_layers
    reqs = engine_requests(cfg)[:8]
    tracer = Tracer()
    counters.reset()
    eng, wall_ms = drain(torch, fcfg, params, reqs, num_slots=ENGINE["num_slots"], tracer=tracer)
    launches = counters.read()                  # the fused engine's run
    k1_on_wgmma(launches, "phase 7 fused engine")
    k5_on_wgmma(launches, "phase 7 fused engine")
    prefills = sum(1 for sp in tracer.spans() if sp.name == "engine.prefill")
    steps = eng.decode_steps
    tokens = {uid: eng.collect(uid) for uid in range(len(reqs))}
    for uid, r in enumerate(reqs):
        check(eng.status(uid).value == "finished", f"fused request {uid} ended {eng.status(uid).value}")
        check(len(tokens[uid]) == len(r["prompt"]) + r["max_new"], f"fused request {uid}: length")
    check(launches["fused_gemm"] == 2 * L * (prefills + steps),
          f"K5 launched {launches['fused_gemm']} times in {prefills} prefills + {steps} decode steps")
    check(launches["paged_decode"] == L * steps, f"K4 launched {launches['paged_decode']} times")
    generated = eng.tokens_generated
    del eng
    torch.cuda.empty_cache()
    eng3, wall3_ms = drain(torch, fcfg, params, reqs, num_slots=3)
    tokens3 = {uid: eng3.collect(uid) for uid in range(len(reqs))}
    del eng3
    torch.cuda.empty_cache()
    diff = first_difference(torch, fcfg, params, tokens, tokens3)
    result = {"requests": len(reqs), "generated_tokens": generated, "drain_ms": wall_ms,
              "tokens_per_s": generated / (wall_ms / 1e3), "prefills": prefills,
              "decode_steps": steps, "slots3_drain_ms": wall3_ms,
              "schedule_invariant": diff is None, "launches": launches}
    print(f"  use_fusion drain of {len(reqs)} requests on {ENGINE['num_slots']} slots: {wall_ms:.1f} ms,"
          f" {generated} tokens, {result['tokens_per_s']:.1f} tokens/s, {prefills} prefills,"
          f" {steps} decode steps, launches {launches}; on 3 slots {wall3_ms:.1f} ms, tokens"
          f" equal: {diff is None}" + (f"; first difference {diff}" if diff else ""), flush=True)
    check(diff is None, f"fused tokens depend on the number of slots: {diff}")
    short = [dict(r, max_new=4) for r in reqs[:2]]
    result["k4_profile"] = k4_on_split(
        torch, counters, lambda: drain(torch, fcfg, params, short, num_slots=ENGINE["num_slots"],
                                       validate=False), "phase 7 fused engine, 2 requests")
    return result


def mamba_bounds(cfg, params, batch, prompt_len, peaks):
    """Least card time for a falcon-mamba prefill of ``batch`` rows of
    ``prompt_len`` tokens and for one decode step of ``batch`` rows, each
    the larger of its bytes over the HBM rate and its operations over the
    bf16 peak.  Bytes: every weight once (the embedding only in the rows it
    gathers) and each row's conv and SSM state written (prefill) or read
    and written (decode).  Operations: the four projections, the scan
    (6 N + 3 per channel-step) and the last token's logits."""
    layer_w = [t for layer in params["layers"] for sub in layer.values() for t in sub.values()]
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    w_bytes = sum(t.numel() * t.element_size() for t in layer_w + [head]) \
        + sum(t.numel() * t.element_size() for t in params["final_norm"].values())
    proj = sum(t.numel() for layer in params["layers"] for k, t in layer["mamba"].items()
               if k.startswith("w_"))
    L, di, n = cfg.num_layers, cfg.d_inner, cfg.ssm_state
    state_row = L * di * (4 * n + (cfg.ssm_conv - 1) * params["embed"].element_size())
    scan = L * di * (6 * n + 3)
    logits = 2 * batch * cfg.d_model * cfg.padded_vocab

    def bound(flops, nbytes):
        return max(flops / peaks["bf16"], nbytes / peaks["hbm"]) * 1e3

    tokens = batch * prompt_len
    return {"prefill_bound_ms": bound(2 * tokens * proj + tokens * scan + logits,
                                      w_bytes + batch * state_row),
            "decode_bound_ms_per_token": bound(2 * batch * proj + batch * scan + logits,
                                               w_bytes + 2 * batch * state_row)}


def mamba_full_width(torch, counters, peaks):
    """falcon-mamba-7b at full width and depth (bf16, random weights from a
    seed): launches per prefill and decode step (K8 once a layer, on the
    ``prefill`` kernel for a prompt and the ``decode`` kernel for a step, K1
    four times a layer plus the logits, nothing else; one profiled prefill
    and one profiled decode step show every K8 launch on its variant's
    device kernel), a bucket-padded prefill against the unpadded one,
    ``generate_loop`` (B 4, prompt 512, 16 new tokens) timed beside its
    bounds, and the
    engine (8 slots, phase 6's 16 ragged requests, greedy and sampled) with
    a 3-slot drain that must give the same tokens."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import mamba_scan as scan
    from repro_torch.models import lm
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve.decode import ServeConfig, generate_loop

    cfg = get_config("falcon_mamba_7b")
    L = cfg.num_layers
    start = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  init {cfg.name}: {L} layers, d_model {cfg.d_model}, d_inner {cfg.d_inner},"
          f" state {cfg.ssm_state}, {cfg.dtype}, {torch.cuda.memory_allocated() / 2**30:.2f} GiB"
          f" of weights in {time.perf_counter() - start:.2f} s", flush=True)

    def launched(n, what, prefills, steps):
        calls = prefills + steps
        want = {"gemm": (4 * L + 1) * calls, "mamba_scan": L * calls}
        for name, count in n.items():
            check(name in SUB_COUNTS or count == want.get(name, 0),
                  f"{name} launched {count} times in {what}, want {want.get(name, 0)}")
        k1_on_wgmma(n, what)
        # K8 on its plan's variant: prefill for L > 1, decode for a step
        check(n["mamba_scan_prefill"] == L * prefills and n["mamba_scan_decode"] == L * steps,
              f"K8 in {what}: {n['mamba_scan_prefill']} prefill and {n['mamba_scan_decode']}"
              f" decode launches, want {L * prefills} and {L * steps}")

    batch, prompt_len, new = 4, 512, 16
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device="cuda")
    caches = lm.init_cache(cfg, batch, prompt_len + 1, device="cuda")
    counters.reset()
    logits, caches = lm.prefill(cfg, params, caches, {"tokens": prompts})
    per_prefill = counters.read()
    counters.reset()
    step_logits, _ = lm.decode_step(cfg, params, caches, logits.argmax(-1), prompt_len)
    per_step = counters.read()
    launched(per_prefill, "one prefill", 1, 0)
    launched(per_step, "one decode step", 0, 1)
    check(logits.shape == (batch, cfg.padded_vocab), f"prefill logits {tuple(logits.shape)}")
    check(bool(lm.finite_logits(logits).all()) and bool(lm.finite_logits(step_logits).all()),
          "falcon-mamba logits are not finite")

    def prefill_run():
        return lm.prefill(cfg, params, caches, {"tokens": prompts})

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_run()
    torch.cuda.synchronize()
    prefill_profile = on_kernel(torch, counters, prefill_run, (time.perf_counter() - t0) * 1e3,
                                "phase 7b prefill", "mamba_scan", scan.KERNEL_NAMES["prefill"])
    del caches, logits, step_logits

    # a prompt of 300 tokens, alone and right-padded to the engine's bucket of 512
    plen, bucket = 300, 512
    one = prompts[:1, :plen]
    dense = lm.init_cache(cfg, 1, plen + 1, device="cuda")
    want, dense = lm.prefill(cfg, params, dense, {"tokens": one})
    padded = lm.init_cache(cfg, 1, bucket, device="cuda")
    tokens = torch.cat([one, torch.zeros(1, bucket - plen, dtype=one.dtype, device="cuda")], 1)
    got, padded = lm.prefill(cfg, params, padded, {"tokens": tokens},
                             logit_index=torch.full((1,), plen - 1, device="cuda"))
    errs = [float((got - want).abs().max())]
    ok = torch.allclose(got, want, rtol=BF16_LOGITS[0], atol=BF16_LOGITS[1])
    state_err = max(float((a[k].float() - b[k].float()).abs().max())
                    for a, b in zip(dense, padded) for k in a)
    tok = want.argmax(-1)
    want, _ = lm.decode_step(cfg, params, dense, tok, plen)
    got, _ = lm.decode_step(cfg, params, padded, tok, plen)
    errs.append(float((got - want).abs().max()))
    ok = ok and torch.allclose(got, want, rtol=BF16_LOGITS[0], atol=BF16_LOGITS[1])
    print(f"  padded ({bucket}) vs unpadded ({plen}) prefill and one decode step: max abs logit"
          f" diff {errs[0]:.3e}, {errs[1]:.3e} (rtol {BF16_LOGITS[0]}, atol {BF16_LOGITS[1]});"
          f" max abs state diff {state_err:.3e}", flush=True)
    check(ok and all(math.isfinite(e) for e in errs), "padded prefill differs from unpadded")
    del dense, padded

    scfg = ServeConfig(max_seq=prompt_len + new)

    def serve(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate_loop(cfg, params, prompts, n, scfg=scfg)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    _, prefill_ms = serve(1)          # prefill and the first token
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    out, total_ms = serve(new)        # the main path
    launches = counters.read()
    k1_on_wgmma(launches, "phase 7b generate_loop")
    peak = torch.cuda.max_memory_allocated()
    launched(launches, f"generate_loop (1 prefill, {new - 1} decode steps)", 1, new - 1)
    check(out.shape == (batch, prompt_len + new), f"generate_loop output {tuple(out.shape)}")
    check(torch.equal(out[:, :prompt_len], prompts), "generate_loop changed the prompt")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "token outside the vocabulary")
    decode_ms = (total_ms - prefill_ms) / (new - 1)
    result = {"prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
              "total_ms": total_ms, "tokens_per_s": batch * new / (total_ms / 1e3),
              "decode_tokens_per_s": batch / (decode_ms / 1e3),
              "max_memory_allocated_gib": peak / 2**30, "launches": launches,
              "launches_per_prefill": per_prefill, "launches_per_decode_step": per_step,
              "padded_vs_unpadded_max_abs": max(errs), "padded_vs_unpadded_state_max_abs": state_err}
    result.update(mamba_bounds(cfg, params, batch, prompt_len, peaks))
    print(f"  generate_loop B{batch} P{prompt_len} +{new}: prefill {prefill_ms:.1f} ms"
          f" (bound {result['prefill_bound_ms']:.2f}), decode {decode_ms:.2f} ms/token"
          f" (bound {result['decode_bound_ms_per_token']:.2f}),"
          f" {result['tokens_per_s']:.1f} tokens/s overall,"
          f" peak {peak / 2**30:.2f} GiB, launches {launches}", flush=True)
    caches = lm.init_cache(cfg, batch, prompt_len + 1, device="cuda")
    tok = lm.prefill(cfg, params, caches, {"tokens": prompts})[0].argmax(-1)

    def step():
        return lm.decode_step(cfg, params, caches, tok, prompt_len)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    result["decode_step_ms"] = (time.perf_counter() - t0) * 1e3
    result["profile"] = on_kernel(torch, counters, step, result["decode_step_ms"],
                                  "phase 7b decode step", "mamba_scan", scan.KERNEL_NAMES["decode"])
    result["prefill_profile"] = prefill_profile
    del caches

    reqs = engine_requests(cfg)
    tracer = Tracer()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    eng, wall_ms = drain(torch, cfg, params, reqs, num_slots=ENGINE["num_slots"], tracer=tracer)
    elaunches = counters.read()                 # the engine's run
    k1_on_wgmma(elaunches, "phase 7b engine")
    epeak = torch.cuda.max_memory_allocated()
    spans = tracer.spans()
    prefill_spans = [sp.duration * 1e3 for sp in spans if sp.name == "engine.prefill"]
    steps = eng.decode_steps
    launched(elaunches, f"the engine drain ({len(prefill_spans)} prefills, {steps} decode steps)",
             len(prefill_spans), steps)
    tokens = {uid: eng.collect(uid) for uid in range(len(reqs))}
    for uid, r in enumerate(reqs):
        check(eng.status(uid).value == "finished", f"request {uid} ended {eng.status(uid).value}")
        check(len(tokens[uid]) == len(r["prompt"]) + r["max_new"],
              f"request {uid}: {len(tokens[uid])} tokens, want {len(r['prompt']) + r['max_new']}")
        check(tokens[uid][:len(r["prompt"])] == r["prompt"], f"request {uid}: prompt changed")
        check(all(0 <= t < cfg.vocab_size for t in tokens[uid]),
              f"request {uid}: token outside the vocabulary")
    decode_span_ms = sum(sp.duration for sp in spans if sp.name == "engine.decode_segment") * 1e3
    ttft = sorted((m["first_token"] - m["submitted"]) * 1e3 for m in eng.metrics.values())
    generated = eng.tokens_generated
    bound = mamba_bounds(cfg, params, ENGINE["num_slots"], 1, peaks)
    engine = {"requests": len(reqs), "slots": ENGINE["num_slots"], "generated_tokens": generated,
              "drain_ms": wall_ms, "tokens_per_s": generated / (wall_ms / 1e3),
              "ttft_ms_median": statistics.median(ttft),
              "ttft_ms_p90": statistics.quantiles(ttft, n=10)[8],
              "prefill_ms_median": statistics.median(prefill_spans), "prefills": len(prefill_spans),
              "decode_steps": steps, "decode_ms_per_step": decode_span_ms / steps,
              "decode_step_bound_ms": bound["decode_bound_ms_per_token"],
              "max_memory_allocated_gib": epeak / 2**30, "launches": elaunches,
              "stats": eng.stats}
    print(f"  drain of {len(reqs)} requests on {ENGINE['num_slots']} slots: {wall_ms:.1f} ms,"
          f" {generated} tokens, {engine['tokens_per_s']:.1f} tokens/s; TTFT median"
          f" {engine['ttft_ms_median']:.1f} ms, p90 {engine['ttft_ms_p90']:.1f} ms; prefill median"
          f" {engine['prefill_ms_median']:.1f} ms; {steps} decode steps at"
          f" {engine['decode_ms_per_step']:.2f} ms (bound {engine['decode_step_bound_ms']:.2f} ms);"
          f" peak {epeak / 2**30:.2f} GiB; launches {elaunches}", flush=True)
    del eng
    eng3, wall3_ms = drain(torch, cfg, params, reqs, num_slots=3)
    tokens3 = {uid: eng3.collect(uid) for uid in range(len(reqs))}
    del eng3
    diff = first_difference(torch, cfg, params, tokens, tokens3)
    engine["slots3_drain_ms"] = wall3_ms
    engine["schedule_invariant"] = diff is None
    print(f"  drain on 3 slots: {wall3_ms:.1f} ms; tokens equal to the 8-slot drain: {diff is None}"
          + (f"; first difference {diff}" if diff else ""), flush=True)
    check(diff is None, f"falcon-mamba tokens depend on the number of slots: {diff}")
    result["engine"] = engine
    del params
    torch.cuda.empty_cache()
    return result


def sparse_ffn(torch, counters, peaks, spmm, fo):
    """Phase 7c, the paper's Block-SpMM path at bert-large's widths (what
    ``examples/sparse_inference.py`` and ``benchmarks/bench_e2e.py``'s
    sparse row do): both FFN weights magnitude-pruned to 80 % block sparsity
    in 8x8 blocks and stored once in 64x8 blocks (the wgmma variant's work
    list, ``densify_to_bcsr(w, 64, 8)``), each linear ``ops.block_spmm(
    blocks, rid, cid, x.T, nrows_b=out // 64).T`` on 4096 tokens (B 8 x S
    512) in bf16, up, gelu,
    down, with every counter set to 0 just before and read just after: one
    K10 launch a call and nothing else; each output against the dense
    product of its pruned weight; times of the dense ``torch.matmul``, K1
    on the same dense weight, the work list at 0 % and at 80 %, each beside
    its bound.  Then Listing 6 at bert's Bert-Output layer through
    ``kernels.fused_output`` and qwen3-moe's expert product through
    ``ops.grouped_matmul``, each counted the same way."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels import brgemm, ops

    bf16 = torch.bfloat16
    tokens, sparsity = 8 * 512, 0.8
    gen = torch.Generator(device="cuda").manual_seed(14)
    x = torch.randn(tokens, 1024, generator=gen, device="cuda").to(bf16)
    layers = {}
    for name, w in zip(("W_up", "W_down"), bert_ffn_weights()):
        w_sp = block_prune(w, sparsity)
        nz = np.abs(w_sp.reshape(w.shape[0] // 8, 8, w.shape[1] // 8, 8)).sum((1, 3)) != 0
        blocks, rid, cid = spmm.densify_to_bcsr(w_sp, spmm.WGMMA_ROWS, 8)
        blocks0, rid0, cid0 = spmm.densify_to_bcsr(w, spmm.WGMMA_ROWS, 8)
        layers[name] = {"sparse": (blocks.to(bf16), rid, cid), "full": (blocks0.to(bf16), rid0, cid0),
                        "dense": torch.from_numpy(w_sp).cuda().to(bf16), "out": w.shape[0],
                        "sparsity": float(1 - nz.mean()), "items": int(nz.sum()), "items_0": nz.size}

    def linear(layer, inp, which="sparse"):
        blocks, rid, cid = layer[which]
        return ops.block_spmm(blocks, rid, cid, inp.T, nrows_b=layer["out"] // spmm.WGMMA_ROWS).T

    # the path: up, gelu, down
    counters.reset()
    up = linear(layers["W_up"], x)
    h = F.gelu(up, approximate="tanh")
    y = linear(layers["W_down"], h)
    torch.cuda.synchronize()
    launches = counters.read()
    check(launches["block_spmm"] == 2 and kernel_total(launches) == 2,
          f"the sparse FFN launched {launches}, want K10 twice and nothing else")
    check(launches["block_spmm_wgmma"] == 2,
          f"K10's launches by variant in the sparse FFN: {launches['block_spmm_wgmma']} wgmma,"
          f" {launches['block_spmm_wmma']} wmma, {launches['block_spmm_simt']} simt")
    print(f"  the sparse FFN: K10 launches {launches['block_spmm']}, on wgmma"
          f" {launches['block_spmm_wgmma']}", flush=True)
    check(y.shape == (tokens, 1024) and bool(torch.isfinite(y).all()), "sparse FFN output not finite")
    result = {"tokens": tokens, "launches": launches, "layers": {}}
    rtol, atol = TOL["bfloat16"]["gemm"]
    for name, inp, got in (("W_up", x, up), ("W_down", h, y)):
        layer = layers[name]
        counters.reset()
        linear(layer, inp)
        per_call = counters.read()["block_spmm"]
        check(per_call == 1, f"{name}: K10 launched {per_call} times in one call")
        want = inp.float() @ layer["dense"].float().T
        err, ok = compare(torch, got, want, rtol, atol)
        check(ok, f"{name}: the sparse product differs from the dense pruned one by {err:.3e}")
        out, k = layer["dense"].shape
        # the bounds count the pruned 8x8 blocks, not the 64x8 ones' zeros
        nnzb, nnzb0 = layer["items"], layer["items_0"]

        def bound(items, dense=False):
            flops = 2 * (out * k if dense else items * 64) * tokens
            nbytes = 2 * ((out * k if dense else items * 64) + k * tokens + out * tokens) \
                + (0 if dense else 8 * items)
            return max(flops / peaks["bf16"], nbytes / peaks["hbm"]) * 1e3
        dense_w = layer["dense"]
        row = {"sparsity": layer["sparsity"], "nnzb": nnzb, "nnzb_at_0": nnzb0,
               "blocks_64x8": layer["sparse"][0].shape[0], "max_abs_err": err,
               "dense_torch_matmul_ms": time_ms(torch, lambda: torch.matmul(inp, dense_w.T)),
               "dense_k1_ms": time_ms(torch, lambda: brgemm.matmul(inp, dense_w.T)),
               "work_list_0_ms": time_ms(torch, lambda: linear(layer, inp, "full")),
               "work_list_ms": time_ms(torch, lambda: linear(layer, inp)),
               "dense_bound_ms": bound(0, dense=True), "work_list_0_bound_ms": bound(nnzb0),
               "work_list_bound_ms": bound(nnzb)}
        row["speedup_vs_0"] = row["work_list_0_ms"] / row["work_list_ms"]
        row["speedup_vs_dense"] = row["dense_torch_matmul_ms"] / row["work_list_ms"]
        result["layers"][name] = row
        print(f"  {name} ({out}x{k}, block sparsity {layer['sparsity']:.1%}, {nnzb} of {nnzb0} 8x8"
              f" blocks in {row['blocks_64x8']} 64x8 ones) on {tokens} tokens: max err {err:.3e} (rtol {rtol}, atol {atol});"
              f" dense torch.matmul {row['dense_torch_matmul_ms']:.4f} ms (bound"
              f" {row['dense_bound_ms']:.4f}), K1 dense {row['dense_k1_ms']:.4f} ms, work list at 0 %"
              f" {row['work_list_0_ms']:.4f} ms (bound {row['work_list_0_bound_ms']:.4f}), at 80 %"
              f" {row['work_list_ms']:.4f} ms (bound {row['work_list_bound_ms']:.4f});"
              f" {row['speedup_vs_0']:.2f}x of 0 % (ideal {1 / (1 - sparsity):.2f}x),"
              f" {row['speedup_vs_dense']:.2f}x of dense", flush=True)
    del layers, x, up, h, y

    # Listing 6 at bert-large's Bert-Output layer, through its entry point
    m, k, n = tokens, 4096, 1024
    xo = torch.randn(m, k, generator=gen, device="cuda").to(bf16)
    wo = (torch.randn(k, n, generator=gen, device="cuda") / math.sqrt(k)).to(bf16)
    res = torch.randn(m, n, generator=gen, device="cuda").to(bf16)
    bias, gamma, beta = (torch.randn(n, generator=gen, device="cuda") for _ in range(3))
    keep = torch.rand(m, n, generator=gen, device="cuda") > 0.1
    counters.reset()
    yo = fo.fused_output(xo, wo, bias, res, gamma, beta, keep_mask=keep, dropout_rate=0.1)
    torch.cuda.synchronize()
    result["listing6_launches"] = counters.read()
    check(result["listing6_launches"]["fused_output"] == 1 and bool(torch.isfinite(yo).all()),
          f"Listing 6: launches {result['listing6_launches']}, finite {bool(torch.isfinite(yo).all())}")
    del xo, wo, res, keep, yo

    # qwen3-moe's expert up projection through ops.grouped_matmul
    t, d, f, e, bm = 4096, 4096, 1536, 128, 64
    xg = torch.randn(t, d, generator=gen, device="cuda").to(bf16)
    wg = (torch.randn(e, d, f, generator=gen, device="cuda") / math.sqrt(d)).to(bf16)
    gid = torch.sort(torch.randint(0, e, (t // bm,), generator=gen, device="cuda"))[0].to(torch.int32)
    counters.reset()
    yg = ops.grouped_matmul(xg, gid, wg)
    torch.cuda.synchronize()
    result["grouped_launches"] = counters.read()
    check(result["grouped_launches"]["grouped_matmul"] == 1
          and result["grouped_launches"]["grouped_matmul_wgmma"] == 1
          and bool(torch.isfinite(yg).all()),
          f"grouped experts: launches {result['grouped_launches']}, want one K9 launch on wgmma")
    print(f"  Listing 6 (M {m}, K {k}, N {n}) launches {result['listing6_launches']['fused_output']}"
          f" K7; qwen3-moe experts (T {t}, d {d}, f {f}, E {e}) launches"
          f" {result['grouped_launches']['grouped_matmul']} K9"
          f" ({result['grouped_launches']['grouped_matmul_wgmma']} on wgmma)", flush=True)
    del xg, wg, gid, yg
    torch.cuda.empty_cache()
    return result


def parlooper(torch, counters, peaks, ops, ref):
    """Phase 7d, PARLOOPER: Listing 1 and Listing 4.  Each run below with
    every counter set to 0 just before and read just after: Listing 1's
    GEMM at 2048^3 (bf16 64x64x64 blocks, k_step 4, "bca") through
    ``ops.brgemm_blocked``, one K11 launch and nothing else, against
    ``brgemm_blocked_ref``; ResNet-50's 1x1 layers at N 32 through
    ``ops.conv2d``, one K12 call and one K1 launch a layer and nothing else,
    against ``conv2d_ref``; its 3x3 layers at N 2 (bench_conv.py's own
    minibatch) through ``ops.conv2d`` on Listing 4's executor
    (``conv2d_parlooper``), which launches no kernel of the port, against
    ``conv2d_ref``, timed beside it and beside cuDNN's bf16 channels-last
    convolution."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(21)
    bf16 = torch.bfloat16
    rtol, atol = TOL["bfloat16"]["gemm"]
    result = {}

    blk, size = 64, 2048
    a = torch.randn(size // blk, size // blk, blk, blk, generator=gen, device="cuda").to(bf16)
    b = (torch.randn(size // blk, size // blk, blk, blk, generator=gen, device="cuda")
         / math.sqrt(size)).to(bf16)
    counters.reset()
    c = ops.brgemm_blocked(a, b, spec_string="bca", k_step=4)
    torch.cuda.synchronize()
    launches = counters.read()
    check(launches["brgemm_blocked"] == 1 and launches["brgemm_blocked_wgmma"] == 1
          and kernel_total(launches) == 1,
          f"Listing 1 launched {launches}, want K11 once on wgmma and nothing else")
    err, ok = compare(torch, c, ref.brgemm_blocked_ref(a, b), rtol, atol)
    check(ok, f"Listing 1: K11 differs from brgemm_blocked_ref by {err:.3e}")
    result["listing1"] = {"shape": [size] * 3, "max_abs_err": err}
    result["listing1_launches"] = launches
    print(f"  Listing 1 {size}^3 bf16 64^3 blocks, k_step 4: launches {launches['brgemm_blocked']} K11;"
          f" max err {err:.3e} (rtol {rtol}, atol {atol})", flush=True)
    del a, b, c

    total = dict.fromkeys(counters.read(), 0)
    result["conv1x1"] = []
    for hw, ci, co, st in RESNET_1X1:
        x, w = conv_operands(torch, gen, 32, hw, ci, co, 1, bf16)
        counters.reset()
        y = ops.conv2d(x, w, stride=st)
        torch.cuda.synchronize()
        launches = counters.read()
        check(launches["conv2d_1x1"] == 1 and launches["gemm"] == 1 and kernel_total(launches) == 2,
              f"1x1 {hw}x{hw} {ci}->{co}: launched {launches}, want K12 once on one K1 and nothing else")
        for name, count in launches.items():
            total[name] += count
        err, ok = compare(torch, y, ref.conv2d_ref(x, w, stride=st), rtol, atol)
        check(ok and y.shape == (32, (hw - 1) // st + 1, (hw - 1) // st + 1, co),
              f"1x1 {hw}x{hw} {ci}->{co}: shape {tuple(y.shape)}, max err {err:.3e}")
        result["conv1x1"].append({"layer": [hw, ci, co, st], "max_abs_err": err})
    result["conv1x1_launches"] = total
    print(f"  ResNet-50 1x1 layers (N 32): launches {total['conv2d_1x1']} K12 on {total['gemm']} K1,"
          f" max err {max(r['max_abs_err'] for r in result['conv1x1']):.3e}", flush=True)

    total = dict.fromkeys(counters.read(), 0)
    result["conv3x3"] = []
    for hw, ch in RESNET_3X3:
        x, w = conv_operands(torch, gen, 2, hw + 2, ch, ch, 3, bf16)
        counters.reset()
        y = ops.conv2d(x, w)
        torch.cuda.synchronize()
        launches = counters.read()
        check(kernel_total(launches) == 0, f"3x3 {hw}x{hw} {ch}: the executor path launched {launches}")
        for name, count in launches.items():
            total[name] += count
        err, ok = compare(torch, y, ref.conv2d_ref(x, w), rtol, atol)
        check(ok and y.shape == (2, hw, hw, ch), f"3x3 {hw}x{hw} {ch}: max err {err:.3e}")
        x_nchw = x.permute(0, 3, 1, 2)
        w_kcrs = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        row = {"layer": [hw, ch], "max_abs_err": err,
               "executor_ms": time_ms(torch, lambda: ops.conv2d(x, w), warmup=1, reps=3),
               "plain_ms": time_ms(torch, lambda: ref.conv2d_ref(x, w), warmup=1, reps=3),
               "cudnn_bf16_ms": time_ms(torch, lambda: F.conv2d(x_nchw, w_kcrs)),
               "bound_ms": max(2 * 2 * hw * hw * 9 * ch * ch / peaks["bf16"],
                               2 * (2 * (hw + 2) ** 2 * ch + 9 * ch * ch + 2 * hw * hw * ch)
                               / peaks["hbm"]) * 1e3}
        result["conv3x3"].append(row)
        print(f"  3x3 {hw}x{hw} {ch}->{ch} N 2 on the executor: {row['executor_ms']:.3f} ms"
              f" (plain {row['plain_ms']:.3f}, cuDNN bf16 {row['cudnn_bf16_ms']:.4f},"
              f" bound {row['bound_ms']:.4f}); max err {err:.3e}; launches 0", flush=True)
    result["conv3x3_launches"] = total
    torch.cuda.empty_cache()
    return result


def scheduled_path(torch, counters, fusion, rng):
    """Phase 7e, K5 scheduled and K13 through the library helpers a user
    calls, each with every counter set to 0 just before and read just
    after: llama2-13b's gated MLP at prefill (M 2048, 5120 -> 13824) through
    ``fused_gated_mlp_apply(..., spec_string="bcba", block_steps={"b":
    (4,)}, tiles=(128, 32, 64))``, one K5 launch and nothing else, bitwise
    equal to the unscheduled call; minicpm-2b's attention output
    projection with dropout 0.15 (M 4096, 2304 -> 2304) through
    ``fused_attn_out_apply(..., hw_prng=True, vjp=False)``, one K5 launch
    that draws from K13 and nothing else, its output finite, of the
    expected shape and within the bf16 tolerance of K13's plain version
    on the card."""
    gen = torch.Generator(device="cuda").manual_seed(51)
    bf16 = torch.bfloat16
    rtol, atol = TOL["bfloat16"]["gemm"]
    result, total = {}, dict.fromkeys(counters.read(), 0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(bf16)

    m, d, ff = 2048, 5120, 13824
    x, wg, wu = randn(m, d), randn(d, ff, scale=d ** -0.5), randn(d, ff, scale=d ** -0.5)
    sched = dict(spec_string="bcba", block_steps={"b": (4,)}, tiles=(128, 32, 64))
    counters.reset()
    y = fusion.fused_gated_mlp_apply(x, wg, wu, vjp=False, **sched)
    torch.cuda.synchronize()
    launches = counters.read()
    check(launches["fused_gemm"] == 1 and kernel_total(launches) == 1,
          f"the scheduled gated MLP launched {launches}, want K5 once and nothing else")
    check(torch.equal(y, fusion.fused_gated_mlp_apply(x, wg, wu, vjp=False)),
          "the scheduled gated MLP differs from the fixed grid")
    for name, count in launches.items():
        total[name] += count
    result["gated_mlp"] = {"shape": [m, d, ff], **sched, "launches": launches}
    print(f"  fused_gated_mlp_apply M{m} {d}->{ff} under bcba {{b:(4,)}} tiles (128, 32, 64):"
          f" launches {launches['fused_gemm']} K5, bitwise equal to the fixed grid", flush=True)
    del x, wg, wu, y

    t, dm, rate, seed = 4096, 2304, 0.15, 2024
    o, wo, res = randn(t, dm), randn(dm, dm, scale=dm ** -0.5), randn(t, dm)
    counters.reset()
    y = fusion.fused_attn_out_apply(o, wo, residual=res, dropout_rate=rate, dropout_seed=seed,
                                    hw_prng=True, vjp=False)
    torch.cuda.synchronize()
    launches = counters.read()
    check(launches["fused_gemm"] == 1 and launches["hw_tile_bits"] == 1
          and kernel_total(launches) == 2,
          f"hw_prng fused_attn_out_apply launched {launches}, want K5 once drawing from K13")
    g = fusion.fused_attn_out_graph(True, dropout_rate=rate)
    want = fusion.plain_version(g, hw_prng=True)(o=o, wo=wo, seed=seed, residual=res)
    err, ok = compare(torch, y, want, rtol, atol)
    check(ok and y.shape == (t, dm), f"hw_prng fused_attn_out_apply: shape {tuple(y.shape)},"
                                     f" max err {err:.3e} against K13's plain version")
    for name, count in launches.items():
        total[name] += count
    result["attn_out_hw_prng"] = {"shape": [t, dm, dm], "rate": rate, "max_abs_err": err,
                                  "launches": launches}
    result["launches"] = total
    k5_on_wgmma(total, "phase 7e")
    print(f"  fused_attn_out_apply M{t} {dm}->{dm} dropout {rate} hw_prng: launches"
          f" {launches['fused_gemm']} K5, {launches['hw_tile_bits']} K13; max err {err:.3e}"
          f" against K13's plain version (rtol {rtol}, atol {atol})", flush=True)
    return result


# Kernel names as the profiler reports them → the port's kernel.  K1's
# launches that read a transposed operand are kernels of their own names;
# K5's generated kernels go by template: fused_gemm (a pointwise epilogue,
# and wgmma_split's pre-pass), fused_panel (a row panel), fused_chain (a
# chained root: the SIMT kernel, or the forward mainloop of
# csrc/attention_fwd.cuh on a generated epilogue, which K2 instantiates on
# K2Epi).
KERNEL_OF = {"gemm_bf16_wgmma": "gemm", "gemm_bf16_wgmma_decode": "gemm",
             "gemm_bf16_wmma": "gemm", "gemm_f32_simt": "gemm",
             "gemm_transposed_bf16_wgmma": "gemm_transposed",
             "gemm_transposed_bf16_wgmma_decode": "gemm_transposed",
             "gemm_transposed_bf16_wmma": "gemm_transposed",
             "gemm_transposed_f32_simt": "gemm_transposed",
             "flash_attention_kernel": "flash_attention",
             "attention_fwd_wgmma_kernel": "fused_chain",
             "flash_decode_split_kernel": "flash_decode",
             "paged_decode_split_kernel": "paged_decode",
             "fused_gemm_bf16_wgmma": "fused_gemm", "fused_gemm_bf16_wgmma_decode": "fused_gemm",
             "fg_split_bf16": "fused_gemm",
             "fused_gemm_bf16_wmma": "fused_gemm", "fused_gemm_f32_simt": "fused_gemm",
             "fused_panel_bf16_wgmma": "fused_panel",
             "fused_panel_bf16_wmma": "fused_panel", "fused_panel_f32_simt": "fused_panel",
             "fused_chain_f32_simt": "fused_chain", "mamba_scan_prefill_kernel": "mamba_scan",
             "mamba_scan_decode_kernel": "mamba_scan",
             "block_spmm_bf16_wgmma": "block_spmm",
             "block_spmm_bf16_wmma": "block_spmm", "block_spmm_f32_simt": "block_spmm",
             "grouped_matmul_bf16_wgmma": "grouped_matmul",
             "grouped_matmul_bf16_wmma": "grouped_matmul",
             "grouped_matmul_f32_simt": "grouped_matmul", "fused_output_kernel": "fused_output",
             "brgemm_blocked_bf16_wgmma": "brgemm_blocked",
             "brgemm_blocked_bf16_wmma": "brgemm_blocked",
             "brgemm_blocked_simt": "brgemm_blocked"}


def kernel_of(name):
    """The port's kernel that a profiled device kernel belongs to: the
    first word of its demangled name that is one of the port's kernel
    names; the attention backward's mainloop (namespace attn_bwd) by its
    epilogue, K6's or a generated one, and its stats pass apart; the
    forward mainloop (namespace attn_fwd) on K2's epilogue is K2."""
    words = re.findall(r"\w+", name)
    if "attn_fwd" in words and "K2Epi" in words:
        return "flash_attention"
    if "attn_bwd" in words:
        return ("flash_attention_bwd" if "K6Epi" in words else "fused_attention_bwd"
                if "Epi" in words else "attention_bwd_stats")
    return next((KERNEL_OF[w] for w in words if w in KERNEL_OF), "other")


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
    by_kernel, ranges, names = {}, {}, {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0:
            continue
        if ev.key in RANGES:     # a named range's device span, not a kernel
            ranges[ev.key] = ev.self_device_time_total / 1e3
            continue
        name = kernel_of(ev.key)
        ms, count = by_kernel.get(name, (0.0, 0))
        by_kernel[name] = (ms + ev.self_device_time_total / 1e3, count + ev.count)
        # the device kernel by the word kernel_of read it by
        word = next((w for w in re.findall(r"\w+", ev.key) if w in KERNEL_OF), ev.key[:60])
        names.setdefault(name, {})
        names[name][word] = names[name].get(word, 0) + ev.count
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms if busy_ms else None,
           "by_kernel": {k: {"ms": ms, "launches": n} for k, (ms, n) in
                         sorted(by_kernel.items(), key=lambda kv: -kv[1][0])},
           "ranges_ms": ranges, "device_names": names}
    print(f"  profile: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms"
          + "".join(f"; {k} {v['ms']:.1f} ms / {v['launches']}" for k, v in out["by_kernel"].items())
          + "".join(f"; range {k} spans {v:.1f} ms on the device" for k, v in ranges.items()),
          flush=True)
    return out


def k5_kind(graph_name):
    """The kernels line's entry that a K5 launch of ``graph_name`` counts
    under: the chained attention, its six derived backward graphs, the
    other derived backward graphs, or the forward graphs (fused_gemm)."""
    if graph_name.startswith("fused_attention"):
        return "fused_attention_bwd" if "@bwd" in graph_name else "fused_chain"
    return "fused_proj_bwd" if "@bwd" in graph_name else "fused_gemm"


def k5_kinds(by_graph):
    out = dict.fromkeys(("fused_gemm", "fused_chain", "fused_attention_bwd", "fused_proj_bwd"), 0)
    for name, n in by_graph.items():
        out[k5_kind(name)] += n
    return out


class Counters:
    """Reads and resets the kernel wrappers' launch counters."""

    def __init__(self, brgemm, fa, fused_gemm, scan, spmm, fo, conv):
        self.brgemm, self.fa, self.fused_gemm, self.scan = brgemm, fa, fused_gemm, scan
        self.spmm, self.fo, self.conv = spmm, fo, conv

    def reset(self):
        self.brgemm.LAUNCHES = 0
        self.brgemm.TRANSPOSED_LAUNCHES = 0
        self.brgemm.GEMM_WGMMA_LAUNCHES = 0
        self.brgemm.GEMM_WGMMA_DECODE_LAUNCHES = 0
        self.brgemm.GEMM_WMMA_LAUNCHES = 0
        self.brgemm.GEMM_SIMT_LAUNCHES = 0
        self.brgemm.BLOCKED_LAUNCHES = 0
        self.brgemm.BLOCKED_WGMMA_LAUNCHES = 0
        self.brgemm.BLOCKED_WMMA_LAUNCHES = 0
        self.brgemm.BLOCKED_SIMT_LAUNCHES = 0
        self.conv.LAUNCHES = 0
        self.fa.ATTENTION_LAUNCHES = 0
        self.fa.ATTENTION_WGMMA_LAUNCHES = 0
        self.fa.BACKWARD_LAUNCHES = 0
        self.fa.ATTENTION_BWD_WGMMA_LAUNCHES = 0
        self.fa.DECODE_LAUNCHES = 0
        self.fa.PAGED_DECODE_LAUNCHES = 0
        self.fused_gemm.LAUNCHES = 0
        self.fused_gemm.GRAPH_LAUNCHES.clear()
        self.fused_gemm.HW_PRNG_LAUNCHES = 0
        self.fused_gemm.CHAIN_WGMMA_LAUNCHES = 0
        self.fused_gemm.CHAIN_BWD_WGMMA_LAUNCHES = 0
        for counter in self.fused_gemm.VARIANT_COUNTERS.values():
            setattr(self.fused_gemm, counter, 0)
        self.scan.SCAN_LAUNCHES = 0
        self.scan.SCAN_PREFILL_LAUNCHES = 0
        self.scan.SCAN_DECODE_LAUNCHES = 0
        self.spmm.SPMM_LAUNCHES = 0
        for counter in self.spmm.SPMM_COUNTERS.values():
            setattr(self.spmm, counter, 0)
        self.spmm.GROUPED_LAUNCHES = 0
        for counter in self.spmm.GROUPED_COUNTERS.values():
            setattr(self.spmm, counter, 0)
        self.fo.LAUNCHES = 0

    def read(self):
        return {"gemm": self.brgemm.LAUNCHES - self.brgemm.TRANSPOSED_LAUNCHES,
                "gemm_transposed": self.brgemm.TRANSPOSED_LAUNCHES,
                # K1's launches (plain and transposed) by variant (not kernel
                # rows of their own)
                "gemm_wgmma": self.brgemm.GEMM_WGMMA_LAUNCHES,
                "gemm_wgmma_decode": self.brgemm.GEMM_WGMMA_DECODE_LAUNCHES,
                "gemm_wmma": self.brgemm.GEMM_WMMA_LAUNCHES,
                "gemm_simt": self.brgemm.GEMM_SIMT_LAUNCHES,
                "flash_attention": self.fa.ATTENTION_LAUNCHES,
                # K2's bf16 kernel among them (not a kernel row of its own)
                "flash_attention_wgmma": self.fa.ATTENTION_WGMMA_LAUNCHES,
                "flash_attention_bwd": self.fa.BACKWARD_LAUNCHES,
                # K6's launches on the tensor cores among them
                "flash_attention_bwd_wgmma": self.fa.ATTENTION_BWD_WGMMA_LAUNCHES,
                "flash_decode": self.fa.DECODE_LAUNCHES,
                "paged_decode": self.fa.PAGED_DECODE_LAUNCHES,
                **k5_kinds(self.fused_gemm.GRAPH_LAUNCHES),
                # the chained forwards and backwards on the tensor cores
                # among them (not kernel rows of their own)
                "fused_chain_wgmma": self.fused_gemm.CHAIN_WGMMA_LAUNCHES,
                "fused_attention_bwd_wgmma": self.fused_gemm.CHAIN_BWD_WGMMA_LAUNCHES,
                # the launches of K5's graphs without a chained root by
                # variant (not kernel rows of their own)
                **{f"fused_{v}": getattr(self.fused_gemm, c)
                   for v, c in self.fused_gemm.VARIANT_COUNTERS.items()},
                "mamba_scan": self.scan.SCAN_LAUNCHES,
                # K8's launches by variant (not kernel rows of their own)
                "mamba_scan_prefill": self.scan.SCAN_PREFILL_LAUNCHES,
                "mamba_scan_decode": self.scan.SCAN_DECODE_LAUNCHES,
                "block_spmm": self.spmm.SPMM_LAUNCHES,
                # K10's launches by variant (not kernel rows of their own)
                **{f"block_spmm_{v}": getattr(self.spmm, c)
                   for v, c in self.spmm.SPMM_COUNTERS.items()},
                "grouped_matmul": self.spmm.GROUPED_LAUNCHES,
                # K9's launches by variant (not kernel rows of their own)
                **{f"grouped_matmul_{v}": getattr(self.spmm, c)
                   for v, c in self.spmm.GROUPED_COUNTERS.items()},
                "fused_output": self.fo.LAUNCHES,
                "brgemm_blocked": self.brgemm.BLOCKED_LAUNCHES,
                "brgemm_blocked_wgmma": self.brgemm.BLOCKED_WGMMA_LAUNCHES,
                "conv2d_1x1": self.conv.LAUNCHES,
                "hw_tile_bits": self.fused_gemm.HW_PRNG_LAUNCHES}


# Counters.read's keys that split one kernel's launches (by variant, or
# those on the tensor cores), not kernels of their own
SUB_COUNTS = frozenset({"gemm_wgmma", "gemm_wgmma_decode", "gemm_wmma", "gemm_simt",
                        "flash_attention_wgmma", "flash_attention_bwd_wgmma",
                        "fused_chain_wgmma", "fused_attention_bwd_wgmma",
                        "fused_wgmma", "fused_wgmma_decode", "fused_wgmma_split", "fused_wmma",
                        "fused_simt", "block_spmm_wgmma", "block_spmm_wmma", "block_spmm_simt",
                        "grouped_matmul_wgmma", "grouped_matmul_wmma", "grouped_matmul_simt",
                        "brgemm_blocked_wgmma", "mamba_scan_prefill", "mamba_scan_decode"})


def kernel_total(launches):
    """All kernel launches in a ``Counters.read`` dict, each counted once."""
    return sum(count for name, count in launches.items() if name not in SUB_COUNTS)


def k1_on_wgmma(launches, what):
    """Every K1 launch of a full-width bf16 path on a wgmma variant
    (``wgmma`` or ``wgmma_decode``), none on ``wmma``."""
    k1 = launches["gemm"] + launches["gemm_transposed"]
    on = launches["gemm_wgmma"] + launches["gemm_wgmma_decode"]
    print(f"  {what}: K1 {k1} launches, {launches['gemm_wgmma']} on wgmma,"
          f" {launches['gemm_wgmma_decode']} on wgmma_decode, {launches['gemm_wmma']} on wmma",
          flush=True)
    check(k1 > 0 and on == k1 and launches["gemm_wmma"] == 0,
          f"{what}: K1 launched {k1} times, {on} on the wgmma variants,"
          f" {launches['gemm_wmma']} on wmma")


def k5_on_wgmma(launches, what):
    """Every launch of a K5 graph without a chained root on a full-width
    bf16 path on a wgmma variant (``wgmma``, ``wgmma_decode`` or
    ``wgmma_split``), none on ``wmma`` or ``simt``."""
    on = {v: launches[f"fused_{v}"] for v in ("wgmma", "wgmma_decode", "wgmma_split")}
    off = {v: launches[f"fused_{v}"] for v in ("wmma", "simt")}
    print(f"  {what}: K5 graphs without a chained root by variant {on}, {off}", flush=True)
    check(sum(on.values()) > 0 and not any(off.values()),
          f"{what}: K5's GEMM-rooted launches by variant {on}, {off}")


def on_kernel(torch, counters, run, wall_ms, what, kernel, device_kernel):
    """Profile ``run()`` (``device_breakdown``) with every counter set to 0
    just before: every launch of the port's ``kernel`` in the run on
    ``device_kernel``, one device kernel a call (the profiled launches equal
    the wrapper's count).  → the profile."""
    counters.reset()
    prof = device_breakdown(torch, run, wall_ms)
    calls = counters.read()[kernel]
    names = prof["device_names"].get(kernel, {})
    print(f"  {what}: {kernel} called {calls} times; its device kernels {names}", flush=True)
    check(calls > 0 and names == {device_kernel: calls},
          f"{what}: {kernel} called {calls} times, its device kernels {names}: want every launch"
          f" on {device_kernel}, one a call")
    return prof


def k3_on_split(torch, counters, run, wall_ms, what):
    """Every K3 launch of ``run()`` on the split kernel
    (``flash_decode_split_kernel``), one a call (``on_kernel``)."""
    return on_kernel(torch, counters, run, wall_ms, what, "flash_decode", "flash_decode_split_kernel")


def k4_on_split(torch, counters, run, what):
    """Every K4 launch of ``run()``, a short drain, on the split kernel
    (``paged_decode_split_kernel``), one a call (``on_kernel``, after an
    unprofiled run for the wall time).  → the profile."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3
    return on_kernel(torch, counters, run, wall_ms, what, "paged_decode", "paged_decode_split_kernel")


TRAIN_TOL = 1e-4     # loss and grad norm per step, reduced fp32 configs: CUDA vs CPU


def reduced_training(torch):
    """Reduced fp32 minicpm-2b, gpt-j-6b and bert-large: three ``make_train_step``
    steps on CUDA and on the CPU from the same initial state and batches
    (loss and grad norm within TRAIN_TOL), then 4 trainer steps straight
    against 2 steps, a checkpoint, a restore and 2 more on the card
    (parameters bitwise equal); and the same three steps with
    ``use_fusion=True`` at dropout 0.15 (K5's graphs, forward and derived
    backward, on the card)."""
    import dataclasses
    import tempfile
    from repro_torch.configs.base import get_config
    from repro_torch.data import DataConfig, SyntheticCorpus, to_device
    from repro_torch.optim.adamw import init_state, tree_leaves
    from repro_torch.train import (SimulatedPreemption, TrainConfig, TrainerConfig,
                                   init_train_state, make_train_step, train)

    for arch, fused in (("minicpm_2b", False), ("gptj_6b", False), ("bert_large", False),
                        ("minicpm_2b", True), ("gptj_6b", True), ("bert_large", True)):
        cfg = get_config(arch).reduced()
        if fused:
            cfg = dataclasses.replace(cfg, use_fusion=True, dropout_rate=0.15)
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
        if fused:
            print(f"  {arch}-reduced fp32 use_fusion, dropout 0.15: 3 steps, CUDA (K5) vs CPU loss"
                  f" and grad norm within {worst:.2e} relative (tol {TRAIN_TOL})", flush=True)
            continue
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
    """(model FLOPs of one step: 6 N tokens plus attention forward and
    backward, over the causal pairs S(S+1)/2 of a causal layer and all S^2
    of a bidirectional one, remat excluded; FLOPs the step does with remat:
    one more forward of every layer and one more of the loss chunks'
    logits)."""
    from repro_torch.models import lm

    L, d, ff, h, hd = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.num_heads, cfg.head_dim
    per_layer = d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd + h * hd * d \
        + (3 if cfg.gated_mlp else 2) * d * ff
    tokens = batch * seq
    pairs = sum(seq * seq if kind == "bidir" else seq * (seq + 1) // 2
                for kind in lm.layer_kinds(cfg))
    attn_fwd = 4 * batch * h * hd * pairs
    logits_fwd = 2 * tokens * d * cfg.padded_vocab
    model = 6 * (L * per_layer + d * cfg.padded_vocab) * tokens + 3 * attn_fwd
    remat = model + 2 * L * per_layer * tokens + attn_fwd + logits_fwd
    return model, remat


def fused_training_launches(fusion, cfg, steps):
    """K5 launches by graph name that ``steps`` fused training steps of
    ``cfg`` must make: per layer and step, each forward graph twice (the
    forward and remat's recompute), each graph its derived backward plan
    runs once, and for the chained attention its one backward kernel
    instead of the six graphs of its plan."""
    from repro_torch.kernels import fused_gemm
    from repro_torch.models import lm

    fwd = [fusion.fused_attn_out_graph(True, dropout_rate=cfg.dropout_rate),
           fusion.fused_gated_mlp_graph(cfg.mlp_activation) if cfg.gated_mlp
           else fusion.fused_mlp_graph(cfg.mlp_activation)]
    want = {}
    for kind in lm.layer_kinds(cfg):
        for g in [attention_graph(fusion, cfg, kind)] + fwd:
            g = fusion.simplify_graph(g)
            want[g.name] = want.get(g.name, 0) + 2 * steps
            # a chained graph's backward is one kernel, not its six graphs
            names = ([g.name + fused_gemm.BACKWARD_SUFFIX] if g.chained_root() is not None
                     else fusion.backward_graphs(g))
            for name in names:
                want[name] = want.get(name, 0) + steps
    return want


def unfused_training_launches(cfg, seq, loss_chunk):
    """Launches one unfused training step of ``cfg`` makes under remat: K1
    twice for each projection of a layer (the forward and remat's
    recompute) and once more for the activated projection's pre-activation
    in the backward, K1 on a transposed operand for each projection's dX and
    dW, K2 twice and K6 once a layer; per loss chunk the logits twice
    (checkpointed), their dX and dW, a tied embedding read transposed."""
    products = 4 + (3 if cfg.gated_mlp else 2)
    chunks = seq // min(loss_chunk, seq)
    head_plain, head_trans = (1, 3) if cfg.tie_embeddings else (2, 2)
    L = cfg.num_layers
    return {"gemm": L * (2 * products + 1) + chunks * head_plain,
            "gemm_transposed": 2 * L * products + chunks * head_trans,
            "flash_attention": 2 * L, "flash_attention_bwd": L}


def train_full_width(torch, counters, peaks, *, arch="minicpm_2b", batch=4, seq=1024,
                     fused=False, unfused=None, layers=None, steps=None, downhill=True):
    """``arch`` at full width and depth (``layers``: the depth cut to that
    many layers): 6 trainer steps (``steps``; fp32 masters, bf16
    compute, B ``batch`` x S ``seq``, loss_chunk 512, remat, AdamW defaults,
    WSD) whose K1, K2 and K6 launches must be what the layer count implies,
    then (with ``downhill``) 3 steps at a small constant learning rate on
    one repeated batch, whose loss must fall at each step, and one profiled
    step.  With ``fused``, ``use_fusion=True`` from the same initial
    parameters and batches (4 trainer steps): K5's launches by graph must
    be what the derived plans imply, every chained forward and backward
    must run on wgmma, and step 1's loss within rtol 2e-2 of ``unfused``
    (the unfused run's result) step 1's."""
    from repro_torch.configs.base import get_config
    from repro_torch.data import DataConfig, SyntheticCorpus, to_device
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import TrainConfig, TrainerConfig, make_train_step, train

    import dataclasses
    from repro_torch import fusion

    cfg = dataclasses.replace(get_config(arch), use_fusion=fused)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    steps = steps or (4 if fused else 6)
    tcfg = TrainConfig(schedule="wsd", peak_lr=3e-4, warmup_steps=2, total_steps=100,
                       loss_chunk=512, remat=True)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters.reset()
    params, opt, hist = train(cfg, tcfg, dcfg, TrainerConfig(num_steps=steps, log_every=1),
                              seed=0, device="cuda")
    launches = counters.read()                    # the main path's run
    k1_on_wgmma(launches, f"training {arch}" + (" fused" if fused else ""))
    by_graph = dict(counters.fused_gemm.GRAPH_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in tree_leaves(params))
    check(all(math.isfinite(x) for x in hist["loss"] + hist["grad_norm"]),
          f"non-finite loss or grad norm: {hist['loss']}, {hist['grad_norm']}")
    if fused:
        k5_on_wgmma(launches, f"training {arch} fused")
        want = fused_training_launches(fusion, cfg, steps)
        check(by_graph == want, f"K5 launches by graph {by_graph}, want {want}")
        for name in ("fused_gemm", "fused_chain", "fused_attention_bwd", "fused_proj_bwd"):
            check(launches[name] > 0, f"K5's {name} graphs were not launched by fused training")
        check(launches["flash_attention"] == 0 and launches["flash_attention_bwd"] == 0,
              f"K2 or K6 ran on the fused path: {launches}")
        six = {g: n for g, n in by_graph.items()
               if any(g.endswith(f"@bwd_{r}") for r in ("p", "dp", "dz", "dq", "dk", "dv"))}
        check(not six, f"the chained attention's six derived graphs ran on the card: {six}")
        for kind in ("fused_chain", "fused_attention_bwd"):
            check(launches[f"{kind}_wgmma"] == launches[kind],
                  f"{launches[f'{kind}_wgmma']} of {launches[kind]} {kind} launches ran on wgmma")
        print(f"  chained attention at D {cfg.head_dim}: {launches['fused_chain_wgmma']} forward and"
              f" {launches['fused_attention_bwd_wgmma']} backward launches, all on wgmma", flush=True)
        rel = abs(hist["loss"][0] - unfused["loss"][0]) / abs(unfused["loss"][0])
        print(f"  step 1 loss {hist['loss'][0]:.6f} fused against {unfused['loss'][0]:.6f} unfused"
              f" (phase 9): {rel:.2e} relative (tol 2e-2)", flush=True)
        check(rel <= 2e-2, f"fused step 1 loss {hist['loss'][0]} against unfused {unfused['loss'][0]}")
    else:
        want = {k: n * steps for k, n in unfused_training_launches(cfg, seq, 512).items()}
        print(f"  launches in {steps} steps {dict((k, launches[k]) for k in want)}, implied by"
              f" {cfg.num_layers} layers: {want}", flush=True)
        for name, n in want.items():
            check(launches[name] == n, f"{name} launched {launches[name]} times in {steps} steps"
                                       f" of {cfg.num_layers} layers, want {n}")
        check(launches["flash_attention_wgmma"] == want["flash_attention"],
              f"K2's bf16 wgmma kernel launched {launches['flash_attention_wgmma']} times in"
              f" {steps} steps, want {want['flash_attention']}")
        check(launches["flash_attention_bwd_wgmma"] == want["flash_attention_bwd"],
              f"K6's wgmma kernels launched {launches['flash_attention_bwd_wgmma']} times in"
              f" {steps} steps, want {want['flash_attention_bwd']}")
    check(launches["gemm_transposed"] > 0, "K1 never read a transposed operand")
    step_ms = statistics.median(hist["step_time"][1:]) * 1e3   # steps 2 .. steps
    tokens = batch * seq
    model_flops, remat_flops = training_model_flops(cfg, batch, seq)
    state_bytes = 7 * 4 * n_params               # AdamW reads p, g, mu, nu; writes p, mu, nu
    # the model's work (remat, a choice that trades FLOPs for memory, beside it)
    bound_ms = max(model_flops / peaks["bf16"], state_bytes / peaks["hbm"]) * 1e3
    remat_bound_ms = max(remat_flops / peaks["bf16"], state_bytes / peaks["hbm"]) * 1e3
    result = {"arch": arch, "layers": cfg.num_layers, "batch": batch, "seq": seq, "steps": steps,
              "step_ms_median": step_ms,
              "step_times_ms": [t * 1e3 for t in hist["step_time"]],
              "sequences_per_s": batch / (step_ms / 1e3), "tokens_per_s": tokens / (step_ms / 1e3),
              "model_flops_per_step": model_flops, "flops_per_step_with_remat": remat_flops,
              "mfu_bf16_peak": model_flops / (step_ms / 1e3) / peaks["bf16"],
              "step_bound_ms": bound_ms, "step_bound_with_remat_ms": remat_bound_ms,
              "parameters": n_params, "max_memory_allocated_gib": peak / 2**30,
              "launches": launches, "loss": hist["loss"], "grad_norm": hist["grad_norm"]}
    if fused:
        result.update({"launches_by_graph": by_graph,
                       "unfused_step_ms_median_2_6": unfused["step_ms_median"],
                       "unfused_max_memory_allocated_gib": unfused["max_memory_allocated_gib"],
                       "unfused_step1_loss": unfused["loss"][0]})
    print(f"  {cfg.name} ({cfg.num_layers} layers) {'use_fusion ' if fused else ''}trainer, {steps} steps of B{batch} x S{seq}: losses {[round(x, 4) for x in hist['loss']]},"
          f" grad norms {[round(x, 3) for x in hist['grad_norm']]}; step {step_ms:.1f} ms"
          f" (median of steps 2-{steps}"
          + (f"; unfused {unfused['step_ms_median']:.1f} ms" if fused else "")
          + f"), {result['sequences_per_s']:.2f} sequences/s, {result['tokens_per_s']:.1f} tokens/s,"
          f" model FLOPs {model_flops / 1e12:.2f} T/step ({remat_flops / 1e12:.2f} T with remat),"
          f" {100 * result['mfu_bf16_peak']:.2f} % of the {peaks['bf16'] / 1e12:g} TFLOP/s bf16 peak;"
          f" bound {bound_ms:.1f} ms ({remat_bound_ms:.1f} ms with remat); {n_params} parameters; peak {peak / 2**30:.2f} GiB"
          + (f" (unfused {unfused['max_memory_allocated_gib']:.2f})" if fused else "")
          + f"; launches {launches}", flush=True)

    # Downhill: a fresh AdamW state, one repeated batch, a small constant lr.
    del opt
    torch.cuda.empty_cache()
    if not downhill:
        del params
        torch.cuda.empty_cache()
        return result
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
    from repro_torch import fusion
    from repro_torch.fusion import rng
    from repro_torch.kernels import _build, brgemm, conv, fused_gemm, ops, ref
    from repro_torch.kernels import block_spmm as spmm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_output as fo
    from repro_torch.kernels import mamba_scan as scan

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
          f" {peaks['tf32'] / 1e12:g} TFLOP/s TF32, {peaks['fp32'] / 1e12:g} TFLOP/s fp32,"
          f" {peaks['hbm'] / 1e12:g} TB/s", flush=True)

    if "--gemm-tiles" in sys.argv[1:]:
        phase("K1's wgmma tile choices")
        print(json.dumps(gemm_tile_sweep(torch, _build, brgemm)))
        return 0

    phase("2. build")
    start = time.perf_counter()
    chained = chained_backward_sources(fusion, fused_gemm)
    logs = _build.build_all(generated={**fused_sources(fusion, fused_gemm), **chained})
    build_s = time.perf_counter() - start
    print(f"  built {', '.join(logs)} in {build_s:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "spill" in line and " 0 bytes spill stores" not in line:
                print(f"  {name}: {line.strip()}")
    k2_build = k2_build_report(_build, fa, logs["flash_attention"])
    chain_build = chain_build_report(_build, fusion, fused_gemm, fa, logs)
    bwd_build = bwd_build_report(_build, fa, logs, chained)
    gemm_build = gemm_build_report(_build, logs)
    k5_k10_build = k5_k10_build_report(logs, fused_sources(fusion, fused_gemm), fused_gemm)
    k3_k9_build = k3_k9_build_report(logs)
    k4_k8_build = k4_k8_build_report(logs)

    phase("3. kernels against their plain versions")
    bench = Bench(torch, peaks)
    gemm_cases(torch, bench, ref, brgemm)
    gemm_training_cases(torch, bench, ref, brgemm)
    attention_cases(torch, bench, ref, fa)
    attention_bwd_cases(torch, bench, ref, fa)
    decode_cases(torch, bench, ref, fa)
    paged_decode_cases(torch, bench, ref, fa)
    mamba_scan_cases(torch, bench, ref, scan)
    fused_gemm_cases(torch, bench, fusion, fused_gemm)
    fused_training_cases(torch, bench, fusion, rng)
    chained_bwd_cases(torch, bench, fusion, fused_gemm, ops)
    chained_forward_cases(torch, bench, fusion, fused_gemm, fa)
    fused_spec_cases(torch, bench, fusion, fused_gemm, rng)
    hw_prng_cases(torch, bench, fusion, fused_gemm, rng)
    bert_attention_cases(torch, bench, fusion)
    block_spmm_cases(torch, bench, ref, spmm, brgemm)
    grouped_matmul_cases(torch, bench, ref, spmm)
    fused_output_cases(torch, bench, fo, fusion)
    brgemm_blocked_cases(torch, bench, ref, brgemm)
    gemm_spec_cases(torch, bench, ref, brgemm)
    conv1x1_cases(torch, bench, ref, ops)
    k6 = bench.summary("flash_attention_bwd")["ms"]
    chained_row = bench.summary("fused_attention_bwd")
    print(f"  the chained backward kernel: {chained_row['ms']:.4f} ms (the six derived graphs it"
          f" replaces {bench.extra['minicpm_six_graphs']['ms']:.4f} ms) against K6's {k6:.4f} ms"
          f" and SDPA's backward {chained_row['library_ms']:.4f} ms at B 4, H 36, S 1024, D 64,"
          f" causal", flush=True)

    phase("4. reduced configs: CUDA kernels against CPU plain versions")
    counters = Counters(brgemm, fa, fused_gemm, scan, spmm, fo, conv)
    reduced_models(torch, counters)
    reduced_models(torch, counters, fused=True)

    phase("5. llama2-13b, full width, through generate_loop")
    cfg, params = init_model(torch)
    result = full_width(torch, counters, peaks, cfg, params)

    phase("6. llama2-13b, full width, through the serving engine")
    engine = engine_full_width(torch, counters, peaks, cfg, params)

    phase("7. llama2-13b, full width, use_fusion=True: generate_loop and the engine")
    fused = fused_full_width(torch, counters, peaks, cfg, params, result)
    fused["engine"] = fused_engine(torch, counters, cfg, params)
    del params
    torch.cuda.empty_cache()

    phase("7b. falcon-mamba-7b, full width and depth: generate_loop and the engine")
    mamba = mamba_full_width(torch, counters, peaks)

    phase("7c. the paper's Block-SpMM path: bert-large's FFN at 80 % block sparsity")
    sparse = sparse_ffn(torch, counters, peaks, spmm, fo)

    phase("7d. PARLOOPER: Listing 1 and Listing 4")
    loops = parlooper(torch, counters, peaks, ops, ref)

    phase("7e. K5 scheduled from spec strings, and K13, through the library helpers")
    scheduled = scheduled_path(torch, counters, fusion, rng)

    phase("7f. gpt-j-6b, full width and depth: the engine at head dim 256")
    gptj = gptj_engine(torch, counters)

    phase("8. reduced configs: training on CUDA against the CPU")
    reduced_training(torch)

    phase("9. minicpm-2b, full width and depth, training")
    training = train_full_width(torch, counters, peaks)

    phase("10. minicpm-2b, full width and depth, training with use_fusion=True")
    fused_training = train_full_width(torch, counters, peaks, fused=True, unfused=training)

    phase("10b. bert-large, full width and depth, training, unfused and use_fusion=True")
    bert_kw = dict(arch="bert_large", batch=16, seq=512)
    bert = train_full_width(torch, counters, peaks, **bert_kw)
    bert_fused = train_full_width(torch, counters, peaks, fused=True, unfused=bert, **bert_kw)

    phase("10c. gpt-j-6b, full width (8 of 28 layers), training, unfused and use_fusion=True")
    # d 4096 and 16 heads of 256 as published; 8 layers: 28 layers' fp32
    # masters, gradients, AdamW moments and bf16 copies (18 bytes a
    # parameter) would not fit in 80 GB
    gptj_kw = dict(arch="gptj_6b", batch=2, seq=2048, layers=8)
    gptj_train = train_full_width(torch, counters, peaks, steps=2, downhill=False, **gptj_kw)
    gptj_fused = train_full_width(torch, counters, peaks, fused=True, unfused=gptj_train, **gptj_kw)
    print(f"  gpt-j-6b (8 layers) B2 x S2048 on {card_line}: step {gptj_train['step_ms_median']:.1f} ms"
          f" unfused, {gptj_fused['step_ms_median']:.1f} ms fused; {gptj_fused['tokens_per_s']:.1f}"
          f" tokens/s fused ({gptj_train['tokens_per_s']:.1f} unfused); model-FLOPs share"
          f" {100 * gptj_fused['mfu_bf16_peak']:.2f} % fused ({100 * gptj_train['mfu_bf16_peak']:.2f}"
          f" % unfused); peak {gptj_fused['max_memory_allocated_gib']:.2f} GiB fused"
          f" ({gptj_train['max_memory_allocated_gib']:.2f} unfused)", flush=True)

    phase("11. kernels")
    kernels = []
    for name in KERNELS:
        s = bench.summary(name)
        tol = TOL["bfloat16"]["scan" if name == "mamba_scan" else
                              "attn" if name.startswith(("flash", "paged")) else "gemm"]
        by_path = {"generate_loop": result["launches"][name], "engine": engine["launches"][name],
                   "fused_generate_loop": fused["launches"][name],
                   "fused_engine": fused["engine"]["launches"][name],
                   "training": training["launches"][name],
                   "fused_training": fused_training["launches"][name],
                   "mamba_generate_loop": mamba["launches"][name],
                   "mamba_engine": mamba["engine"]["launches"][name],
                   "sparse_ffn": sparse["launches"][name],
                   "listing6_output": sparse["listing6_launches"][name],
                   "grouped_experts": sparse["grouped_launches"][name],
                   "bert_training": bert["launches"][name],
                   "bert_fused_training": bert_fused["launches"][name],
                   "gptj_training": gptj_train["launches"][name],
                   "gptj_fused_training": gptj_fused["launches"][name],
                   "parlooper_listing1": loops["listing1_launches"][name],
                   "parlooper_conv1x1": loops["conv1x1_launches"][name],
                   "parlooper_conv3x3": loops["conv3x3_launches"][name],
                   "scheduled": scheduled["launches"][name],
                   "gptj_engine": gptj["launches"][name]}
        kernels.append({
            "name": name, "row": ROW[name], "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": s["max_abs_err"],
            "max_err": s["max_abs_err"], "tol": {"rtol": tol[0], "atol": tol[1]},
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "cases": bench.cases[name],
            **({"generator": "src/repro_torch/kernels/fused_gemm.py",
                "launches_by_graph_in_fused_generate_loop": fused["launches_by_graph"],
                "launches_by_graph_in_fused_training": {
                    g: n for g, n in fused_training["launches_by_graph"].items()
                    if k5_kind(g) == name}}
               if name.startswith("fused_") and name != "fused_output" else {})})
    print(json.dumps({"build_s": build_s, "full_width": result, "engine": engine,
                      "fused": fused, "mamba": mamba, "sparse_ffn": sparse, "parlooper": loops,
                      "scheduled": scheduled, "gptj_engine": gptj,
                      "training": training,
                      "fused_training": fused_training, "bert_training": bert,
                      "bert_fused_training": bert_fused, "gptj_training": gptj_train,
                      "gptj_fused_training": gptj_fused, "phase3_extra": bench.extra,
                      "k2_build": k2_build, "chain_build": chain_build, "bwd_build": bwd_build,
                      "gemm_build": gemm_build, "k5_k10_build": k5_k10_build,
                      "k3_k9_build": k3_k9_build, "k4_k8_build": k4_k8_build}))
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
