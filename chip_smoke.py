#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which must pass:
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
     per source, all at once) and print the build time;
  3. hold each kernel (K1 GEMM, K2 flash attention, K3 flash decode) against
     its plain PyTorch version on the card, at the main path's shapes plus
     GQA, windowed and ragged ones; print error and tolerance, the median
     time over CUDA events, the plain version's time, one PyTorch library
     call's time as a yardstick (the port never calls it) and the bound;
  4. run ``generate_loop`` for reduced fp32 llama2-13b, gpt-j-6b and
     minicpm-2b on the card (kernels) and on the CPU (plain versions): the
     logits must agree and the greedy tokens must be equal;
  5. serve full-width llama2-13b (bf16, all 40 layers, random weights from a
     seed, batch 4, prompt 512, 16 new tokens) through ``generate_loop`` with
     every launch counter set to 0 just before and read just after: each
     kernel must have launched, the logits must be finite;
  6. print one JSON line with every kernel's numbers;
  7. print the last line, ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero before the last line.
"""
from __future__ import annotations

import json
import math
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
# flash_attention_pallas and flash_decode_pallas.
REPLACES = {
    "gemm": "src/repro/kernels/brgemm.py:58",
    "flash_attention": "src/repro/kernels/flash_attention.py:35",
    "flash_decode": "src/repro/kernels/flash_attention.py:169",
}
SOURCE = {
    "gemm": "src/repro_torch/kernels/csrc/gemm.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_decode": "src/repro_torch/kernels/csrc/flash_attention.cu",
}
# What each kernel's ms, plain_ms, bound_ms and library_ms add up: the
# weighted cases of phase 3 (library: torch.matmul without the activation,
# and scaled_dot_product_attention).
ROW = {
    "gemm": "one llama2-13b layer's 7 projections at prefill (M 2048) plus one decode step (M 4)",
    "flash_attention": "one llama2-13b layer's prefill attention (B 4, H 40, S 512, causal)",
    "flash_decode": "one llama2-13b layer's decode attention (B 4, H 40, cache 528, length 520)",
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
    """→ (max abs error, within tolerance)."""
    torch.cuda.synchronize()
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
        self.cases = {"gemm": [], "flash_attention": [], "flash_decode": []}

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
    for m, phase_name in ((2048, "prefill"), (4, "decode")):
        for k, n, act, count in layer:
            a, b, _ = operands(m, k, n, torch.bfloat16)
            bench.run("gemm", f"{phase_name} {m}x{k}x{n} {act or ''}",
                      lambda: brgemm.matmul(a, b, activation=act),
                      lambda: ref.matmul_ref(a, b, activation=act),
                      lambda: torch.matmul(a, b),
                      flops=2 * m * n * k, nbytes=2 * (m * k + k * n + m * n),
                      dtype="bfloat16", tol_kind="gemm", weight=count)
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
    windowed, and small ragged fp32 and bf16 checks."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # label, B, H, Hk, Sq, Skv, D, causal, window, dtype, weight, timed
        ("main B4 H40 S512 D128 causal", 4, 40, 40, 512, 512, 128, True, None, torch.bfloat16, 1, True),
        ("gqa B4 H40 Hk8 S512 D128", 4, 40, 8, 512, 512, 128, True, None, torch.bfloat16, 0, True),
        ("window128 B4 H40 S512 D128", 4, 40, 40, 512, 512, 128, True, 128, torch.bfloat16, 0, True),
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


def _to_cuda(tree):
    """A copy of a parameter tree (dicts and lists of tensors) on the GPU."""
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cuda(v) for v in tree]
    return tree.cuda()


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
        print(f"  {arch}-reduced fp32: max logit diff {worst:.3e} (rtol {rtol}, atol {atol}),"
              f" greedy tokens equal: {same}", flush=True)
        check(same, f"{arch} reduced: greedy tokens differ between GPU and CPU")


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


def full_width(torch, counters, peaks):
    """llama2-13b at full width and depth through generate_loop."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    from repro_torch.serve.decode import ServeConfig, generate_loop

    cfg = get_config("llama2_13b")
    batch, prompt_len, new = 4, 512, 16
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  init {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.dtype},"
          f" {torch.cuda.memory_allocated() / 2**30:.2f} GiB of weights in"
          f" {time.perf_counter() - t0:.2f} s", flush=True)
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
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    result["profile"] = device_breakdown(
        torch, lambda: generate_loop(cfg, params, prompts, new, scfg=scfg), total_ms)
    return result


# Kernel names as the profiler reports them → the port's kernel.
KERNEL_OF = {"gemm_bf16_wmma": "gemm", "gemm_f32_simt": "gemm",
             "flash_attention_kernel": "flash_attention", "flash_decode_kernel": "flash_decode"}


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
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0:
            continue
        name = next((k for frag, k in KERNEL_OF.items() if frag in ev.key), "other")
        ms, count = by_kernel.get(name, (0.0, 0))
        by_kernel[name] = (ms + ev.self_device_time_total / 1e3, count + ev.count)
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms if busy_ms else None,
           "by_kernel": {k: {"ms": ms, "launches": n} for k, (ms, n) in
                         sorted(by_kernel.items(), key=lambda kv: -kv[1][0])}}
    print(f"  profile: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms"
          + "".join(f"; {k} {v['ms']:.1f} ms / {v['launches']}" for k, v in out["by_kernel"].items()),
          flush=True)
    return out


class Counters:
    """Reads and resets the kernel wrappers' launch counters."""

    def __init__(self, brgemm, fa):
        self.brgemm, self.fa = brgemm, fa

    def reset(self):
        self.brgemm.LAUNCHES = 0
        self.fa.ATTENTION_LAUNCHES = 0
        self.fa.DECODE_LAUNCHES = 0

    def read(self):
        return {"gemm": self.brgemm.LAUNCHES,
                "flash_attention": self.fa.ATTENTION_LAUNCHES,
                "flash_decode": self.fa.DECODE_LAUNCHES}


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
    attention_cases(torch, bench, ref, fa)
    decode_cases(torch, bench, ref, fa)

    phase("4. reduced configs: CUDA kernels against CPU plain versions")
    reduced_models(torch)

    phase("5. llama2-13b, full width, through generate_loop")
    counters = Counters(brgemm, fa)
    result = full_width(torch, counters, peaks)

    phase("6. kernels")
    kernels = []
    for name in ("gemm", "flash_attention", "flash_decode"):
        s = bench.summary(name)
        tol = TOL["bfloat16"]["gemm" if name == "gemm" else "attn"]
        kernels.append({
            "name": name, "row": ROW[name], "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": result["launches"][name], "max_abs_err": s["max_abs_err"],
            "max_err": s["max_abs_err"], "tol": {"rtol": tol[0], "atol": tol[1]},
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "cases": bench.cases[name]})
    print(json.dumps({"build_s": build_s, "full_width": result}))
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
