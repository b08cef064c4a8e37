#!/usr/bin/env python3
"""Time K9's backward (``kernels/block_spmm.py::grouped_matmul_dx`` and
``grouped_matmul_dw``) on one NVIDIA GPU at qwen3-moe-235b's training layer
(128 row tiles of cap 320, ``group_id`` arange(128), bf16 in), and the
card's rate of reading from L2 into the SMs.

    python3 scripts/time_grouped_bwd.py [--src DIR] [--products dx|dw|both] [--mainloop]
                                        [--dx-parts]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so that two trees can be timed in turns on one
card: unpack the other commit with ``git archive`` into a directory that
``.gitignore`` lists and run this script on each, alternating.  Each run
builds that tree's kernels into its own ``build/``.  The operands are
``chip_smoke.py``'s (``grouped_bwd_operands``, seed 14): dX (bf16) and dW
(fp32) of the gate/up product (d 4096, f 1536) and of the down product
(d 1536, f 4096).  For each it prints, after the ``src`` path, the device
time and a lone call's median as ``chip_smoke.py``'s ``device_ms`` and
``time_ms`` take them, ``torch.bmm``'s device time on the same operands
(``grouped_bmm_yardstick``), and the SHA-256 of the output's bytes, so that
two trees' bits can be compared; with the card's name and power limit.

The L2 case: a 32 MiB bf16 buffer, resident in L2 after one pass, read
whole by each of two blocks an SM in 16-byte loads that bypass L1
(``ld.global.cg``), each block from its own offset; the rate is the bytes
read over the device time of one such launch (``device_ms``).  Its CUDA
source is built with ``nvcc`` into ``build/l2_probe/``.

``--mainloop`` also runs one row each of the other kernels on the GEMM
mainloop and its Hopper blocks (``csrc/gemm_mainloop.cuh``, ``wgmma.cuh``):
K1 at prefill (M 2048) and decode (M 4), K5's gated MLP at M 2048, K7
(Listing 6, M 4096), K9's forward at the training layer, K10 (4096^3, 16x16
blocks at 50 %) and K11 (2048^3, 64^3 blocks), seed 15, each with its
device time and digest, so that a change to those headers can be shown to
keep their bits.

``--dx-parts`` then times dX with one part of its work cut out, to find
where its time goes beyond the L2 rate: for each of ``DX_PARTS`` a copy of
the timed tree under ``build/dx_parts/<name>/src`` whose sources are edited
as that entry says (``no-stores``: the epilogue's global stores never
fire, its shuffles stay; ``no-products``: the consumers wait on the ring
and free its stages but issue no wgmma; ``loads-only``: both), timed on
dX alone in a process of its own (``--products dx``).  Their outputs are
not dX: only their times mean anything.

Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PRODUCTS = (("gate/up", 4096, 1536), ("down", 1536, 4096))
L2_BYTES = 32 << 20

# (file under repro_torch/, text, its replacement): each text occurs once
DX_NO_STORES = ("kernels/csrc/block_spmm.cu",
                "      if (c < rows && r < d)\n        grouped_wg::store2(dx,",
                "      if (c < rows && r < d && got == 1234.5f)\n        grouped_wg::store2(dx,")
DX_NO_PRODUCTS = ("kernels/csrc/gemm_mainloop.cuh",
                  "        hopper::Wgmma<C::BN>::template ss<C::kAMN ? 1 : 0, C::kBMN ? 1 : 0>(\n"
                  "            acc[j], C::A::desc(a_s, 64 * (C::MB * wg + j), ks),"
                  " C::B::desc(b_s, 0, ks), 1);",
                  "        hopper::fence_regs(acc[j]);")
DX_PARTS = {"no-stores": (DX_NO_STORES,), "no-products": (DX_NO_PRODUCTS,),
            "loads-only": (DX_NO_STORES, DX_NO_PRODUCTS)}

PROBE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// Each block reads all n 16-byte words of buf once, from word
// blockIdx.x * n / gridDim.x on (wrapping), four loads in flight a thread;
// the xor of what it read goes to sink only if it equals a value it will
// not, so the loads are kept and nothing is written.
__global__ void __launch_bounds__(1024) l2_read(const uint4* __restrict__ buf, long long n,
                                                unsigned* __restrict__ sink) {
  const long long start = (long long)blockIdx.x * (n / gridDim.x);
  const long long step = blockDim.x;
  unsigned acc = 0;
  for (long long i = threadIdx.x; i < n; i += 4 * step) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      long long j = i + u * step;
      j = j < n ? start + j : start;
      if (j >= n) j -= n;
      v[u] = __ldcg(buf + j);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  if (acc == 0x9e3779b9u) sink[0] = acc;
}

extern "C" int l2_read_launch(const void* buf, long long words, int blocks, void* sink,
                              void* stream) {
  l2_read<<<blocks, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(buf), words, static_cast<unsigned*>(sink));
  return static_cast<int>(cudaGetLastError());
}
"""


def _probe_library() -> ctypes.CDLL:
    """The L2 probe's library, built with ``nvcc`` for sm_90a."""
    nvcc = shutil.which("nvcc") or str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
                                       / "bin" / "nvcc")
    out = ROOT / "build" / "l2_probe"
    out.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(PROBE_SOURCE.encode()).hexdigest()[:16]
    lib = out / f"l2_probe-{digest}.so"
    if not lib.exists():
        src = out / f"l2_probe-{digest}.cu"
        src.write_text(PROBE_SOURCE)
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)], check=True)
    probe = ctypes.CDLL(str(lib))
    probe.l2_read_launch.argtypes = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p)
    probe.l2_read_launch.restype = ctypes.c_int
    return probe


def l2_read_rate(torch, device_ms):
    """→ (bytes read a launch, device ms a launch, bytes/s) of the L2 case."""
    probe = _probe_library()
    buf = torch.randn(L2_BYTES // 2, device="cuda").to(torch.bfloat16)
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    blocks = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = probe.l2_read_launch(buf.data_ptr(), L2_BYTES // 16, blocks, sink.data_ptr(), stream)
        if err:
            raise RuntimeError(f"l2_read: CUDA error {err} at launch")

    ms = device_ms(torch, run)
    nbytes = blocks * L2_BYTES
    return nbytes, ms, nbytes / (ms * 1e-3)


def digest(torch, out) -> str:
    """SHA-256 of a tensor's bytes (or a tuple's, one after another), as
    they lie (bf16 or fp32)."""
    h = hashlib.sha256()
    for t in out if isinstance(out, (tuple, list)) else (out,):
        words = t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)
        for chunk in words.flatten().split(1 << 26):
            h.update(chunk.cpu().numpy().tobytes())
    return h.hexdigest()


def parts_tree(src: Path, name: str) -> Path:
    """A copy of the ``src`` tree under ``build/dx_parts/<name>/src`` with
    ``DX_PARTS[name]``'s edits made; raises if a text is not found once."""
    out = ROOT / "build" / "dx_parts" / name / "src"
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(src, out, ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in DX_PARTS[name]:
        path = out / "repro_torch" / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"--dx-parts {name}: {rel} holds its text {text.count(old)} times")
        path.write_text(text.replace(old, new))
    return out


def mainloop_rows(torch):
    """→ [(row, fn)] of the other kernels on the GEMM mainloop, operands
    drawn from seed 15 (see the module's docstring)."""
    import math

    import numpy as np
    from repro_torch import fusion
    from repro_torch.kernels import block_spmm as spmm
    from repro_torch.kernels import brgemm
    from repro_torch.kernels import fused_output as fo

    gen = torch.Generator(device="cuda").manual_seed(15)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    rows = []
    d, ff = 5120, 13824
    w = randn(d, d, scale=d ** -0.5)
    for m in (2048, 4):
        x = randn(m, d)
        rows.append((f"K1 gemm M{m} K{d} N{d}", lambda x=x: brgemm.matmul(x, w)))
    x, wg, wu = randn(2048, d), randn(d, ff, scale=d ** -0.5), randn(d, ff, scale=d ** -0.5)
    gated = fusion.compile(fusion.fused_gated_mlp_graph("silu"), path="cuda")
    rows.append((f"K5 fused_gated_mlp_silu M2048 {d}->{ff}", lambda: gated(x=x, wg=wg, wu=wu)))
    m, k, n = 4096, 1024, 1024
    args = (randn(m, k), randn(k, n, scale=k ** -0.5), randn(n, dtype=torch.float32),
            randn(m, n), randn(n, dtype=torch.float32), randn(n, dtype=torch.float32))
    keep = torch.rand(m, n, generator=gen, device="cuda") > 0.1
    rows.append((f"K7 fused_output M{m} K{k} N{n}",
                 lambda: fo.fused_output(*args, keep_mask=keep, dropout_rate=0.1)))
    e, cap, dg, fg = 128, 320, 4096, 1536
    xg = randn(e * cap, dg)
    wg9 = randn(e, dg, fg, scale=dg ** -0.5)
    gid = torch.arange(e, dtype=torch.int32, device="cuda")
    rows.append((f"K9 grouped_matmul E{e} tiles of {cap} d{dg} f{fg} -> fp32",
                 lambda: spmm.grouped_matmul(xg, gid, wg9, out_dtype=torch.float32)))
    rng = np.random.default_rng(15)
    a = rng.normal(size=(4096, 4096)).astype(np.float32)
    a.reshape(256, 16, 256, 16).transpose(0, 2, 1, 3)[rng.random((256, 256)) < 0.5] = 0
    blocks, rid, cid = spmm.densify_to_bcsr(a, 64, 16)
    blocks = blocks.to(bf16)
    b = randn(4096, 4096)
    rows.append(("K10 block_spmm 4096^3 16x16 at 50 % as 64x16",
                 lambda: spmm.block_spmm(blocks, rid, cid, b, nrows_b=64)))
    mb = 2048 // 64
    ab, bb = randn(mb, mb, 64, 64, scale=1 / math.sqrt(2048)), randn(mb, mb, 64, 64)
    rows.append(("K11 brgemm_blocked 2048^3 64^3 blocks k_step 4",
                 lambda: brgemm.brgemm_blocked(ab, bb, k_step=4)))
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=str(ROOT / "src"))
    parser.add_argument("--mainloop", action="store_true")
    parser.add_argument("--dx-parts", action="store_true")
    parser.add_argument("--products", choices=("dx", "dw", "both"), default="both")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_grouped_bwd: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_ms, grouped_bmm_yardstick, grouped_bwd_operands, time_ms
    from repro_torch.kernels import block_spmm as spmm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    nbytes, ms, rate = l2_read_rate(torch, device_ms)
    print(f"{args.src}: L2 -> SM reads: {nbytes / 1e9:.3f} GB in [{ms:.4f}] ms, {rate / 1e12:.3f}"
          f" TB/s (a 32 MiB buffer, 2 blocks an SM, 16-byte ld.global.cg) on {card}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(14)
    e, cap = 128, 320
    gid = torch.arange(e, dtype=torch.int32, device="cuda")
    for what, d, f in PRODUCTS:
        w, x, dy = grouped_bwd_operands(torch, gen, d, f, e, cap)
        for kind in ("dx", "dw") if args.products == "both" else (args.products,):
            if kind == "dx":
                fn = lambda: spmm.grouped_matmul_dx(dy, gid, w)  # noqa: E731
            else:
                fn = lambda: spmm.grouped_matmul_dw(x, gid, dy, e)  # noqa: E731
            before = spmm.GROUPED_BWD_LAUNCHES
            out = fn()
            torch.cuda.synchronize()
            launches = spmm.GROUPED_BWD_LAUNCHES - before
            bits = digest(torch, out)
            del out
            library, _ = grouped_bmm_yardstick(torch, kind, x, dy, w)
            print(f"{args.src}: K9 {kind} {what} E{e} tiles of {cap} d{d} f{f}: device"
                  f" {device_ms(torch, fn):.4f} ms, lone call {time_ms(torch, fn):.4f} ms,"
                  f" torch.bmm device {device_ms(torch, library):.4f} ms; sha256 {bits}"
                  f" ({launches} launch(es) a call) on {card}", flush=True)
            torch.cuda.empty_cache()
        del w, x, dy
        torch.cuda.empty_cache()
    if args.mainloop:
        for row, fn in mainloop_rows(torch):
            print(f"{args.src}: {row}: device {device_ms(torch, fn):.4f} ms;"
                  f" sha256 {digest(torch, fn())} on {card}", flush=True)
    if args.dx_parts:
        for name in DX_PARTS:
            tree = parts_tree(Path(args.src).resolve(), name)
            subprocess.run([sys.executable, __file__, "--src", str(tree), "--products", "dx"],
                           check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
