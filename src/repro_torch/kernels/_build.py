"""Build and load the CUDA kernels of ``kernels/csrc``.

Each ``csrc/<name>.cu`` is a source with a plain C interface (it may include
the shared ``csrc/*.cuh`` headers).  At first use it is compiled by ``nvcc``
for ``sm_90a`` into a shared library under ``build/kernels/`` at the
repository root (listed in ``.gitignore``), named by a hash of its source,
the headers and the flags so an edited source never loads a stale library,
and loaded with ``ctypes``.  Generated sources (K5's, one per
fused graph, from ``kernels/fused_gemm.py``) are written there beside their
library, built with ``csrc`` on the include path and named by a hash of
their text, of the headers they may include (``GENERATED_INCLUDES``) and of
the flags (``load_generated``).
``build_all`` starts one ``nvcc`` per source, fixed and generated, at once
and waits for all of them.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises if that is not 0.  Nothing here catches a failed build or
launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "build_all", "load", "load_generated", "load_variants", "check"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# The attention backward's entry (csrc/attention_bwd.cuh, K6's source and
# every generated chained backward): q, k, v, o, lse, do, stats, dq, dk, dv,
# bf16, B, H, Hk, Sq, Skv, D, plan (8 int32s on the host), strides (24
# int64s on the host), causal, window, scale, stream.
ATTENTION_BWD = (_P,) * 10 + (_I,) * 7 + (_P, _P, _I, _I, _F, _P)

# C signature of every entry point, by source: (argtypes), restype is int.
SIGNATURES = {
    "gemm": {
        # a, b, bias, c, in_bf16, out_bf16, M, N, K, lda, ldb, trans_a,
        # trans_b, act, vec, order, n_order, variant, cta_n, workspace,
        # counters, splits, split_steps, stream
        "gemm": (_P, _P, _P, _P) + (_I,) * 11 + (_P, _I, _I, _I, _P, _P, _I, _I, _P),
        # out (5 int32s on the host): the wgmma tiles as built
        "gemm_tiles": (_P,),
    },
    "brgemm_blocked": {
        # a, b, c, order, n_order, paired, in_bf16, out_bf16, variant, Mb,
        # Nb, Kb, bm, bn, bk, k_step, vec, stream
        "brgemm_blocked": (_P,) * 4 + (_I,) * 13 + (_P,),
    },
    "flash_attention": {
        # q, k, v, o, lse, bf16, B, H, Hk, Sq, Skv, D, the plan's rows, bn,
        # stages and smem, q/k/v/o strides (batch, head, seq) x 4, causal,
        # window, scale, stream
        "flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I)
        + (_L,) * 12 + (_I, _I, _F, _P),
    },
    "flash_decode": {
        # q, k, v, length, o, workspace, counters, bf16, B, H, Hk, S, D,
        # q (batch, head), k/v (batch, head, seq), o (batch, head), window,
        # scale, stream
        "flash_decode": (_P,) * 7 + (_I,) * 6 + (_L,) * 10 + (_I, _F, _P),
        "flash_decode_chunk": (),
    },
    "flash_attention_bwd": {"attention_bwd": ATTENTION_BWD},
    "paged_decode": {
        # q, k_pool, v_pool, table, length, o, workspace, counters, bf16,
        # table64, length64, B, H, Hk, D, page_size, max_pages, pool rows,
        # table row stride, q (batch, head), o (batch, head), window, scale,
        # stream
        "paged_decode": (_P,) * 8 + (_I,) * 10 + (_L,) * 5 + (_I, _F, _P),
        "paged_decode_chunk": (),
    },
    "mamba_scan": {
        # x, dt, a, b, c, d_skip, h0, y, h_out, states, bf16, B, L, D, N,
        # lanes, x/dt strides (batch, step), b/c strides (batch, step, n),
        # stream
        "mamba_scan": (_P,) * 10 + (_I,) * 6 + (_L,) * 10 + (_P,),
        "mamba_scan_steps": (),
        "mamba_scan_min_blocks": (_I,),
        # x, dt, a, b, c, d_skip, states, dy, dh_final, dx, ddt, db, dc, da,
        # dd, dh0, dB/dC partials, dA/dD partials, bf16, vec, B, L, D, N,
        # x/dt strides (batch, step), b/c strides (batch, step, n), dy
        # strides (batch, step), stream
        "mamba_scan_bwd": (_P,) * 18 + (_I,) * 6 + (_L,) * 12 + (_P,),
        "mamba_scan_bwd_sub": (),
        "mamba_scan_bwd_min_blocks": (),
        # bf16, N, what (0 shared memory, 1 registers, 2 blocks an SM)
        "mamba_scan_bwd_info": (_I, _I, _I),
    },
    "block_spmm": {
        # blocks, row_ptr, col_id, b, c, in_bf16, out_bf16, nrows, bm, bk,
        # N, K, ldb, trans_b, vec, variant, nnzb, rows_per, workspace,
        # stream
        "block_spmm": (_P,) * 5 + (_I,) * 13 + (_P,) * 2,
        # x, group_id, w, out, in_bf16, out_bf16, tiles, rows, E, d, f,
        # variant, stream
        "grouped_matmul": (_P,) * 4 + (_I,) * 8 + (_P,),
        "grouped_tile": (_P,),
        # dy, group_id, w, dx, in_bf16, out_bf16, tiles, rows, E, d, f,
        # variant, stream
        "grouped_matmul_dx": (_P,) * 4 + (_I,) * 8 + (_P,),
        # x, group_id, dy, dw, in_bf16, tiles, rows, E, d, f, variant,
        # CTAs (wgmma's persistent grid), stream
        "grouped_matmul_dw": (_P,) * 4 + (_I,) * 8 + (_P,),
        "grouped_bwd_tile": (_P,),
    },
    "fused_output": {
        # x, w, bias, residual, keep, gamma, beta, out, scratch, in_bf16,
        # out_bf16, M, N, K, scale, eps, vec, variant, cluster, tiles a CTA,
        # warpgroups, stages, CTAs an SM, smem, stream
        "fused_output": (_P,) * 9 + (_I,) * 5 + (_F, _F) + (_I,) * 8 + (_P,),
        "fused_output_smem_max_n": (),
        # warpgroups, stages, CTAs an SM, tiles a CTA
        "fused_output_wgmma_smem": (_I,) * 4,
        # warpgroups, stages, CTAs an SM, tiles a CTA, cluster, row bands,
        # out_bf16, out
        "fused_output_max_clusters": (_I,) * 7 + (_P,),
    },
}
SOURCES = tuple(SIGNATURES)
# C signature of a generated source (K5) by its entry point, and the headers
# it may include.  fused_gemm: the FusedArgs struct, stream; attention_bwd:
# a chained graph's backward, ATTENTION_BWD.
GENERATED_SIGNATURES = {"fused_gemm": {"fused_gemm": (_P, _P)},
                        "attention_bwd": {"attention_bwd": ATTENTION_BWD}}
GENERATED_INCLUDES = (CSRC / "fused_gemm.cuh", CSRC / "fused_chain.cuh", CSRC / "philox.cuh",
                      CSRC / "attention_fwd.cuh", CSRC / "attention_bwd.cuh", CSRC / "wgmma.cuh")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _generated_target(name: str, source: str) -> Path:
    digest = hashlib.sha256(source.encode() + b"".join(p.read_bytes() for p in GENERATED_INCLUDES)
                            + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _run_nvcc(src: Path, target: Path, extra=()):
    """Start nvcc on ``src``; → (process, target, temp path, log path)."""
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    log = target.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(src)]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return proc, target, tmp, log


def _start(name: str):
    """Start nvcc on one fixed source, or None when it is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return _run_nvcc(CSRC / f"{name}.cu", target)


def _start_generated(name: str, source: str):
    """Write one generated source beside its library and start nvcc on it,
    or None when it is already built."""
    target = _generated_target(name, source)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = target.with_suffix(".cu")
    tmp = src.with_suffix(f".{os.getpid()}.cu.tmp")
    tmp.write_text(source)
    os.replace(tmp, src)
    return _run_nvcc(src, target, ("-I", str(CSRC)))


def build_all(names=SOURCES, generated=()) -> dict[str, str]:
    """Compile every source not yet built, fixed (``names``) and generated
    (``generated``: ``(name, source)`` pairs), all at once; → name →
    compiler log (register and shared-memory use per kernel, from
    ``-Xptxas -v``).  Every nvcc has ended before this returns or raises."""
    generated = dict(generated)
    targets = {n: _target(n) for n in names}
    targets.update({n: _generated_target(n, src) for n, src in generated.items()})
    with _LOCK:
        jobs = [j for j in (_start(n) for n in names) if j is not None]
        jobs += [j for j in (_start_generated(n, src) for n, src in generated.items())
                 if j is not None]
        codes = [proc.wait() for proc, *_ in jobs]
        for code, (_, target, tmp, log) in zip(codes, jobs):
            if code != 0:
                raise RuntimeError(f"nvcc failed for {target.name}:\n{log.read_text()}")
            os.replace(tmp, target)
    logs = {}
    for n, target in targets.items():
        log = target.with_suffix(".log")
        logs[n] = log.read_text() if log.exists() else ""
    return logs


def _open(key: str, target: Path, signatures: dict) -> ctypes.CDLL:
    with _LOCK:
        if key not in _LIBS:
            lib = ctypes.CDLL(str(target))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[key] = lib
    return _LIBS[key]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    return _open(name, _target(name), SIGNATURES[name])


def load_generated(name: str, source: str, entry: str = "fused_gemm") -> ctypes.CDLL:
    """The loaded library of a generated source whose C entry point is
    ``entry``, built first if needed."""
    target = _generated_target(name, source)
    lib = _LIBS.get(target.name)
    if lib is not None:
        return lib
    build_all((), {name: source})
    return _open(target.name, target, GENERATED_SIGNATURES[entry])


def load_variants(name: str, defines: list[dict]) -> list[ctypes.CDLL]:
    """``csrc/<name>.cu`` built once for each dict of ``-D`` macros (a tile
    choice timed beside the default build), all at once; → the loaded
    libraries, in order.  Each is named by the hash of the source, the
    headers, the flags and its macros."""
    flags = [tuple(f"-D{k}={v}" for k, v in sorted(d.items())) for d in defines]
    base = _target(name)
    targets = [base.with_name(f"{base.stem}-" + hashlib.sha256(" ".join(f).encode())
                              .hexdigest()[:8] + ".so") for f in flags]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _LOCK:
        jobs = [_run_nvcc(CSRC / f"{name}.cu", t, f) for t, f in zip(targets, flags)
                if not t.exists()]
        for (proc, target, tmp, log) in jobs:
            if proc.wait() != 0:
                raise RuntimeError(f"nvcc failed for {target.name}:\n{log.read_text()}")
            os.replace(tmp, target)
    return [_open(t.name, t, SIGNATURES[name]) for t in targets]


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
