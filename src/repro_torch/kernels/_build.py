"""Build and load the CUDA kernels of ``kernels/csrc``.

Each ``csrc/<name>.cu`` is a self-contained source with a plain C interface.
At first use it is compiled by ``nvcc`` for ``sm_90a`` into a shared library
under ``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of its source and flags so an edited source never loads a
stale library, and loaded with ``ctypes``.  ``build_all`` starts one ``nvcc``
per source at once and waits for all of them.

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

__all__ = ["SOURCES", "build_all", "load", "check"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signature of every entry point, by source: (argtypes), restype is int.
SIGNATURES = {
    "gemm": {
        # a, b, bias, c, in_bf16, out_bf16, M, N, K, lda, ldb, act, vec, stream
        "gemm": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    },
    "flash_attention": {
        # q, k, v, o, bf16, B, H, Hk, Sq, Skv, D,
        # q/k/v/o strides (batch, head, seq) x 4, causal, window, scale, stream
        "flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I)
        + (_L,) * 12 + (_I, _I, _F, _P),
        # q, k, v, length, o, bf16, B, H, Hk, S, D,
        # q (batch, head), k/v (batch, head, seq), o (batch, head), window,
        # scale, stream
        "flash_decode": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I)
        + (_L,) * 10 + (_I, _F, _P),
    },
    "paged_decode": {
        # q, k_pool, v_pool, table, length, o, bf16, B, H, Hk, D, page_size,
        # max_pages, pool rows, q (batch, head), o (batch, head), window,
        # scale, stream
        "paged_decode": (_P,) * 6 + (_I,) * 8 + (_L,) * 4 + (_I, _F, _P),
    },
}
SOURCES = tuple(SIGNATURES)

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
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc on one source; → (process, target, temp path, log path),
    or None when the library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    log = target.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return proc, target, tmp, log


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every source not yet built, all at once; → name → compiler
    log (register and shared-memory use per kernel, from ``-Xptxas -v``).
    Every nvcc has ended before this returns or raises."""
    with _LOCK:
        jobs = [j for j in (_start(n) for n in names) if j is not None]
        codes = [proc.wait() for proc, *_ in jobs]
        for code, (_, target, tmp, log) in zip(codes, jobs):
            if code != 0:
                raise RuntimeError(f"nvcc failed for {target.name}:\n{log.read_text()}")
            os.replace(tmp, target)
    return {n: _target(n).with_suffix(".log").read_text()
            if _target(n).with_suffix(".log").exists() else "" for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
    return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
