"""K7: the fused Bert-Output / Bert-SelfOutput layer (paper Listing 6),
``layernorm(dropout(x @ w + bias) + residual)`` in one kernel.

Replaces ``repro/kernels/fused_output.py::fused_output_pallas`` (line 48).
The CUDA source is ``csrc/fused_output.cu``, whose header says what bounds
the kernel on an H100 and what its design does about it.  Three variants,
which ``fused_output_plan`` names from the dtype, N and whether TMA can read
the operands (no fallback: the C entry launches the plan's variant or
raises):

  * ``wgmma`` (bf16, x, w, residual and the keep mask TMA-readable, bias,
    gamma and beta 8-byte aligned, N a multiple of 128 that a thread-block
    cluster holds): the product on the
    Hopper GEMM mainloop, the epilogue in the accumulator registers, the
    layernorm's row sums exchanged across a cluster of up to 8 CTAs along N
    through distributed shared memory.  The plan names the cluster: CTAs,
    columns and rows a CTA, ring stages and shared memory.
  * ``wmma`` (other bf16 operands): one block owns 32 rows and all N on
    WMMA fragments, its fp32 row panel in shared memory (N up to the C
    function ``fused_output_smem_max_n()``, 1664) or in a device-memory
    scratch the wrapper allocates.
  * ``simt`` (fp32): the same kernel on SIMT FMA, never TF32.

``fused_output_ref`` is its plain version, the counterpart of the
reference's oracle of the same name; ``fused_output`` takes a CPU tensor to
the plain version and a CUDA tensor to the kernel.  Dropout takes the
caller's ``keep_mask``, as the reference's kernel does: there are no random
bits in the kernel (``fusion.library.fused_output_apply`` is the fused-graph
form with counter-based bits).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

__all__ = ["fused_output", "fused_output_ref", "fused_output_plan", "max_active_clusters",
           "OutputPlan", "VARIANTS", "VARIANT_COUNTERS", "WGMMA_SHAPES", "PANEL_SMEM_MAX_N",
           "LAUNCHES", "WGMMA_LAUNCHES", "WMMA_LAUNCHES", "SIMT_LAUNCHES"]

# Launches of the CUDA kernel since import (or since a caller reset them), in
# all and by variant.
LAUNCHES = 0
WGMMA_LAUNCHES = 0
WMMA_LAUNCHES = 0
SIMT_LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)
# The C entry's variant codes (csrc/fused_output.cu enum Variant), and the
# counter each adds to.
VARIANTS = {"wmma": 0, "wgmma": 1, "simt": 2}
VARIANT_COUNTERS = {"wmma": "WMMA_LAUNCHES", "wgmma": "WGMMA_LAUNCHES", "simt": "SIMT_LAUNCHES"}
# The wgmma shapes the source builds (its K7_SHAPES), in the order the plan
# tries them: (consumer warpgroups of 64 rows, ring stages, CTAs an SM,
# several tiles a CTA).  Two CTAs an SM for one tile a CTA: one CTA's ring
# fill, epilogue and cluster exchange run under the other's products.
WGMMA_SHAPES = ((2, 3, 2, False), (1, 4, 1, True))
TILE_N = 128                # columns a wgmma tile
MAX_CLUSTER = 8             # CTAs a cluster (the portable limit)
SMEM_LIMIT = 232448         # shared memory a CTA can take on an H100
SM_SMEM = 233472            # an SM's shared memory, 1 KB of it reserved a CTA
# The widest N whose 32-row fp32 panel the wmma and simt variants keep in
# shared memory (the C function fused_output_smem_max_n(), checked once).
PANEL_SMEM_MAX_N = 1664


class OutputPlan(NamedTuple):
    """How K7 runs one call: ``variant``; for ``wgmma`` the cluster
    (``cluster`` CTAs along N, each ``cols`` columns = ``tiles`` tiles of
    128 by ``rows`` rows), its ring ``stages``, ``ctas`` an SM and ``smem``
    bytes a CTA; for ``wmma`` and ``simt`` whether the row panel needs the
    device-memory ``scratch``."""
    variant: str
    cluster: int = 1
    tiles: int = 1
    rows: int = 32
    stages: int = 0
    smem: int = 0
    scratch: bool = False
    ctas: int = 1

    @property
    def cols(self) -> int:
        return self.tiles * TILE_N

    @property
    def warpgroups(self) -> int:
        return self.rows // 64


def _wgmma_smem(wg: int, stages: int, tiles: int) -> int:
    """A wgmma CTA's shared memory: the 1024-byte alignment slack, the ring
    and its barriers (the ring also carries each tile's residual and keep
    boxes), a slot of fp32 values for each tile but the last (which stays
    in registers), and the rows' two partials (``csrc/fused_output.cu``
    wg7::Layout)."""
    rows = 64 * wg
    ring = stages * (rows + TILE_N) * 64 * 2 + 16 * stages + 16
    slots = -(-ring // 1024) * 1024
    return 1024 + slots + (tiles - 1) * rows * TILE_N * 4 + 2 * rows * 4


def fused_output_plan(m: int, n: int, k: int, dtype, out_dtype=None, *,
                      aligned: bool = True) -> OutputPlan:
    """The variant and shape K7 runs (M, K) @ (K, N) on: ``wgmma`` for bf16
    inputs it can read (``aligned``, ``_wgmma_readable``: x, w, residual and
    the keep mask with 16-byte aligned bases and rows, the fp32 bias, gamma
    and beta with 8-byte aligned bases) and N a multiple of 128 whose tiles a
    cluster of at most 8 CTAs holds (the most CTAs that divide the tiles;
    the first of ``WGMMA_SHAPES`` that takes that many tiles a CTA and whose
    ring and slots fit its share of the SM's shared memory) and K > 0; ``wmma`` for other bf16; ``simt`` for fp32.  Raises
    ``ValueError`` for what no variant takes."""
    out_dtype = out_dtype or dtype
    if dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"fused_output dtype {dtype}, out_dtype {out_dtype}: need {_DTYPES}")
    if min(m, n) < 1 or k < 0:
        raise ValueError(f"fused_output: ({m}, {n}, {k}) has no output")
    if m * max(n, k) >= 2 ** 31:
        raise ValueError(f"fused_output: ({m}, {n}, {k}) is too large for 32-bit indices")
    if dtype == torch.bfloat16 and aligned and n % TILE_N == 0 and k > 0:
        tiles = n // TILE_N
        cluster = max(c for c in range(1, MAX_CLUSTER + 1) if tiles % c == 0)
        per = tiles // cluster
        for wg, stages, ctas, multi in WGMMA_SHAPES:
            smem = _wgmma_smem(wg, stages, per)
            if (multi or per == 1) and smem <= min(SMEM_LIMIT, SM_SMEM // ctas - 1024):
                return OutputPlan("wgmma", cluster, per, 64 * wg, stages, smem, ctas=ctas)
    return OutputPlan("wmma" if dtype == torch.bfloat16 else "simt",
                      scratch=n > PANEL_SMEM_MAX_N)


def _tma_readable(t: torch.Tensor) -> bool:
    """Contiguous rows of a multiple of 16 bytes from a 16-byte aligned
    base (a single row's stride is never stepped)."""
    return (t.data_ptr() % 16 == 0
            and (t.shape[0] == 1 or t.stride(0) * t.element_size() % 16 == 0))


def _wgmma_readable(operands, vectors) -> bool:
    """Whether the wgmma variant can read these: the (M, ·) ``operands``
    by TMA, and the fp32 ``vectors`` (bias, gamma, beta) two floats at a
    time from 8-byte aligned bases."""
    return (all(_tma_readable(t) for t in operands)
            and all(t.data_ptr() % 8 == 0 for t in vectors))


def fused_output_ref(x, w, bias, residual, gamma, beta, *, keep_mask=None,
                     dropout_rate: float = 0.0, eps: float = 1e-5, out_dtype=None):
    """x (M, K) @ w (K, N) + bias, dropout by ``keep_mask`` (kept values
    scaled by 1 / (1 - rate)) when both are given, + residual, layernorm
    over N with gamma and beta; all in fp32, cast to ``out_dtype`` (default
    ``x.dtype``)."""
    acc = torch.matmul(x.float(), w.float()) + bias.float()
    if keep_mask is not None and dropout_rate > 0.0:
        acc = torch.where(keep_mask, acc / (1.0 - dropout_rate), 0.0)
    acc = acc + residual.float()
    mu = acc.mean(-1, keepdim=True)
    var = ((acc - mu) ** 2).mean(-1, keepdim=True)
    y = (acc - mu) * torch.rsqrt(var + eps)
    y = y * gamma.float() + beta.float()
    return y.to(out_dtype or x.dtype)


_CHECKED = False


def _library():
    """K7's library, its panel width checked against ``PANEL_SMEM_MAX_N``
    and its wgmma shared memory against ``_wgmma_smem`` once."""
    global _CHECKED
    lib = _build.load("fused_output")
    if not _CHECKED:
        if lib.fused_output_smem_max_n() != PANEL_SMEM_MAX_N:
            raise RuntimeError(f"fused_output: the source's panel width "
                               f"{lib.fused_output_smem_max_n()} is not {PANEL_SMEM_MAX_N}")
        for wg, stages, ctas, multi in WGMMA_SHAPES:
            for tiles in (1, 2, 5):
                got = lib.fused_output_wgmma_smem(wg, stages, ctas, tiles)
                want = _wgmma_smem(wg, stages, tiles) if multi or tiles == 1 else -1
                if got != want:
                    raise RuntimeError(f"fused_output: the source's wgmma shared memory {got} "
                                       f"at {(wg, stages, ctas, tiles)} is not the plan's {want}")
        _CHECKED = True
    return lib


def max_active_clusters(plan: OutputPlan, m: int, out_bf16: bool = True) -> int:
    """``cudaOccupancyMaxActiveClusters`` of a wgmma plan's launch at M rows
    (needs the card)."""
    import ctypes
    out = ctypes.c_int(0)
    err = _library().fused_output_max_clusters(plan.warpgroups, plan.stages, plan.ctas,
                                               plan.tiles, plan.cluster, -(-m // plan.rows),
                                               int(out_bf16), ctypes.byref(out))
    _build.check(err, "fused_output_max_clusters")
    return out.value


def fused_output(x, w, bias, residual, gamma, beta, *, keep_mask=None,
                 dropout_rate: float = 0.0, eps: float = 1e-5, out_dtype=None):
    """Listing 6: CPU tensors run ``fused_output_ref``; CUDA tensors launch
    K7 on ``fused_output_plan``'s variant.  On the card x (M, K), w (K, N)
    and residual (M, N) are contiguous and of one dtype (fp32 or bf16);
    bias, gamma and beta (N,) any float dtype (read in fp32); ``keep_mask``
    (M, N) bool or None; → (M, N) in ``out_dtype`` (default ``x.dtype``).
    Raises on anything the kernel does not take."""
    global LAUNCHES
    tensors = (x, w, bias, residual, gamma, beta, keep_mask)
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return fused_output_ref(x, w, bias, residual, gamma, beta, keep_mask=keep_mask,
                                dropout_rate=dropout_rate, eps=eps, out_dtype=out_dtype)
    if kinds != {"cuda"}:
        raise ValueError(f"fused_output tensors on {sorted(kinds)}: need all on cpu or all on cuda")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fused_output shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if residual.shape != (m, n) or any(t.shape != (n,) for t in (bias, gamma, beta)):
        raise ValueError(f"fused_output residual {tuple(residual.shape)}, bias/gamma/beta "
                         f"{[tuple(t.shape) for t in (bias, gamma, beta)]} for ({m}, {n})")
    if x.dtype not in _DTYPES or w.dtype != x.dtype or residual.dtype != x.dtype:
        raise ValueError(f"fused_output dtypes x {x.dtype}, w {w.dtype}, residual "
                         f"{residual.dtype}: need one of {_DTYPES}, all alike")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _DTYPES:
        raise ValueError(f"fused_output out_dtype {out_dtype}: need one of {_DTYPES}")
    if not (x.is_contiguous() and w.is_contiguous() and residual.is_contiguous()):
        raise ValueError("fused_output: x, w and residual must be contiguous")
    dropping = keep_mask is not None and dropout_rate > 0.0
    if dropping and (keep_mask.shape != (m, n) or keep_mask.dtype != torch.bool
                     or not keep_mask.is_contiguous()):
        raise ValueError(f"fused_output keep_mask {tuple(keep_mask.shape)} {keep_mask.dtype}:"
                         f" want a contiguous ({m}, {n}) bool")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"fused_output dropout_rate {dropout_rate}: need 0 <= rate < 1")
    if m == 0 or n == 0:
        return torch.empty(m, n, dtype=out_dtype, device=x.device)
    bias, gamma, beta = (t.float().contiguous() for t in (bias, gamma, beta))
    keep = keep_mask if dropping else None
    operands = (x, w, residual) + ((keep,) if dropping else ())
    plan = fused_output_plan(m, n, k, x.dtype, out_dtype,
                             aligned=_wgmma_readable(operands, (bias, gamma, beta)))
    out = _launch(plan, x, w, bias, residual, gamma, beta, keep, dropout_rate, eps, out_dtype)
    LAUNCHES += 1
    globals()[VARIANT_COUNTERS[plan.variant]] += 1
    return out


def _launch(plan: OutputPlan, x, w, bias, residual, gamma, beta, keep, dropout_rate, eps,
            out_dtype):
    """One launch of K7's C entry on ``plan``, for inputs ``fused_output``
    has checked (bias, gamma and beta fp32 and contiguous; ``keep`` None for
    no dropout) → (M, N) in ``out_dtype``.  Counts nothing."""
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty(m, n, dtype=out_dtype, device=x.device)
    scratch = None
    if plan.scratch:     # the wmma or simt row panel in device memory
        scratch = torch.empty(-(-m // 32) * 32, -(-n // 128) * 128, dtype=torch.float32,
                              device=x.device)
    vec = k % 8 == 0 and n % 8 == 0 and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    err = _library().fused_output(x.data_ptr(), w.data_ptr(), bias.data_ptr(), residual.data_ptr(),
                                  keep.data_ptr() if keep is not None else None, gamma.data_ptr(),
                                  beta.data_ptr(), out.data_ptr(),
                                  scratch.data_ptr() if scratch is not None else None,
                                  int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
                                  m, n, k, 1.0 / (1.0 - dropout_rate), eps, int(vec),
                                  VARIANTS[plan.variant], plan.cluster, plan.tiles,
                                  plan.warpgroups, plan.stages, plan.ctas, plan.smem,
                                  torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"fused_output ({plan.variant})")
    return out
