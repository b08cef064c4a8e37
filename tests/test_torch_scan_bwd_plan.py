"""K8's backward on the CPU: its launch plan and a torch model of the
kernel's algorithm (no GPU, no nvcc needed).

``mamba_scan.scan_bwd_plan`` gives the backward's grid (128 channels of one
row a block), static shared memory, chunks of ``SCAN_STEPS`` steps and the
workspaces the wrapper allocates.  ``emulate_scan_bwd`` below repeats the
kernel's walk in torch fp32: the chunks in reverse from the boundary states
the forward stores, each chunk's states recomputed with the forward's
decay 2^(dt · (A · log2 e)), the reverse step carrying g = dL/dh, dB and dC
summed over a warp's 32 channels by the kernel's butterfly, over the
block's four warps as (w0 + w1) + (w2 + w3) and over the channel blocks in
block order, dA and dD over the rows in row order.  It is held against the
port's plain ``mamba_scan_bwd_ref`` and ``jax.grad`` of the reference's
``mamba_scan_ref``: fp32 (rtol 1e-4, atol 1e-3), as
``tests/test_torch_mamba.py``'s gradients (the same recurrences, products,
exponentials and sums rounded in another order); bf16 inputs (2e-2, 2e-1)
(both sides compute in fp32 from the same bf16 values and round each
gradient of a bf16 input once).  A row's gradients do not depend on the
batch.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import mamba_scan as tscan
from repro_torch.kernels import ref as tref

LOG2E = 1.4426950408889634
F32_TOL = dict(rtol=1e-4, atol=1e-3)
BF16_TOL = dict(rtol=2e-2, atol=2e-1)
STEPS = tscan.SCAN_STEPS
BLOCK = 128                      # channels a block, one a thread


def _inputs(seed, b, l, d, n, dtype=torch.float32):
    """x, dt (positive), a (negative), b_in, c_in, d_skip, h0, dy and
    dh_final as torch tensors from a numpy seed (x, dt, b_in, c_in and dy
    in ``dtype``)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x, bi, ci = f(b, l, d), f(b, l, n), f(b, l, n)
    dt = torch.from_numpy((0.1 + rng.random((b, l, d))).astype(np.float32))
    a = torch.from_numpy((-rng.random((d, n))).astype(np.float32))
    dsk, h0, dy, dh = f(d), f(b, d, n), f(b, l, d), f(b, d, n)
    cast = lambda t: t.to(dtype)
    return cast(x), cast(dt), a, cast(bi), cast(ci), dsk, h0, cast(dy), dh


def emulate_forward_states(x, dt, a, b_in, h0=None, steps=STEPS):
    """The prefill's states entering each chunk of ``steps`` steps (B,
    chunks, D, N), stepped with the kernel's decay 2^(dt a2)."""
    bsz, l, dch = x.shape
    a2 = a.float() * LOG2E
    h = torch.zeros(bsz, dch, a.shape[1]) if h0 is None else h0.float().clone()
    bounds = []
    for t in range(l):
        if t % steps == 0:
            bounds.append(h)
        dv, xv = dt[:, t].float()[..., None], x[:, t].float()[..., None]
        h = h * torch.exp2(dv * a2) + (dv * xv) * b_in[:, t].float()[:, None, :]
    return torch.stack(bounds, 1)


def butterfly(v):
    """The kernel's warp sum of V values a lane over 32 lanes, v (..., 32,
    V) → (..., V): at offset O the lanes with bit O set keep the upper half
    and add their partner's upper half, the others the lower halves; one
    value left, it is added to the partner's.  Lane l ends with value l >>
    (5 - log2 V), which is read back from there."""
    values = width = v.shape[-1]
    lanes = torch.arange(32)
    o = 16
    while o >= 1:
        partner = lanes ^ o
        if width > 1:
            half = width // 2
            up = ((lanes & o) != 0)[:, None]
            lower, upper = v[..., :half], v[..., half:width]
            v = torch.where(up, upper, lower) + torch.where(up, lower, upper)[..., partner, :]
            width = half
        else:
            v = v + v[..., partner, :]
        o //= 2
    shift = 5 - int(math.log2(values))
    return v[..., [k << shift for k in range(values)], 0]


def emulate_scan_bwd(x, dt, a, b_in, c_in, d_skip, states, dy, dh_final=None, steps=STEPS):
    """The backward kernel's walk in torch fp32 (see the module docstring).
    → (dx, ddt, dA, dB, dC, dD, dh0) as ``mamba_scan_bwd_ref``'s."""
    bsz, l, dch = x.shape
    n = a.shape[1]
    gx = -(-dch // BLOCK)
    pad = gx * BLOCK - dch

    def chan(t):                 # pad the channel axis to whole blocks with zeros
        return torch.nn.functional.pad(t.float(), (0, pad)) if t.dim() < 4 else t

    xf, dtf, dyf = chan(x), chan(dt), chan(dy)
    av = torch.nn.functional.pad(a.float(), (0, 0, 0, pad))
    a2 = av * LOG2E
    dsk = torch.nn.functional.pad(d_skip.float(), (0, pad))
    bnd = torch.nn.functional.pad(states.float(), (0, 0, 0, pad))
    bf, cf = b_in.float(), c_in.float()
    g = (torch.zeros(bsz, gx * BLOCK, n) if dh_final is None
         else torch.nn.functional.pad(dh_final.float(), (0, 0, 0, pad)))
    dA = torch.zeros(bsz, gx * BLOCK, n)
    dD = torch.zeros(bsz, gx * BLOCK)
    dx, ddt = torch.zeros(bsz, l, gx * BLOCK), torch.zeros(bsz, l, gx * BLOCK)
    db, dc = torch.zeros(bsz, l, n), torch.zeros(bsz, l, n)
    for i in reversed(range(states.shape[1])):
        t0, t1 = i * steps, min(l, (i + 1) * steps)
        hs, h = [], bnd[:, i]
        for t in range(t0, t1):                      # the recompute
            dv, xv = dtf[:, t, :, None], xf[:, t, :, None]
            h = h * torch.exp2(dv * a2) + (dv * xv) * bf[:, t, None, :]
            hs.append(h)
        part = torch.zeros(bsz, gx, t1 - t0, 2 * n)
        for t in reversed(range(t0, t1)):            # the reverse walk
            k = t - t0
            hp = hs[k - 1] if k > 0 else bnd[:, i]
            dv, xv, dyv = dtf[:, t, :, None], xf[:, t, :, None], dyf[:, t, :, None]
            bv, cv = bf[:, t, None, :], cf[:, t, None, :]
            dec = torch.exp2(dv * a2)
            g = dyv * cv + g
            v = torch.cat([g * (dv * xv), dyv * hs[k]], -1)           # (B, Dp, 2N)
            p = dec * hp
            gb = torch.zeros(bsz, gx * BLOCK)
            gd = torch.zeros(bsz, gx * BLOCK)
            for s in range(n):
                gb = g[..., s] * bv[..., s] + gb
                gd = g[..., s] * (xv[..., 0] * bv[..., s] + av[:, s] * p[..., s]) + gd
            dA = (g * p) * dv + dA
            g = g * dec
            dD = dyv[..., 0] * xv[..., 0] + dD
            dx[:, t] = dv[..., 0] * gb + dsk * dyv[..., 0]
            ddt[:, t] = gd
            w = butterfly(v.view(bsz, gx, 4, 32, 2 * n))                  # (B, gx, 4, 2N)
            part[:, :, k] = (w[:, :, 0] + w[:, :, 1]) + (w[:, :, 2] + w[:, :, 3])
        total = part[:, 0]
        for j in range(1, gx):                       # the channel blocks in order
            total = total + part[:, j]
        db[:, t0:t1], dc[:, t0:t1] = total[..., :n], total[..., n:]
    da, dd = dA[0], dD[0]
    for r in range(1, bsz):                          # the rows in order
        da, dd = da + dA[r], dd + dD[r]
    return (dx[..., :dch].to(x.dtype), ddt[..., :dch].to(dt.dtype), da[:dch],
            db.to(b_in.dtype), dc.to(c_in.dtype), dd[:dch], g[:, :dch])


def _jax_grads(x, dt, a, bi, ci, dsk, h0, dy, dh):
    """jax.grad of the reference's mamba_scan_ref for cotangents (dy, dh)."""
    jdt = jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32
    cv = lambda t, d: jnp.asarray(t.float().numpy(), d)
    (_, _), vjp = jax.vjp(lambda *p: jref.mamba_scan_ref(*p[:6], h0=p[6]),
                          cv(x, jdt), cv(dt, jdt), cv(a, jnp.float32), cv(bi, jdt), cv(ci, jdt),
                          cv(dsk, jnp.float32), cv(h0, jnp.float32))
    return vjp((cv(dy, jdt), cv(dh, jnp.float32)))


NAMES = ("dx", "ddt", "da", "db", "dc", "dd", "dh0")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want, tol):
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(_np(g), _np(w), **tol, err_msg=name)


# --- the plan ---------------------------------------------------------------

def test_plan_at_falcon_mamba_training_layer():
    """B 2 x L 2048, D 8192, N 16, bf16: 64 channel blocks a row, 64 chunks
    of 32 steps, 20496 bytes of shared memory, 32 MiB of step states, the
    dB/dC partials of every (row, chunk, block) and the rows' dA/dD."""
    plan = tscan.scan_bwd_plan(2, 2048, 8192, 16, torch.bfloat16)
    assert plan.variant == "backward" and plan.threads == BLOCK
    assert plan.grid == (64, 2) and plan.chunks == 64
    assert plan.smem_bytes == 32 * 32 * 4 + 32 * 4 * 32 * 4 + 16 == 20496
    assert plan.ws_bytes == 2 * 64 * 32 * 16 * 128 * 4 == 32 * 2**20
    assert plan.partial_bytes == 2 * 64 * 64 * 32 * 32 * 4 + 2 * 8192 * 17 * 4
    assert plan.counters == 2 * 64 + 64


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b, l, d, n", [(4, 128, 128, 8), (2, 32, 128, 8), (1, 77, 200, 16),
                                        (3, 1, 100, 8), (2, 2048, 8192, 16)])
def test_grid_chunks_and_workspaces(b, l, d, n, dtype):
    """The reduced falcon-mamba (D 128, N 8) and ragged shapes: a block a
    128 channels of a row, ceil(L / 32) chunks, shared memory of one
    chunk's B and C and four warps' sums a step, workspaces by the sizes
    the kernel indexes; fp32 and bf16 alike."""
    plan = tscan.scan_bwd_plan(b, l, d, n, dtype)
    gx = -(-d // BLOCK)
    chunks = -(-l // STEPS)
    assert plan.grid == (gx, b) and plan.chunks == chunks
    assert plan.smem_bytes == STEPS * 2 * n * 4 * (1 + 4) + 16 <= 48 * 1024
    assert plan.ws_bytes == b * gx * STEPS * n * BLOCK * 4
    assert plan.partial_bytes == 4 * (b * chunks * gx * STEPS * 2 * n + b * d * (n + 1))
    assert plan.counters == b * chunks + gx


def test_what_the_backward_cannot_take_is_refused():
    with pytest.raises(ValueError, match="dtype"):
        tscan.scan_bwd_plan(1, 8, 64, 16, torch.float16)
    with pytest.raises(ValueError, match="state size"):
        tscan.scan_bwd_plan(1, 8, 64, 4, torch.float32)
    with pytest.raises(ValueError, match="at least one step"):
        tscan.scan_bwd_plan(1, 0, 64, 16, torch.float32)
    x, dt, a, bi, ci, dsk, h0, dy, dh = _inputs(0, 1, 4, 8, 8)
    states = torch.zeros(1, 1, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tscan.mamba_scan_bwd(x, dt, a, bi, ci, dsk, states, dy, dh_final=dh)


# --- the arithmetic ---------------------------------------------------------

def test_the_butterfly_leaves_each_lane_one_sum():
    """Lane l holds the sum over the 32 lanes of value l >> (5 - log2 V),
    for the 2N = 32 and 16 values of N 16 and 8."""
    gen = torch.Generator().manual_seed(0)
    for width in (32, 16):
        v = torch.randn(3, 32, width, generator=gen)
        got = butterfly(v)
        np.testing.assert_allclose(got.numpy(), v.sum(1).numpy(), rtol=1e-6, atol=1e-6)


def test_boundary_states_are_the_carried_state_of_the_chunked_scan():
    """The states the prefill stores entering each 32-step chunk (the
    kernel's decay) and those of the port's plain ``mamba_scan_chunked``
    equal the state the reference's ``mamba_scan_xla_chunked`` carries
    into that chunk: its final state over the first i chunks."""
    x, dt, a, bi, ci, dsk, h0, _, _ = _inputs(1, 2, 96, 16, 8)
    emulated = emulate_forward_states(x, dt, a, bi, h0)
    _, _, plain, chunk = tref.mamba_scan_chunked(x, dt, a, bi, ci, dsk, h0=h0, states=True)
    assert chunk == STEPS and emulated.shape == plain.shape == (2, 3, 16, 8)
    assert torch.equal(plain[:, 0], h0) and torch.equal(emulated[:, 0], h0)
    jargs = [jnp.asarray(t.numpy()) for t in (x, dt, a, bi, ci, dsk)]
    for i in range(1, 3):
        part = [t[:, :i * STEPS] if t.ndim == 3 else t for t in jargs]
        _, jh = jref.mamba_scan_xla_chunked(*part, h0=jnp.asarray(h0.numpy()), chunk=STEPS)
        np.testing.assert_allclose(emulated[:, i].numpy(), np.asarray(jh), atol=1e-4)
        np.testing.assert_allclose(plain[:, i].numpy(), np.asarray(jh), atol=1e-4)


@pytest.mark.parametrize("b, l, d, n, with_dh", [(2, 64, 128, 8, True), (1, 77, 200, 16, False),
                                                 (3, 40, 136, 16, True), (2, 1, 24, 8, True)])
def test_the_emulation_matches_the_plain_backward_and_jax_grad(b, l, d, n, with_dh):
    """Ragged L against the 32-step chunk, D not a multiple of a block (dead
    channels in the last block), N 8 and 16, from h0, with and without a
    cotangent on h_final."""
    x, dt, a, bi, ci, dsk, h0, dy, dh = _inputs(2 + l, b, l, d, n)
    dh = dh if with_dh else None
    states = emulate_forward_states(x, dt, a, bi, h0)
    got = emulate_scan_bwd(x, dt, a, bi, ci, dsk, states, dy, dh)
    plain = tref.mamba_scan_bwd_ref(x, dt, a, bi, ci, dsk, h0, states, dy, dh, chunk=STEPS)
    want = _jax_grads(x, dt, a, bi, ci, dsk, h0, dy, torch.zeros(b, d, n) if dh is None else dh)
    _close(got, plain, F32_TOL)
    _close(got, want, F32_TOL)
    _close(plain, want, F32_TOL)


def test_the_emulation_with_bf16_operands():
    x, dt, a, bi, ci, dsk, h0, dy, dh = _inputs(5, 2, 70, 128, 16, torch.bfloat16)
    states = emulate_forward_states(x, dt, a, bi, h0)
    got = emulate_scan_bwd(x, dt, a, bi, ci, dsk, states, dy, dh)
    assert [t.dtype for t in got] == [torch.bfloat16] * 2 + [torch.float32] + \
        [torch.bfloat16] * 2 + [torch.float32] * 2
    plain = tref.mamba_scan_bwd_ref(x, dt, a, bi, ci, dsk, h0, states, dy, dh, chunk=STEPS)
    _close(got, plain, BF16_TOL)
    _close(got, _jax_grads(x, dt, a, bi, ci, dsk, h0, dy, dh), BF16_TOL)


def test_a_row_does_not_depend_on_the_batch():
    """dx, ddt, dB, dC and dh0 of a row have the same bits at B 1 as at B
    3: the sums over D run over fixed lanes, warps and blocks; dA and dD
    add the rows' partials in row order."""
    x, dt, a, bi, ci, dsk, h0, dy, dh = _inputs(6, 3, 45, 200, 8)
    states = emulate_forward_states(x, dt, a, bi, h0)
    full = emulate_scan_bwd(x, dt, a, bi, ci, dsk, states, dy, dh)
    rows_a, rows_d = [], []
    for r in range(3):
        sl = slice(r, r + 1)
        one = emulate_scan_bwd(x[sl], dt[sl], a, bi[sl], ci[sl], dsk, states[sl], dy[sl], dh[sl])
        for k in (0, 1, 3, 4, 6):
            assert torch.equal(one[k], full[k][sl]), NAMES[k]
        rows_a.append(one[2])
        rows_d.append(one[5])
    assert torch.equal((rows_a[0] + rows_a[1]) + rows_a[2], full[2])
    assert torch.equal((rows_d[0] + rows_d[1]) + rows_d[2], full[5])
