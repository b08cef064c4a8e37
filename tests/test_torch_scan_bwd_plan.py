"""K8's backward on the CPU: its launch plan and a torch model of the
kernel's algorithm (no GPU, no nvcc needed).

``mamba_scan.scan_bwd_plan`` gives the backward's grid (128 / (n / 4)
channels of one row a block, n / 4 lanes a channel: four states a thread),
dynamic shared memory, resident blocks and waves, chunks of ``SCAN_STEPS`` steps walked in
sub-chunks of ``SCAN_BWD_SUB`` and the workspaces the wrapper allocates.
``emulate_scan_bwd`` below repeats the kernel's walk in torch fp32: the
chunks in reverse from the boundary states the forward stores; in each
chunk one walk from the boundary state to the states entering its
sub-chunks, then each sub-chunk in reverse recomputed from its entry state
with the forward's decay 2^(dt · (A · log2 e)) and walked back carrying g
= dL/dh; dx's sum Σ g B and ddt's Σ A g a h_{t-1} (ddt = x Σ g B + Σ A g a
h_{t-1}) over a channel's states in the fixed tree (groups of 4 states in
order, the groups pairwise), dB and dC summed over a
block's channels once a step in four interleaved runs, (r0 + r1) + (r2 +
r3), and over the channel blocks in block order, dA and dD over the rows
in row order.  It is held against the port's plain ``mamba_scan_bwd_ref``
and ``jax.grad`` of the reference's ``mamba_scan_ref``: fp32 (rtol 1e-4,
atol 1e-3), as ``tests/test_torch_mamba.py``'s gradients (the same
recurrences, products, exponentials and sums rounded in another order);
bf16 inputs (2e-2, 2e-1) (both sides compute in fp32 from the same bf16
values and round each gradient of a bf16 input once).  A row's gradients
do not depend on the batch.
"""
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
SUB = tscan.SCAN_BWD_SUB
THREADS = 128


def channels(n):
    """Channels a block: 128 threads, n / 4 lanes a channel."""
    return THREADS // (n // 4)


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


def state_sum(u, v):
    """sum_n u v over the last axis (N) in the kernel's tree: each group of
    4 states a product and three multiply-adds in order, the groups added
    pairwise (the lanes' shuffles at offsets 1, 2)."""
    parts = []
    for q in range(u.shape[-1] // 4):
        p = u[..., 4 * q] * v[..., 4 * q]
        for s in range(1, 4):
            p = u[..., 4 * q + s] * v[..., 4 * q + s] + p
        parts.append(p)
    w = 1
    while w < len(parts):
        for q in range(0, len(parts) - w, 2 * w):
            parts[q] = parts[q] + parts[q + w]
        w *= 2
    return parts[0]


def block_sum(v):
    """v (..., CH, K) → (..., K): the kernel's sum over a block's CH
    channels, four interleaved runs in channel order, then (r0 + r1) + (r2
    + r3)."""
    runs = [v[..., r, :] for r in range(4)]
    for c in range(4, v.shape[-2], 4):
        runs = [runs[r] + v[..., c + r, :] for r in range(4)]
    return (runs[0] + runs[1]) + (runs[2] + runs[3])


def emulate_scan_bwd(x, dt, a, b_in, c_in, d_skip, states, dy, dh_final=None, steps=STEPS,
                     sub=SUB):
    """The backward kernel's walk in torch fp32 (see the module docstring).
    → (dx, ddt, dA, dB, dC, dD, dh0) as ``mamba_scan_bwd_ref``'s."""
    bsz, l, dch = x.shape
    n = a.shape[1]
    ch = channels(n)
    gx = -(-dch // ch)
    pad = gx * ch - dch

    def chan(t):                 # pad the channel axis to whole blocks with zeros
        return torch.nn.functional.pad(t.float(), (0, pad))

    xf, dtf, dyf = chan(x), chan(dt), chan(dy)
    av = torch.nn.functional.pad(a.float(), (0, 0, 0, pad))
    a2 = av * LOG2E
    dsk = torch.nn.functional.pad(d_skip.float(), (0, pad))
    bnd = torch.nn.functional.pad(states.float(), (0, 0, 0, pad))
    bf, cf = b_in.float(), c_in.float()
    g = (torch.zeros(bsz, gx * ch, n) if dh_final is None
         else torch.nn.functional.pad(dh_final.float(), (0, 0, 0, pad)))
    dA = torch.zeros(bsz, gx * ch, n)
    dD = torch.zeros(bsz, gx * ch)
    dx, ddt = torch.zeros(bsz, l, gx * ch), torch.zeros(bsz, l, gx * ch)
    db, dc = torch.zeros(bsz, l, n), torch.zeros(bsz, l, n)

    def walk(h, t):              # the forward's step: h a_t + (dt x) B_t
        dv, xv = dtf[:, t, :, None], xf[:, t, :, None]
        dec = torch.exp2(dv * a2)
        return h * dec + (dv * xv) * bf[:, t, None, :], dec

    for i in reversed(range(states.shape[1])):
        t0, t1 = i * steps, min(l, (i + 1) * steps)
        subs = -(-(t1 - t0) // sub)
        entry, h = [bnd[:, i]], bnd[:, i]            # the walk to each sub-chunk's entry
        for t in range(t0, t0 + (subs - 1) * sub):
            h = walk(h, t)[0]
            if (t - t0) % sub == sub - 1:
                entry.append(h)
        part = torch.zeros(bsz, gx, t1 - t0, 2 * n)
        for k in reversed(range(subs)):
            u0, u1 = t0 + k * sub, min(t1, t0 + (k + 1) * sub)
            hs, decs, h = [], [], entry[k]
            for t in range(u0, u1):                  # the recompute into registers
                h, dec = walk(h, t)
                hs.append(h)
                decs.append(dec)
            for t in reversed(range(u0, u1)):        # the reverse walk
                u = t - u0
                hp = hs[u - 1] if u > 0 else entry[k]
                dv, xv, dyv = dtf[:, t, :, None], xf[:, t, :, None], dyf[:, t, :, None]
                bv, cv = bf[:, t, None, :], cf[:, t, None, :]
                g = dyv * cv + g
                v = torch.cat([g * (dv * xv), dyv * hs[u]], -1)           # (B, Dp, 2N)
                r = g * (decs[u] * hp)                    # g a_t h_{t-1}
                gb = state_sum(g, bv)
                gd = state_sum(av.expand_as(r), r)
                dA = r * dv + dA
                g = g * decs[u]
                dD = dyv[..., 0] * xv[..., 0] + dD
                dx[:, t] = dv[..., 0] * gb + dsk * dyv[..., 0]
                ddt[:, t] = xv[..., 0] * gb + gd
                part[:, :, t - t0] = block_sum(v.view(bsz, gx, ch, 2 * n))
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
    """B 2 x L 2048, D 8192, N 16, bf16: 4 lanes a channel, 32 channels a
    block, 512 blocks of 4 warps, 4 an SM by their 51264 bytes of shared
    memory: one wave on 132 SMs, 12 to 16 warps on every SM; 64 chunks of
    32 steps in sub-chunks of 4; the dB/dC sums of every (row, chunk,
    block) and the rows' dA/dD, which a second launch adds; no step
    workspace and no counters."""
    plan = tscan.scan_bwd_plan(2, 2048, 8192, 16, torch.bfloat16)
    assert plan.variant == "backward" and plan.threads == THREADS
    assert plan.grid == (256, 2)
    assert plan.smem_bytes == 8 * 32 * 32 * 2 + 32 * 32 * 4 + (7 + 2 * 4) * 128 * 16 + 64 == 51264
    assert plan.blocks_per_sm == 4 and plan.waves == 1
    blocks = plan.grid[0] * plan.grid[1]
    assert 4 * (blocks // 132) >= 8 and blocks <= 132 * plan.blocks_per_sm
    assert plan.chunks == 64 and SUB == 4
    assert plan.partial_bytes == 2 * 64 * 256 * 32 * 32 * 4 + 2 * 8192 * 17 * 4
    assert "ws_bytes" not in plan._fields and "counters" not in plan._fields


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b, l, d, n", [(4, 128, 128, 8), (2, 32, 128, 8), (1, 77, 200, 16),
                                        (3, 1, 100, 8), (2, 2048, 8192, 16),
                                        (1, 2048, 8192, 16), (4, 2048, 8192, 16)])
def test_grid_chunks_and_workspaces(b, l, d, n, dtype):
    """The reduced falcon-mamba (D 128, N 8), ragged shapes and the
    training layer at B 1, 2 and 4: a block of 128 / (n / 4) channels of a
    row, ceil(L / 32) chunks, shared memory of three operand rows in two
    buffers, a chunk's dx and ddt, its B and C, the states entering each sub-chunk and a
    sub-chunk's dB and dC terms (64 bytes between these put their banks 16
    apart),
    resident blocks by shared memory within the register budget's 4,
    waves on 132 SMs, workspaces by the sizes the kernel indexes."""
    plan = tscan.scan_bwd_plan(b, l, d, n, dtype)
    size = 2 if dtype == torch.bfloat16 else 4
    ch = channels(n)
    gx = -(-d // ch)
    chunks = -(-l // STEPS)
    assert plan.grid == (gx, b) and plan.chunks == chunks
    assert plan.smem_bytes == (8 * STEPS * ch * size + STEPS * 2 * n * 4
                               + (STEPS // SUB - 1 + 2 * SUB) * 128 * 16 + 64)
    assert plan.blocks_per_sm == min(4, 233472 // (plan.smem_bytes + 1024))
    assert plan.waves == -(-gx * b // (132 * plan.blocks_per_sm))
    assert plan.partial_bytes == 4 * (b * chunks * gx * STEPS * 2 * n + b * d * (n + 1))


@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("d, n", [(128, 8), (8192, 16)])
def test_the_lane_choice(b, d, n):
    """Four states a thread at every batch: 2 lanes at the reduced D 128, N
    8 (64 channels a block, 3 blocks an SM in bf16), 4 at D 8192, N 16 (32
    channels, 4 an SM); at D 8192 B 1 fills 256 of the 528 block slots, B 2
    512 in one wave, B 4 two waves."""
    plan = tscan.scan_bwd_plan(b, 2048, d, n, torch.bfloat16)
    assert channels(n) == {8: 64, 16: 32}[n]
    assert plan.blocks_per_sm == (3 if n == 8 else 4)
    assert plan.grid == (d // channels(n), b)
    if d == 8192:
        assert plan.waves == {1: 1, 2: 1, 4: 2}[b]


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


@pytest.mark.parametrize("what, vec", [("aligned", True), ("odd base", False),
                                       ("odd step stride", False), ("odd D", False),
                                       ("one step", True)])
def test_which_rows_take_16_byte_copies(what, vec):
    """x, dt and dy are staged by 16-byte copies only where every base,
    (batch, step) stride and D·size is a multiple of 16 bytes; an axis of
    one carries no stride."""
    base = torch.zeros(2, 3, 72, dtype=torch.bfloat16)
    if what == "aligned":
        t = base[..., 8:72]
    elif what == "odd base":
        t = base[..., 1:65]
    elif what == "odd step stride":
        t = torch.zeros(2, 3, 68, dtype=torch.bfloat16)[..., :64]
    elif what == "odd D":
        t = torch.zeros(2, 3, 60, dtype=torch.bfloat16)
    else:   # a step stride of 136 bytes, on an axis of one
        t = torch.zeros(2 * 72, dtype=torch.bfloat16).as_strided((2, 1, 64), (72, 68, 1))
    ok = torch.zeros(2, t.shape[1], t.shape[2], dtype=torch.bfloat16)
    assert tscan._rows_vectorisable(t, ok, ok) == vec
    assert tscan._rows_vectorisable(ok, ok, t) == vec


# --- the arithmetic ---------------------------------------------------------

@pytest.mark.parametrize("n", [8, 16])
def test_the_state_sum_tree(n):
    """dx's and ddt's sum over a channel's states: each group of 4 in order
    (a product, three multiply-adds), then the groups pairwise, as the
    lanes' shuffles add them; bitwise the same order written out in numpy
    float32, and the sum to rounding."""
    rng = np.random.default_rng(n)
    u, v = rng.normal(size=(2, 7, n)).astype(np.float32)
    got = state_sum(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    parts = []
    for q in range(n // 4):
        p = u[:, 4 * q] * v[:, 4 * q]
        for s in range(1, 4):
            p = np.float32(u[:, 4 * q + s] * v[:, 4 * q + s]) + p
        parts.append(p)
    want = (parts[0] + parts[1]) if n == 8 else (parts[0] + parts[1]) + (parts[2] + parts[3])
    assert np.array_equal(got, want)
    np.testing.assert_allclose(got, (u.astype(np.float64) * v).sum(-1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [8, 16])
def test_the_block_sum_order(n):
    """dB's and dC's sum over a block's channels (32 at N 16, 64 at N 8):
    four runs over channels c = r, r + 4, ... in order, then (r0 + r1) +
    (r2 + r3); bitwise that order written out in numpy float32, and the
    sum to rounding."""
    ch = channels(n)
    rng = np.random.default_rng(ch)
    v = rng.normal(size=(3, ch, 2 * n)).astype(np.float32)
    got = block_sum(torch.from_numpy(v)).numpy()
    runs = [v[:, r].copy() for r in range(4)]
    for c in range(4, ch, 4):
        for r in range(4):
            runs[r] = runs[r] + v[:, c + r]
    assert np.array_equal(got, (runs[0] + runs[1]) + (runs[2] + runs[3]))
    np.testing.assert_allclose(got, v.astype(np.float64).sum(1), rtol=1e-5, atol=1e-5)


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
                                                 (3, 40, 136, 16, True), (2, 1, 24, 8, True),
                                                 (2, 45, 40, 16, True)])
def test_the_emulation_matches_the_plain_backward_and_jax_grad(b, l, d, n, with_dh):
    """Ragged L against the 32-step chunk and its 4-step sub-chunks, D not
    a multiple of a block (dead channels in the last block: 200 and 136 at
    32 channels a block, 24 at 64, 40 one block and a quarter), N 8 and 16,
    from h0, with and without a cotangent on h_final."""
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
    3: the sums over D run over fixed lanes, channels and blocks, and the
    lanes do not depend on B; dA and dD add the rows' partials in row
    order."""
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
