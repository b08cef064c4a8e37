"""K8's launch plan and the arithmetic of its redesigned kernels on the CPU
(no GPU, no nvcc needed).

``mamba_scan.scan_plan`` names the kernel a call runs: ``decode`` for one
step (L = 1), ``prefill`` otherwise, with its lanes a channel (1 or 2 for
the prefill), grid, shared memory, blocks resident an SM and waves on an
H100's 132 SMs.
``emulate_scan`` below repeats the kernels' arithmetic in torch fp32: the
decay as 2^(dt · (A · log2 e)), the state update h·decay + (dt·x)·B, y's sum
over the states as one fixed tree (groups of 4 in order, the groups
pairwise) plus D·x, and the prefill's walk over chunks of ``SCAN_STEPS``
steps.  It is held against the reference's ``mamba_scan_pallas`` in
interpret mode and the port's plain ``mamba_scan_ref``: fp32 atol 1e-4 (as
``tests/test_torch_mamba.py``: the same recurrence, products and
exponentials rounded in another order), bf16 inputs rtol 1e-2 / atol 1e-2
(both sides compute in fp32 from the same bf16 values and differ by the
output's one bf16 rounding).  Padded steps (dt = 0, x = 0) leave a state
bitwise unchanged, and a row's bits do not depend on the batch.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import mamba_scan_pallas
from repro_torch.kernels import mamba_scan as tscan
from repro_torch.kernels import ref as tref

F32_ATOL = 1e-4
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
SMS, SM_SMEM, RESERVED = 132, 233472, 1024      # an H100 SXM: SMs, shared bytes an SM, a block's
LOG2E = 1.4426950408889634


def _inputs(seed, b, l, d, n):
    """x, dt (positive), a (negative), b_in, c_in, d_skip as fp32 numpy."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, l, d)).astype(np.float32),
            (0.1 + rng.random((b, l, d))).astype(np.float32),
            (-rng.random((d, n))).astype(np.float32),
            rng.normal(size=(b, l, n)).astype(np.float32),
            rng.normal(size=(b, l, n)).astype(np.float32),
            rng.normal(size=(d,)).astype(np.float32)]


def _torch(args, dtype=torch.float32):
    x, dt, a, bi, ci, d = (torch.from_numpy(v) for v in args)
    return x.to(dtype), dt.to(dtype), a, bi.to(dtype), ci.to(dtype), d


def emulate_scan(x, dt, a, b_in, c_in, d_skip, h0=None, steps=tscan.SCAN_STEPS):
    """The kernels' arithmetic in fp32, chunk by chunk of ``steps`` steps:
    a2 = A log2 e once; per step, decay = 2^(dt a2), h = h decay + (dt x) B,
    y = tree(h C) + D x with the tree (g0 + g1) + (g2 + g3) over the groups
    of 4 states each summed in order.  → (y in x's dtype, h fp32)."""
    bsz, l, dch = x.shape
    n = a.shape[1]
    xf, dtf, bf, cf = x.float(), dt.float(), b_in.float(), c_in.float()
    a2 = a.float() * LOG2E
    h = torch.zeros(bsz, dch, n) if h0 is None else h0.float().clone()
    y = torch.empty(bsz, l, dch)
    for t0 in range(0, l, steps):
        for t in range(t0, min(t0 + steps, l)):
            dv, xv = dtf[:, t, :, None], xf[:, t, :, None]
            h = h * torch.exp2(dv * a2) + (dv * xv) * bf[:, t, None, :]
            hc = h * cf[:, t, None, :]
            groups = [hc[..., 4 * g] for g in range(n // 4)]
            for g in range(n // 4):
                for s in range(1, 4):
                    groups[g] = groups[g] + hc[..., 4 * g + s]
            while len(groups) > 1:
                groups = [groups[i] + groups[i + 1] for i in range(0, len(groups), 2)]
            y[:, t] = groups[0] + d_skip.float() * xf[:, t]
    return y.to(x.dtype), h


# --- the plan ---------------------------------------------------------------

@pytest.mark.parametrize("l, variant", [(1, "decode"), (2, "prefill"), (77, "prefill"),
                                        (512, "prefill")])
def test_the_variant_is_named_by_the_length(l, variant):
    for b in (1, 4, 8):
        assert tscan.scan_plan(b, l, 8192, 16, torch.bfloat16).variant == variant


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b, l, d, n", [(4, 512, 8192, 16), (1, 512, 8192, 16), (2, 100, 8192, 16),
                                        (2, 40, 128, 8), (3, 65, 104, 16), (8, 1, 8192, 16),
                                        (2, 1, 100, 8)])
def test_grid_and_shared_bytes(b, l, d, n, dtype):
    plan = tscan.scan_plan(b, l, d, n, dtype)
    size = torch.finfo(dtype).bits // 8
    channels = plan.threads // plan.lanes
    assert plan.threads == 128 and plan.lanes in ((n // 4,) if l == 1 else (1, 2))
    assert plan.grid == (-(-d // channels), b)
    if l == 1:
        assert plan.variant == "decode" and plan.lanes == n // 4 and plan.smem_bytes == 0
    else:
        # x and dt of two chunks in their own type, one chunk's B and C in fp32
        steps = tscan.SCAN_STEPS
        assert plan.smem_bytes == 2 * 2 * steps * channels * size + steps * 2 * n * 4
        assert plan.blocks_per_sm * (plan.smem_bytes + RESERVED) <= SM_SMEM
    assert plan.waves == -(-math.prod(plan.grid) // (SMS * plan.blocks_per_sm))


def test_falcon_mamba_prefill_is_one_wave():
    """falcon-mamba-7b's B 4 x 512 prefill (D 8192, N 16, bf16): every block
    resident at once on 132 SMs at 228 KB an SM, and so its batch-1
    prefill, each on the lanes that measured fastest."""
    four = tscan.scan_plan(4, 512, 8192, 16, torch.bfloat16)
    one = tscan.scan_plan(1, 512, 8192, 16, torch.bfloat16)
    assert (four.variant, four.lanes, one.lanes) == ("prefill", 1, 2)
    for plan in (four, one):
        assert plan.waves == 1
        assert math.prod(plan.grid) <= SMS * plan.blocks_per_sm
        assert plan.blocks_per_sm * (plan.smem_bytes + RESERVED) <= SM_SMEM


def test_decode_at_the_engine_and_loop_batches():
    for b in (1, 3, 4, 8):
        plan = tscan.scan_plan(b, 1, 8192, 16, torch.bfloat16)
        assert plan.variant == "decode" and plan.lanes == 4 and plan.grid == (256, b)
        assert plan.waves == 1


def test_what_the_kernels_cannot_read_is_refused():
    with pytest.raises(ValueError, match="dtype"):
        tscan.scan_plan(1, 8, 64, 16, torch.float16)
    with pytest.raises(ValueError, match="state size"):
        tscan.scan_plan(1, 8, 64, 12, torch.float32)
    with pytest.raises(ValueError, match="at least one step"):
        tscan.scan_plan(1, 0, 64, 16, torch.float32)
    with pytest.raises(ValueError, match="16-byte vectors"):
        tscan.scan_plan(1, 8, 100, 16, torch.bfloat16)     # 200-byte rows
    # one step reads x and dt element by element
    assert tscan.scan_plan(1, 1, 100, 16, torch.bfloat16).variant == "decode"


@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_the_prefill_takes_two_lanes_only_where_one_leaves_the_card_idle(b):
    """1 lane a channel where 8 resident blocks an SM of that grid would
    fill 7/8 of the 132 SMs, else 2 (the grid twice as wide)."""
    plan = tscan.scan_plan(b, 512, 8192, 16, torch.bfloat16)
    one_lane_blocks = 8192 // 128 * b
    assert plan.lanes == (1 if 8 * one_lane_blocks >= 7 * SMS else 2)
    assert math.prod(plan.grid) == one_lane_blocks * plan.lanes


def test_the_plan_register_budgets_are_the_source_budgets():
    """The blocks an SM the plan counts for each lane count are the
    source's MinBlocks, and the source instantiates no other lane count."""
    src = (Path(tscan.__file__).resolve().parent / "csrc" / "mamba_scan.cu").read_text()
    found = re.findall(r"struct MinBlocks<(\d+)> \{ static constexpr int value = (\d+); \};", src)
    assert {int(k): int(v) for k, v in found} == tscan._MIN_BLOCKS


def test_the_plan_steps_are_the_source_steps():
    src = (Path(tscan.__file__).resolve().parent / "csrc" / "mamba_scan.cu").read_text()
    assert re.findall(r"constexpr int kSteps = (\d+);", src) == [str(tscan.SCAN_STEPS)]


# --- the arithmetic ---------------------------------------------------------

@pytest.mark.parametrize("b, l, d, n, chunk", [(2, 64, 16, 8, 16), (2, 72, 24, 16, 24),
                                               (1, 40, 8, 16, 8)])
def test_the_emulation_matches_pallas_and_the_plain_version(b, l, d, n, chunk):
    args = _inputs(b + l, b, l, d, n)
    h0 = np.random.default_rng(l).normal(size=(b, d, n)).astype(np.float32)
    x, dt, a, bi, ci, dsk = _torch(args)
    y, h = emulate_scan(x, dt, a, bi, ci, dsk, torch.from_numpy(h0))
    jy, jh = mamba_scan_pallas(*map(jnp.asarray, args), h0=jnp.asarray(h0), chunk=chunk,
                               interpret=True)
    py, ph = tref.mamba_scan_ref(x, dt, a, bi, ci, dsk, h0=torch.from_numpy(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=F32_ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=F32_ATOL)
    np.testing.assert_allclose(y.numpy(), py.numpy(), atol=F32_ATOL)
    np.testing.assert_allclose(h.numpy(), ph.numpy(), atol=F32_ATOL)


def test_the_emulation_with_bf16_inputs():
    x, dt, a, bi, ci, dsk = _torch(_inputs(4, 2, 48, 32, 16), torch.bfloat16)
    y, h = emulate_scan(x, dt, a, bi, ci, dsk)
    py, ph = tref.mamba_scan_ref(x, dt, a, bi, ci, dsk)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), py.float().numpy(), **BF16_TOL)
    np.testing.assert_allclose(h.numpy(), ph.numpy(), **BF16_TOL)


def test_padded_steps_leave_the_state_bitwise():
    """dt = 0 and x = 0 make a step the identity: 2^0 is exactly 1, so the
    engine's bucket-padded prefill leaves the unpadded prompt's state."""
    b, l, pad, d, n = 2, 40, 24, 16, 16
    x, dt, a, bi, ci, dsk = _torch(_inputs(9, b, l + pad, d, n))
    x[:, l:], dt[:, l:] = 0.0, 0.0
    _, h_pad = emulate_scan(x, dt, a, bi, ci, dsk)
    _, h = emulate_scan(x[:, :l], dt[:, :l], a, bi[:, :l], ci[:, :l], dsk)
    assert torch.equal(h_pad, h)


def test_a_row_does_not_depend_on_the_batch():
    x, dt, a, bi, ci, dsk = _torch(_inputs(10, 4, 50, 24, 16))
    h0 = torch.from_numpy(np.random.default_rng(11).normal(size=(4, 24, 16)).astype(np.float32))
    y, h = emulate_scan(x, dt, a, bi, ci, dsk, h0)
    for i in range(4):
        y1, h1 = emulate_scan(x[i:i + 1], dt[i:i + 1], a, bi[i:i + 1], ci[i:i + 1], dsk,
                              h0[i:i + 1])
        assert torch.equal(y1, y[i:i + 1]) and torch.equal(h1, h[i:i + 1])


def test_one_step_continues_the_prefill():
    """The decode kernel's one step from the prefill's state is the
    prefill's next step."""
    x, dt, a, bi, ci, dsk = _torch(_inputs(12, 2, 21, 16, 8))
    y, h = emulate_scan(x, dt, a, bi, ci, dsk)
    y20, h20 = emulate_scan(x[:, :20], dt[:, :20], a, bi[:, :20], ci[:, :20], dsk)
    y1, h1 = emulate_scan(x[:, 20:], dt[:, 20:], a, bi[:, 20:], ci[:, 20:], dsk, h20)
    assert torch.equal(torch.cat([y20, y1], 1), y) and torch.equal(h1, h)
