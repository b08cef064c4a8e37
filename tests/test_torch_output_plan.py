"""K7's launch plan and its cluster layernorm, on the CPU.

``fused_output_plan`` (which variant runs Listing 6, and for ``wgmma`` the
thread-block cluster: CTAs along N, tiles and rows a CTA, ring stages and
shared memory) at bert-large's two output layers, at N 5120 and across the
widths a cluster holds; ``wmma`` for ragged N and for bf16 operands TMA
cannot read; ``simt`` for fp32; its refusals.  Then K7's plain version and a
torch model of the ``wgmma`` variant's layernorm (each CTA's row partials
in one fixed order, the cluster's in rank order, the mean and then the sum
of squares about it) against the reference's ``fused_output_pallas`` in
interpret mode, at a width that spans three cluster CTAs.  The kernels
themselves run only on the card (``chip_smoke.py`` phase 3).

Tolerances are ``tests/test_torch_fused_output.py``'s: fp32 rtol 1e-4 /
atol 1e-3, bf16 rtol 2e-2 / atol 2e-1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_output import fused_output_pallas
from repro_torch.kernels import fused_output as tfo

BF16, F32 = torch.bfloat16, torch.float32
F32_TOL = dict(rtol=1e-4, atol=1e-3)
BF16_TOL = dict(rtol=2e-2, atol=2e-1)
SMEM = 232448


@pytest.mark.parametrize("k", [4096, 1024])
@pytest.mark.parametrize("m", [1, 77, 4096, 8192])
def test_bert_large_layers_run_on_an_8_cta_cluster(m, k):
    p = tfo.fused_output_plan(m, 1024, k, BF16)
    assert p.variant == "wgmma"
    assert (p.cluster, p.cols, p.rows, p.stages, p.ctas) == (8, 128, 128, 3, 2)
    # two CTAs an SM: each within half of the SM's 228 KB less 1 KB reserved
    assert p.smem == 101376 <= tfo.SM_SMEM // 2 - 1024
    assert p.cluster * p.cols == 1024 and not p.scratch


@pytest.mark.parametrize("out", [BF16, F32])
def test_wide_n_keeps_five_tiles_a_cta_in_shared_memory(out):
    p = tfo.fused_output_plan(4096, 5120, 1024, BF16, out)
    assert p.variant == "wgmma"
    assert (p.cluster, p.tiles, p.cols, p.rows, p.stages, p.ctas) == (8, 5, 640, 64, 4, 1)
    # four of the five 64 x 128 tiles wait as fp32 (128 KB; the fifth stays in
    # registers) beside a 4-stage ring of 24 KB stages
    assert 4 * 64 * 128 * 4 == 128 * 1024 and (64 + 128) * 64 * 2 == 24 * 1024
    assert p.smem == 231936 <= SMEM


@pytest.mark.parametrize("n,cluster,tiles,rows", [
    (128, 1, 1, 128), (384, 3, 1, 128), (768, 6, 1, 128), (1024, 8, 1, 128),
    (1280, 5, 2, 64), (2048, 8, 2, 64), (3072, 8, 3, 64), (4096, 8, 4, 64),
    (5120, 8, 5, 64)])
def test_the_cluster_takes_the_most_ctas_that_divide_the_tiles(n, cluster, tiles, rows):
    p = tfo.fused_output_plan(512, n, 256, BF16)
    assert (p.variant, p.cluster, p.tiles, p.rows) == ("wgmma", cluster, tiles, rows)
    assert p.cluster * p.tiles * tfo.TILE_N == n
    assert p.smem == tfo._wgmma_smem(p.warpgroups, p.stages, p.tiles) <= SMEM
    shapes = {shape[:3]: shape[3] for shape in tfo.WGMMA_SHAPES}
    assert shapes[(p.warpgroups, p.stages, p.ctas)] or p.tiles == 1


def test_shared_memory_is_the_layout_of_the_source():
    # 1024 bytes of alignment slack, the ring and its barriers rounded to
    # 1 KB (the ring also carries the residual and keep boxes), an fp32
    # slot a tile with several tiles a CTA, two fp32 partials a row
    ring = 3 * (128 + 128) * 64 * 2 + 16 * 3 + 16
    assert tfo._wgmma_smem(2, 3, 1) == 1024 + -(-ring // 1024) * 1024 + 2 * 128 * 4
    assert tfo._wgmma_smem(1, 2, 5) - tfo._wgmma_smem(1, 2, 4) == 64 * 128 * 4
    # a tile's residual (two boxes) and keep mask (one) fit the ring's stages
    for wg, stages, _, _ in tfo.WGMMA_SHAPES:
        rows = 64 * wg
        per_stage = (rows + 128) * 64 * 2 // (rows * 128)
        assert -(-3 // per_stage) <= stages
    # every shape of the table fits at the widths the plan gives it
    for n in range(128, 8192 + 1, 128):
        p = tfo.fused_output_plan(64, n, 64, BF16)
        assert p.variant == "wmma" or p.smem <= min(SMEM, tfo.SM_SMEM // p.ctas - 1024)


@pytest.mark.parametrize("n", [130, 2000, 1408, 6144, 8192 + 128])
def test_widths_no_cluster_holds_run_on_wmma(n):
    p = tfo.fused_output_plan(4096, n, 1024, BF16)
    assert p.variant == "wmma"
    assert p.scratch == (n > tfo.PANEL_SMEM_MAX_N)


@pytest.mark.parametrize("n", [1024, 5120])
def test_misaligned_bf16_operands_run_on_wmma(n):
    p = tfo.fused_output_plan(4096, n, 1024, BF16, aligned=False)
    assert p.variant == "wmma" and p.scratch == (n > tfo.PANEL_SMEM_MAX_N)
    assert tfo.fused_output_plan(4096, n, 0, BF16).variant == "wmma"


def test_tma_readable_reads_base_and_row_stride():
    base = torch.zeros(64 * 1024 + 8, dtype=BF16)
    assert tfo._tma_readable(base[:64 * 1024].view(64, 1024))
    assert not tfo._tma_readable(base[1:64 * 1024 + 1].view(64, 1024))
    assert not tfo._tma_readable(torch.zeros(64, 1020, dtype=BF16))
    assert tfo._tma_readable(torch.zeros(1, 1020, dtype=BF16)[:, :1020]) == (
        torch.zeros(1, 1020, dtype=BF16).data_ptr() % 16 == 0)
    assert tfo._tma_readable(torch.zeros(64, 1024, dtype=torch.bool))
    assert not tfo._tma_readable(torch.zeros(64, 1000, dtype=torch.bool))


@pytest.mark.parametrize("odd", ["bias", "gamma", "beta"])
def test_vectors_4_bytes_off_8_send_bf16_to_wmma(odd):
    """wgmma reads bias, gamma and beta two floats at a time: a vector sliced
    at an odd element of a flat fp32 buffer is not wgmma-readable."""
    m, n, k = 4096, 1024, 1024
    flat = torch.zeros(4 * n, dtype=F32)
    assert flat.data_ptr() % 8 == 0
    operands = (torch.zeros(m, k, dtype=BF16), torch.zeros(k, n, dtype=BF16),
                torch.zeros(m, n, dtype=BF16), torch.zeros(m, n, dtype=torch.bool))
    names = ("bias", "gamma", "beta")
    aligned = [flat[i * n:(i + 1) * n] for i in range(3)]
    assert tfo._wgmma_readable(operands, aligned)
    assert tfo.fused_output_plan(m, n, k, BF16, aligned=True).variant == "wgmma"
    vectors = [flat[i * n + 1:(i + 1) * n + 1] if name == odd else aligned[i]
               for i, name in enumerate(names)]
    assert not tfo._wgmma_readable(operands, vectors)
    assert tfo.fused_output_plan(m, n, k, BF16, aligned=tfo._wgmma_readable(operands, vectors)
                                 ).variant == "wmma"


@pytest.mark.parametrize("n,k", [(1024, 4096), (1024, 1024), (5120, 1024), (130, 64)])
def test_fp32_runs_on_simt(n, k):
    p = tfo.fused_output_plan(4096, n, k, F32)
    assert p.variant == "simt" and p.scratch == (n > tfo.PANEL_SMEM_MAX_N)
    assert tfo.fused_output_plan(4096, n, k, F32, BF16).variant == "simt"


@pytest.mark.parametrize("args,kw", [
    ((64, 128, 64, torch.float16), {}),
    ((64, 128, 64, BF16, torch.int8), {}),
    ((0, 128, 64, BF16), {}),
    ((64, 0, 64, BF16), {}),
    ((64, 128, -1, BF16), {}),
    ((2 ** 20, 4096, 64, BF16), {}),
])
def test_the_plan_refuses_what_no_variant_takes(args, kw):
    with pytest.raises(ValueError):
        tfo.fused_output_plan(*args, **kw)


def _inputs(seed, m, k, n, rate):
    rng = np.random.default_rng(seed)
    return dict(x=rng.normal(size=(m, k)).astype(np.float32),
                w=rng.normal(size=(k, n)).astype(np.float32),
                bias=rng.normal(size=(n,)).astype(np.float32),
                residual=rng.normal(size=(m, n)).astype(np.float32),
                gamma=rng.normal(size=(n,)).astype(np.float32),
                beta=rng.normal(size=(n,)).astype(np.float32),
                keep_mask=rng.random((m, n)) > rate)


def _cast(arrays, dtype):
    cast = ("x", "w", "residual")
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ja = {k: jnp.asarray(v, jdt) if k in cast else jnp.asarray(v) for k, v in arrays.items()}
    ta = {k: torch.from_numpy(v).to(getattr(torch, dtype)) if k in cast else torch.from_numpy(v)
          for k, v in arrays.items()}
    return ja, ta


def cluster_layernorm_model(x, w, bias, residual, gamma, beta, *, keep_mask, dropout_rate, plan,
                            eps=1e-5, product=None):
    """The wgmma variant's arithmetic after the product, in torch fp32: the
    epilogue (bias, keep mask at the scale, residual) in the accumulator,
    each CTA's partial of each row summed by its threads in the kernel's
    order (a thread's columns 8 j + 2 (lane % 4) + {0, 1}, tile by tile, then
    the four lanes of a row as (l0 + l1) + (l2 + l3)), the cluster's
    partials in rank order, the mean, the same for the sum of squares about
    it, then y.  ``product``: x @ w already taken (the kernel's mainloop
    sums a row in one order whatever M is; the CPU's matmul need not)."""
    acc = (torch.matmul(x.float(), w.float()) if product is None else product) + bias.float()
    scale = torch.tensor(1.0 / (1.0 - dropout_rate), dtype=torch.float32)
    acc = torch.where(keep_mask, acc * scale, 0.0) + residual.float()
    m, n = acc.shape
    cols = plan.cols

    def total(v):
        out = torch.zeros(m)
        for rank in range(plan.cluster):
            lanes = []
            for lane in range(4):
                s = torch.zeros(m)
                for t in range(plan.tiles):
                    n0 = rank * cols + t * tfo.TILE_N
                    for j in range(tfo.TILE_N // 8):
                        c = n0 + 8 * j + 2 * lane
                        s = s + v[:, c]
                        s = s + v[:, c + 1]
                lanes.append(s)
            out = out + ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3]))
        return out

    mu = total(acc) / n
    var = total((acc - mu[:, None]) ** 2) / n
    rstd = torch.rsqrt(var + eps)
    return (acc - mu[:, None]) * rstd[:, None] * gamma.float() + beta.float()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_and_cluster_model_match_pallas_across_three_ctas(dtype):
    m, k, n, rate = 64, 128, 384, 0.3
    arrays = _inputs(27, m, k, n, rate)
    ja, ta = _cast(arrays, dtype)
    want = np.asarray(fused_output_pallas(**ja, dropout_rate=rate, bm=16, bk=32, bn=64,
                                          interpret=True), np.float32)
    plain = tfo.fused_output(**ta, dropout_rate=rate)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(plain.float().numpy(), want, **tol)
    plan = tfo.fused_output_plan(m, n, k, BF16)
    assert (plan.variant, plan.cluster, plan.tiles) == ("wgmma", 3, 1)
    model = cluster_layernorm_model(**ta, dropout_rate=rate, plan=plan)
    np.testing.assert_allclose(model.numpy(), np.asarray(want, np.float32),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))
    np.testing.assert_allclose(model.numpy(), tfo.fused_output_ref(
        **ta, dropout_rate=rate, out_dtype=torch.float32).numpy(), **F32_TOL)


def test_cluster_model_rows_do_not_depend_on_their_neighbours():
    """The kernel's rows at M 1 equal the same rows at M 64 bit for bit: the
    epilogue and the layernorm's order never mix rows (the card checks the
    kernel itself, ``chip_smoke.py`` phase 3)."""
    arrays = _inputs(28, 64, 64, 1024, 0.1)
    _, ta = _cast(arrays, "float32")
    plan = tfo.fused_output_plan(64, 1024, 64, BF16)
    product = torch.matmul(ta["x"], ta["w"])
    full = cluster_layernorm_model(**ta, dropout_rate=0.1, plan=plan, product=product)
    for r in (0, 17, 63):
        one = {k: (v[r:r + 1] if k in ("x", "residual", "keep_mask") else v) for k, v in ta.items()}
        got = cluster_layernorm_model(**one, dropout_rate=0.1, plan=plan, product=product[r:r + 1])
        assert torch.equal(got[0], full[r])
