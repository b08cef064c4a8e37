"""K5 scheduled from a PARLOOPER spec string, and K13's plain version, on
the CPU, against the JAX reference (``repro.fusion``): Philox4x32-10's
known answers (Random123's ``kat_vectors``); ``build_nest_inputs`` and the
plan's output visit order against the reference's nest and its
``plan_pallas`` grid (read through ``out_specs.index_map``); the same
illegal schedules raising the same codes as the reference's interpret-mode
``compile``; the counter draw's zero pattern under every schedule equal to
interpret-mode Pallas; ``hw_prng=True``'s per-tile bits (deterministic,
order-free, tile-dependent, of the right keep share); the
``compile_with_vjp`` refusal; and the library helpers' schedule keywords
against the reference's ``*_apply(..., backend="pallas_interpret")``.

Tolerances: fp32 rtol 1e-4 / atol 1e-3 and bf16 rtol 2e-2 / atol 2e-1
(``tests/test_torch_fusion_autodiff.py``'s: sums in another order, one bf16
rounding); the counter draw's values rtol/atol 1e-5 and its zero pattern
exact (``tests/test_fusion.py``'s); survivors rtol 1e-6 (one fp32 scale).
"""
import dataclasses
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import fusion as jf
from repro.core import pallas_lowering as jlow
from repro.fusion import lowering as jlowering
from repro_torch import fusion as tf
from repro_torch.core.legality import LegalityError
from repro_torch.core.loops import ThreadedLoop
from repro_torch.fusion import lowering as tlowering
from repro_torch.fusion import rng as trng
from repro_torch.kernels import fused_gemm

M, K, N = 32, 64, 128
TILES = (16, 32, 64)
F32_TOL = dict(rtol=1e-4, atol=1e-3)
BF16_TOL = dict(rtol=2e-2, atol=2e-1)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _operands(graph, dtype="float32", seed=0, m=M, k=K, n=N):
    """numpy operands for ``graph`` → (jax dict, torch dict); rowvecs fp32."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    jops, tops = {}, {}
    for spec in graph.operands:
        shape = {"lhs": (k, m) if spec.trans else (m, k),
                 "rhs": (n, k) if spec.trans else (k, n), "crhs": (n, k),
                 "tile": (m, n), "mask": (m, n), "rowvec": (n,)}.get(spec.kind, ())
        if spec.kind == "mask":
            v = rng.random(shape) > 0.4
            jops[spec.name], tops[spec.name] = jnp.asarray(v), torch.from_numpy(v)
        elif spec.kind == "scalar":
            v = int(rng.integers(0, 2**31))
            jops[spec.name], tops[spec.name] = jnp.asarray(v, jnp.uint32), v
        else:
            v = rng.normal(size=shape).astype(np.float32)
            if spec.kind == "rowvec":
                jops[spec.name], tops[spec.name] = jnp.asarray(v), torch.from_numpy(v)
            else:
                jops[spec.name] = jnp.asarray(v, jdt)
                tops[spec.name] = torch.from_numpy(v).to(tdt)
    return jops, tops


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _rng_graph(f, rate=0.4, salt=5, name="g_rng_sched"):
    """tests/test_fusion.py's bare GEMM → dropout_rng graph."""
    return f.TppGraph.chain(name, [("dropout_rng", ("seed",), {"rate": rate, "salt": salt})],
                            [("x", "lhs"), ("w", "rhs"), ("seed", "scalar")])


# ---------------------------------------------------------------------------
# Philox4x32-10: Random123's known answers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox4x32_10_known_answers(ctr, key, want):
    assert tuple(int(w) for w in trng.philox4x32(ctr, key)) == want
    # broadcast over a tensor of counters: the same words in every lane
    got = trng.philox4x32((torch.full((3,), ctr[0]), *ctr[1:]), key)
    assert all(torch.equal(g, torch.full((3,), w)) for g, w in zip(got, want))


def test_hw_tile_bits_is_a_stream_over_the_tile():
    seed, salt = 1234, trng.derive_salt("k13")
    tile = trng.hw_tile_bits(seed, salt, (3, 8), offsets=(6, 16))
    for q in range(6):
        words = trng.philox4x32((6, 16, q, 0), (seed, salt))
        for lane in range(4):
            assert int(tile.flatten()[4 * q + lane]) == int(words[lane])
    # an array cut into tiles: each tile is its own stream
    bits = trng.hw_bits(seed, salt, (9, 24), (3, 8))
    assert torch.equal(bits[6:9, 16:24], tile)
    assert not torch.equal(bits[0:3, 0:8], trng.hw_tile_bits(seed, salt, (3, 8), offsets=(0, 8)))
    assert trng.HW_SCHEME == "philox4x32-10"


@pytest.mark.parametrize("tile", [(512, 256), (512, 512), (64, 128), (16, 4), (3, 12)])
def test_four_columns_of_a_row_are_one_philox_call(tile):
    """The invariant K5's shared draw rests on: where the PRNG tile's width
    is a multiple of 4, columns 4j..4j+3 of a row are the four words, in
    order, of one ``philox4x32`` call (counter (row0, col0, local / 4, 0))."""
    seed, salt = 99, trng.derive_salt("shared-draw")
    tm, tn = tile
    shape = (2 * tm, 2 * tn)
    bits = trng.hw_bits(seed, salt, shape, tile)
    for r in sorted({0, 1, tm - 1, tm, shape[0] - 1}):
        for j in sorted({0, 1, tn // 4 - 1, tn // 4, shape[1] // 4 - 1}):
            c = 4 * j
            row0, col0 = r - r % tm, c - c % tn
            local = (r - row0) * tn + (c - col0)
            assert local % 4 == 0
            words = trng.philox4x32((row0, col0, local // 4, 0), (seed, salt))
            assert [int(bits[r, c + i]) for i in range(4)] == [int(w) for w in words]


@pytest.mark.parametrize("tile", [(8, 6), (4, 10), (16, 2)])
def test_four_columns_split_across_calls_when_the_width_is_not_a_multiple_of_4(tile):
    """Why the generator keeps one call an element there: some aligned
    group of four columns takes words of two Philox calls."""
    seed, salt = 99, trng.derive_salt("shared-draw")
    tm, tn = tile
    bits = trng.hw_bits(seed, salt, (tm, 4 * tn), tile)
    split = False
    for r in range(tm):
        for c in range(0, 4 * tn, 4):
            locals_ = [(r % tm) * tn + (c + i) % tn for i in range(4)]
            split = split or len({(c + i - (c + i) % tn, q // 4) for i, q in enumerate(locals_)}) > 1
    assert split
    assert not fused_gemm.shares_draw(tf.simplify_graph(_rng_graph(tf)), True, tile)


def _lane_pair_draw(seed, salt, tile, row0, n0, bn):
    """A torch model of csrc/fused_gemm.cuh draw_tile's shared draw for one
    warp of a wgmma tile: lane t holds rows 16 w + t / 4 (acc[4g], [4g + 1])
    and + 8 (acc[4g + 2], [4g + 3]) at columns 8 g + 2 (t % 4) + {0, 1};
    the even lane of a pair draws row r's block of four columns, the odd
    lane row r + 8's, and each hands the other two words.  → the bits each
    (row, column) of the warp's 16 rows received."""
    tm, tn = tile
    got = {}
    for g in range(bn // 8):
        drawn = {}
        for lane in range(32):
            even = lane % 2 == 0
            gm = row0 + lane // 4 + (0 if even else 8)
            cb = n0 + 8 * g + 2 * (lane % 4) - (0 if even else 2)
            r0, c0 = gm - gm % tm, cb - cb % tn
            drawn[lane] = [int(w) for w in trng.philox4x32(
                (r0, c0, ((gm - r0) * tn + cb - c0) >> 2, 0), (seed, salt))]
        # what each lane hands its partner (__shfl_xor_sync(..., 1))
        send = {lane: (w[2], w[3]) if lane % 2 == 0 else (w[0], w[1]) for lane, w in drawn.items()}
        for lane in range(32):
            even = lane % 2 == 0
            w, (got0, got1) = drawn[lane], send[lane ^ 1]
            lo = (w[0], w[1]) if even else (got0, got1)
            hi = (got0, got1) if even else (w[2], w[3])
            c = n0 + 8 * g + 2 * (lane % 4)
            r = row0 + lane // 4
            got[(r, c)], got[(r, c + 1)] = lo
            got[(r + 8, c)], got[(r + 8, c + 1)] = hi
    return got


@pytest.mark.parametrize("tile,row0,n0,bn", [((512, 256), 64, 128, 128), ((512, 512), 0, 384, 128),
                                             ((16, 4), 32, 64, 64), ((8, 12), 16, 0, 64)])
def test_the_lane_pair_exchange_gives_every_element_its_own_bits(tile, row0, n0, bn):
    seed, salt = 4242, trng.derive_salt("attn_out")
    got = _lane_pair_draw(seed, salt, tile, row0, n0, bn)
    want = trng.hw_bits(seed, salt, (row0 + 16, n0 + bn), tile)
    assert len(got) == 16 * bn
    assert all(v == int(want[r, c]) for (r, c), v in got.items())


# ---------------------------------------------------------------------------
# The nest, held against the reference's
# ---------------------------------------------------------------------------

def _graphs(f):
    return {
        "fused_output_r0": f.fused_output_graph(0.0),
        "fused_output_r01": f.fused_output_graph(0.1),
        "fused_attn_out_do_res": f.fused_attn_out_graph(True, dropout_rate=0.3),
        "fused_attn_out_res_rms": f.fused_attn_out_graph(True, "rmsnorm"),
        "fused_mlp_gelu": f.fused_mlp_graph("gelu"),
        "fused_gated_mlp_silu": f.fused_gated_mlp_graph("silu"),
        "fused_qkv": f.fused_qkv_graph(),
        "attention_causal": f.fused_attention_graph(causal=True, scale=0.25),
        "softmax_panel": f.TppGraph.chain("softmax_panel", [("softmax", (), {})],
                                          [("x", "lhs"), ("w", "rhs")]),
    }


def _problem(name):
    """(m, k, n, rhs_widths, chain_n2): qkv narrow (GQA), attention chained."""
    if name == "fused_qkv":
        return M, K, N, {"wk": 32, "wv": 32}, None
    if name == "attention_causal":
        return M, K, N, None, K
    return M, K, N, None, None


def _as_tuple(tm):
    return (tuple(tm.letters), tuple(tm.tile), tm.layout)


@pytest.mark.parametrize("name", sorted(_graphs(jf)))
def test_build_nest_inputs_is_the_references(name):
    jg, tg = jf.simplify_graph(_graphs(jf)[name]), tf.simplify_graph(_graphs(tf)[name])
    m, k, n, widths, n2 = _problem(name)
    tiles = (16, 32, 32)
    j = jlowering.build_nest_inputs(jg, m, k, n, tiles, {"b": (2,)}, rhs_widths=widths,
                                    chain_n2=n2)
    t = tlowering.build_nest_inputs(tg, m, k, n, tiles, {"b": (2,)}, rhs_widths=widths,
                                    chain_n2=n2)
    assert [dataclasses.asdict(l) for l in t[0]] == [dataclasses.asdict(l) for l in j[0]]
    assert [_as_tuple(x) for x in t[1]] == [_as_tuple(x) for x in j[1]]
    assert _as_tuple(t[2]) == _as_tuple(j[2])


VISIT_CASES = [("bca", None), ("cba", None), ("bcca", {"c": (2,)}), ("bbca", {"b": (2,)}),
               ("bcaa", {"a": (2,)})]


def _reference_visits(jp, ndims):
    seen = {}
    for g in itertools.product(*map(range, jp.grid)):
        seen.setdefault(tuple(int(x) for x in jp.out_specs.index_map(*g))[:ndims], None)
    return [list(v) for v in seen]


# "cba" puts N outside M: TPP103 for a reducing graph (test_illegal_schedules_...)
@pytest.mark.parametrize("name,spec,steps", [
    (name, spec, steps) for name in ("fused_gated_mlp_silu", "fused_qkv", "fused_output_r01",
                                     "attention_causal")
    for spec, steps in VISIT_CASES
    if not (spec == "cba" and name in ("fused_output_r01", "attention_causal"))])
def test_visit_order_is_the_reference_grids(name, spec, steps):
    jg, tg = jf.simplify_graph(_graphs(jf)[name]), tf.simplify_graph(_graphs(tf)[name])
    m, k, n, widths, n2 = _problem(name)
    tiles = (8, 16, 32)
    loops, in_maps, out_map = jlowering.build_nest_inputs(jg, m, k, n, tiles, steps,
                                                          rhs_widths=widths, chain_n2=n2)
    nest = jcore.ThreadedLoop(loops, spec, reduction_letters=("a",)).nest
    jp = jlow.plan_pallas(nest, in_maps, out_map, reduction_letters=("a",))
    gp = tlowering.plan_graph(tg, m, k, n, torch.float32, spec_string=spec, tiles=tiles,
                              block_steps=steps, rhs_widths=widths, chain_n2=n2)
    assert gp.plan.grid == jp.grid
    assert gp.plan.visit_order.tolist() == _reference_visits(jp, len(out_map.letters))
    assert gp.out_letters == tuple(out_map.letters)
    assert gp.prng_tile == (nest.innermost_step("b") * tiles[0], nest.innermost_step("c") * tiles[2])


@pytest.mark.parametrize("spec,steps,tiles", [("bca", None, (8, 16, 32)),
                                              ("cba", None, (16, 32, 64)),
                                              ("bbca", {"b": (2,)}, (8, 16, 32)),
                                              ("bcca", {"c": (2,)}, None)])
def test_order_table_covers_every_cta_tile_once(spec, steps, tiles):
    g = tf.simplify_graph(tf.fused_gated_mlp_graph("silu"))
    m, n = 1024, 1024
    gp = tlowering.plan_graph(g, m, 256, n, torch.bfloat16, spec_string=spec, tiles=tiles,
                              block_steps=steps)
    for variant in ("wgmma", "simt"):
        cta = fused_gemm.cta_tile(g, m, n, variant)
        order = fused_gemm.order_table(gp, m, n, cta).tolist()
        want = {(i, j) for i in range(0, m, cta[0]) for j in range(0, n, cta[1])}
        assert len(order) == len(want) and {tuple(o) for o in order} == want
    # the fixed grid's raster is "bca" on the CTA tiles themselves
    gp = tlowering.plan_graph(g, m, 256, n, torch.bfloat16, tiles=(128, 32, 64))
    assert fused_gemm.order_table(gp, m, n, (128, 64)).tolist() == \
        [[i, j] for i in range(0, m, 128) for j in range(0, n, 64)]


def test_order_table_of_a_row_panel_lists_row_blocks_in_m_order():
    g = tf.simplify_graph(tf.fused_output_graph(0.1))
    m, n = 256, 128
    gp = tlowering.plan_graph(g, m, 64, n, torch.bfloat16, spec_string="bbca",
                              tiles=(32, 32, 64), block_steps={"b": (4,)})
    cta = fused_gemm.cta_tile(g, m, n, "wgmma")
    assert cta == (64, n)
    assert fused_gemm.order_table(gp, m, n, cta).tolist() == [[r, 0] for r in range(0, m, 64)]
    chain = tf.simplify_graph(tf.fused_attention_graph(causal=True, scale=0.25))
    assert fused_gemm.cta_tile(chain, m, n, "simt") == (64, n)


# ---------------------------------------------------------------------------
# The reference's codes, on the CPU
# ---------------------------------------------------------------------------

ILLEGAL = [
    ("fused_output_r0", "cba", None, TILES, "TPP103"),
    ("fused_output_r0", "bCa", None, TILES, "TPP104"),
    ("fused_mlp_gelu", "abc", None, TILES, "TPP102"),
    ("fused_mlp_gelu", "bca", None, (24, 32, 64), "TPP108"),
    ("fused_output_r01", "B{data:2}bca", {"b": (2,)}, (8, 32, 64), "TPP106"),
]


@pytest.mark.parametrize("name,spec,steps,tiles,code", ILLEGAL)
def test_illegal_schedules_raise_the_reference_codes(name, spec, steps, tiles, code):
    jops, tops = _operands(_graphs(jf)[name])
    with pytest.raises(Exception) as je:
        jf.compile(_graphs(jf)[name], path="pallas", tiles=tiles, spec_string=spec,
                   block_steps=steps, interpret=True)(**jops)
    assert getattr(je.value, "code", None) == code
    for fn in (tlowering.compile_for_device, tlowering.plain_version):
        with pytest.raises(LegalityError) as te:
            fn(_graphs(tf)[name], tiles=tiles, spec_string=spec, block_steps=steps)(**tops)
        assert te.value.code == code


def test_mesh_levels_plan_but_do_not_run():
    _, tops = _operands(_graphs(tf)["fused_mlp_gelu"])
    with pytest.raises(LegalityError, match="mesh") as e:
        tlowering.compile_for_device(_graphs(tf)["fused_mlp_gelu"], spec_string="B{data:2}bca",
                                     tiles=(8, 32, 64), block_steps={"b": (2,)})(**tops)
    assert e.value.code == "TPP000"


def test_graph_passes_match_the_references():
    from repro.analysis import footprint as jfoot
    from repro_torch.analysis import footprint as tfoot
    for name in ("fused_output_r01", "attention_causal", "fused_gated_mlp_silu"):
        jg, tg = jf.simplify_graph(_graphs(jf)[name]), tf.simplify_graph(_graphs(tf)[name])
        assert tfoot.graph_sinks(tg) == tuple(
            tfoot.WriteSink(s.name, s.letters, s.detail.replace("VMEM panel", "row panel"))
            for s in jfoot.graph_sinks(jg))
        for spec in ("bca", "cba", "bCa", "abc", "B{data:2}bca"):
            m, k, n, widths, n2 = _problem(name)
            jl = jlowering.build_nest_inputs(jg, m, k, n, (8, 32, 32), {"b": (2,)},
                                             chain_n2=n2)[0]
            tl = tlowering.build_nest_inputs(tg, m, k, n, (8, 32, 32), {"b": (2,)},
                                             chain_n2=n2)[0]
            jn = jcore.ThreadedLoop(jl, spec, reduction_letters=("a",), allow_races=True).nest
            tn = ThreadedLoop(tl, spec, reduction_letters=("a",), allow_races=True).nest
            assert [d.code for d in tfoot.verify_schedule(tn, tg)] == \
                [d.code for d in jfoot.verify_schedule(jn, jg)]


def test_reference_path_takes_no_schedule():
    g = _graphs(tf)["fused_mlp_gelu"]
    for kw in (dict(spec_string="bca"), dict(tiles=TILES), dict(block_steps={"b": (2,)}),
               dict(hw_prng=True)):
        with pytest.raises(TypeError):
            tf.compile(g, path="reference", **kw)
    with pytest.raises(TypeError):
        tf.compile_for_device(g, vmem_limit_bytes=1 << 20)
    tf.compile(g, path="reference", out_dtype=torch.float32)


# ---------------------------------------------------------------------------
# The counter path: the same bits under every schedule
# ---------------------------------------------------------------------------

SCHEDULES = [("bca", {}, TILES), ("cba", {}, TILES), ("bcca", {"c": (2,)}, TILES),
             ("bbca", {"b": (2,)}, (8, 32, 32)), ("cbba", {"b": (2,)}, (8, 16, 64))]


def test_counter_draw_is_the_same_under_every_schedule():
    jops, tops = _operands(_rng_graph(jf), seed=3)
    want = np.asarray(jf.compile(_rng_graph(jf), path="xla", out_dtype=jnp.float32)(**jops))
    for spec, steps, tiles in SCHEDULES:
        pallas = np.asarray(jf.compile(_rng_graph(jf), path="pallas", tiles=tiles,
                                       spec_string=spec, block_steps=steps, interpret=True,
                                       out_dtype=jnp.float32)(**jops))
        got = _np(tf.compile_for_device(_rng_graph(tf), spec_string=spec, tiles=tiles,
                                        block_steps=steps, out_dtype=torch.float32)(**tops))
        np.testing.assert_array_equal(got == 0.0, pallas == 0.0)
        np.testing.assert_array_equal(got == 0.0, want == 0.0)
        np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# hw_prng=True: K13's plain version
# ---------------------------------------------------------------------------

def _hw(graph, ops, **kw):
    return tf.compile_for_device(graph, hw_prng=True, out_dtype=torch.float32, **kw)(**ops)


def _sigma(p, n):
    return math.sqrt(p * (1 - p) / n)


def test_hw_bits_are_k13s_per_plan_tile():
    rate, salt = 0.4, 5
    g = _rng_graph(tf, rate, salt)
    _, ops = _operands(g, seed=4, m=64, n=128)
    for spec, steps, tiles in SCHEDULES:
        y = _hw(g, ops, spec_string=spec, tiles=tiles, block_steps=steps)
        gp = tlowering.plan_graph(tf.simplify_graph(g), 64, K, 128, torch.float32,
                                  spec_string=spec, tiles=tiles, block_steps=steps)
        keep = trng.hw_bits(ops["seed"], salt, (64, 128), gp.prng_tile) < trng.keep_threshold(rate)
        acc = (ops["x"] @ ops["w"]).abs() > 1e-6
        assert torch.equal((y != 0) & acc, keep & acc)
    # the default plan: pick_tiles' blocks (here the whole problem, one tile)
    y = _hw(g, ops)
    keep = trng.hw_tile_bits(ops["seed"], salt, (64, 128)) < trng.keep_threshold(rate)
    assert torch.equal((y != 0) & acc, keep & acc)


def test_hw_bits_deterministic_order_free_and_tile_dependent():
    g = _rng_graph(tf)
    _, ops = _operands(g, seed=5, m=64, n=128)
    a = _hw(g, ops, spec_string="bca", tiles=TILES)
    assert torch.equal(a, _hw(g, ops, spec_string="bca", tiles=TILES))
    assert torch.equal(a, _hw(g, ops, spec_string="cba", tiles=TILES))
    assert torch.equal(a, _hw(g, ops, spec_string="bcba", tiles=TILES, block_steps={"b": (2,)}))
    b = _hw(g, ops, spec_string="bca", tiles=(32, 32, 64))
    assert not torch.equal(a == 0, b == 0)
    ops2 = dict(ops, seed=ops["seed"] + 1)
    assert not torch.equal(a == 0, _hw(g, ops2, spec_string="bca", tiles=TILES) == 0)


def test_hw_keep_share_survivors_and_agreement_with_the_counter_path():
    rate = 0.3
    g = _rng_graph(tf, rate, 9)
    _, ops = _operands(g, seed=6, m=256, n=256)
    n = 256 * 256
    hw = _hw(g, ops, tiles=(32, 32, 64))
    counter = tf.compile_for_device(g, out_dtype=torch.float32)(**ops)
    dense = tf.compile_for_device(_rng_graph(tf, 0.0, 9), out_dtype=torch.float32)(**ops)
    kept = hw != 0
    p = 1 - rate
    assert abs(float(kept.float().mean()) - p) <= 5 * _sigma(p, n)
    np.testing.assert_allclose(_np(hw[kept]), _np(dense[kept]) * np.float32(1 / (1 - rate)),
                               rtol=1e-6, atol=0)
    agree = float((kept == (counter != 0)).float().mean())
    q = p * p + (1 - p) * (1 - p)
    assert abs(agree - q) <= 5 * _sigma(q, n)


def test_hw_post_reduce_draws_take_full_rows():
    rate, salt = 0.5, 3
    g = tf.TppGraph.chain("softmax_dropout", [("softmax", (), {}),
                                              ("dropout_rng", ("seed",), {"rate": rate, "salt": salt})],
                          [("x", "lhs"), ("w", "rhs"), ("seed", "scalar")])
    _, ops = _operands(g, seed=7)
    y = _hw(g, ops, tiles=TILES)
    keep = trng.hw_bits(ops["seed"], salt, (M, N), (TILES[0], N)) < trng.keep_threshold(rate)
    assert torch.equal(y != 0, keep)


def test_hw_prng_leaves_the_attention_mask_alone():
    _, ops = _operands(_graphs(tf)["attention_causal"], seed=8)
    g = _graphs(tf)["attention_causal"]
    np.testing.assert_array_equal(_np(_hw(g, ops, tiles=(8, 16, 32))),
                                  _np(tf.compile_for_device(g, out_dtype=torch.float32)(**ops)))
    masked = tf.TppGraph.chain("masked_softmax", [("attn_mask", (), {"causal": True}),
                                                  ("softmax", (), {})],
                               [("x", "lhs"), ("w", "rhs")])
    _, ops = _operands(masked, seed=8)
    np.testing.assert_array_equal(_np(_hw(masked, ops, tiles=TILES)),
                                  _np(tf.compile_for_device(masked, out_dtype=torch.float32)(**ops)))


def test_compile_with_vjp_refuses_hw_prng_on_a_prng_graph():
    with pytest.raises(tf.FusionLegalityError) as e:
        tf.compile_with_vjp(_rng_graph(tf), hw_prng=True)
    assert e.value.code == "TPP227"
    with pytest.raises(tf.FusionLegalityError):
        tf.fused_attn_out_apply(torch.zeros(M, K), torch.zeros(K, N), dropout_rate=0.1,
                                dropout_seed=1, hw_prng=True)
    # a forward alone takes it; a graph without a draw differentiates under it
    y = tf.fused_attn_out_apply(torch.ones(M, K), torch.ones(K, N), dropout_rate=0.1,
                                dropout_seed=1, hw_prng=True, tiles=TILES, vjp=False)
    assert 0 < int((y == 0).sum()) < M * N
    _, ops = _operands(_graphs(tf)["fused_mlp_gelu"])
    x = ops["x"].requires_grad_()
    tf.compile_with_vjp(_graphs(tf)["fused_mlp_gelu"], hw_prng=True)(**ops).sum().backward()
    assert x.grad is not None


def test_generated_source_draws_k13_under_the_flag():
    # a plain or pre-reduce draw: its key in the source, its bits drawn by
    # the template (keep_bits, draw_tile) from the flag and the plan's tile
    src = fused_gemm.generate_source(tf.simplify_graph(_rng_graph(tf)))
    assert "static constexpr int NDRAW = 1;" in src and "DRAW4 = false;" in src
    assert "(keep >> 0) & 1u ?" in src and "prng_tn" not in src
    post = tf.TppGraph.chain("sd", [("softmax", (), {}), ("dropout_rng", ("seed",),
                                                          {"rate": 0.5, "salt": 3})],
                             [("x", "lhs"), ("w", "rhs"), ("seed", "scalar")])
    assert "const int prng_tn = a.N;" in fused_gemm.generate_source(tf.simplify_graph(post))
    # a graph without a draw: no change of source for the flag
    assert "prng_tn" not in fused_gemm.generate_source(tf.simplify_graph(
        tf.fused_gated_mlp_graph("silu")))


@pytest.mark.parametrize("tile,shared", [((64, 128), True), ((32, 4), True), ((64, 6), False),
                                         ((16, 130), False), (None, False)])
def test_generated_source_shares_the_draw_only_when_the_width_is_a_multiple_of_4(tile, shared):
    """The plan, not the kernel, picks the source whose wgmma tile shares
    each Philox call among four columns: under hw_prng, a graph that draws,
    a PRNG tile width that is a multiple of 4."""
    g = tf.simplify_graph(_rng_graph(tf))
    assert fused_gemm.shares_draw(g, True, tile) == shared
    assert not fused_gemm.shares_draw(g, False, tile)
    assert not fused_gemm.shares_draw(tf.simplify_graph(tf.fused_gated_mlp_graph("silu")), True,
                                      tile)
    src = fused_gemm.generate_source(g, shared_draw=fused_gemm.shares_draw(g, True, tile))
    assert ("DRAW4 = true;" in src) == shared and ("DRAW4 = false;" in src) != shared
    # the two sources differ only in that constant, so each builds its own library
    plain = fused_gemm.generate_source(g)
    assert (src == plain) != shared
    assert src.replace("DRAW4 = true;", "DRAW4 = false;") == plain


# ---------------------------------------------------------------------------
# Schedule keywords through the library
# ---------------------------------------------------------------------------

LIBRARY_KW = [dict(spec_string="bca", tiles=TILES),
              dict(spec_string="bbca", tiles=(8, 32, 32), block_steps={"b": (2,)})]


def _library_call(f, name, ops, **kw):
    if name == "fused_output_apply":
        return f.fused_output_apply(ops["x"], ops["w"], ops["bias"], ops["residual"],
                                    ops["gamma"], ops["beta"], dropout_rate=0.1,
                                    dropout_seed=ops["seed"], **kw)
    if name == "fused_gated_mlp_apply":
        return f.fused_gated_mlp_apply(ops["x"], ops["wg"], ops["wu"], **kw)
    return f.fused_attn_out_apply(ops["o"], ops["wo"], residual=ops["residual"],
                                  dropout_rate=0.3, dropout_seed=ops["seed"], **kw)


_LIB_GRAPHS = {"fused_output_apply": lambda f: f.fused_output_graph(0.1),
               "fused_gated_mlp_apply": lambda f: f.fused_gated_mlp_graph("silu"),
               "fused_attn_out_apply": lambda f: f.fused_attn_out_graph(True, dropout_rate=0.3)}


@pytest.mark.parametrize("kw", LIBRARY_KW, ids=lambda kw: kw["spec_string"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(_LIB_GRAPHS))
def test_library_schedule_keywords_match_interpret_mode_pallas(name, dtype, kw):
    jops, tops = _operands(_LIB_GRAPHS[name](jf), dtype, seed=9)
    want = _library_call(jf, name, jops, backend="pallas_interpret", **kw)
    got = _library_call(tf, name, tops, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_library_gradient_under_a_schedule_matches_jax_grad():
    kw = dict(spec_string="bbca", tiles=(8, 32, 32), block_steps={"b": (2,)})
    jops, tops = _operands(_LIB_GRAPHS["fused_attn_out_apply"](jf), seed=10)
    dy = np.random.default_rng(11).normal(size=(M, N)).astype(np.float32)

    def jloss(o, wo, residual):
        y = jf.fused_attn_out_apply(o, wo, residual=residual, dropout_rate=0.3,
                                    dropout_seed=jops["seed"], backend="pallas_interpret", **kw)
        return jnp.sum(y * dy)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jops["o"], jops["wo"], jops["residual"])
    leaves = [tops[nm].requires_grad_() for nm in ("o", "wo", "residual")]
    y = tf.fused_attn_out_apply(leaves[0], leaves[1], residual=leaves[2], dropout_rate=0.3,
                                dropout_seed=tops["seed"], **kw)
    (y * torch.from_numpy(dy)).sum().backward()
    for t, j in zip(leaves, want):
        np.testing.assert_allclose(_np(t.grad), np.asarray(j), **F32_TOL)
