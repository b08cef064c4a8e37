"""The port's PARLOOPER (``repro_torch.core``: parser, loop nest, executor,
CUDA plan) against the JAX reference (``repro.core``), mirroring
``tests/test_parlooper.py``: the same specs parse to the same occurrences,
the same illegal nests raise the same codes, ``describe()`` renders the
same text, every legal instantiation of the executor gives the blocked-GEMM
reference (exhaustively and by the hypothesis property), ``plan_cuda``
keeps ``plan_pallas``'s grid and semantics and its output visit order is
the order the reference's grid reaches the output blocks through
``out_specs.index_map``; mesh levels parse and plan but do not run.

Executor tolerance: rtol 1e-5, atol 1e-4, the reference test's (fp32 sums
in another order).
"""
import dataclasses
import itertools
import warnings

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro import core as jcore
from repro.analysis.diagnostics import AnalysisWarning as JAnalysisWarning
from repro.core import pallas_lowering as jlow
from repro_torch import core as tcore
from repro_torch.analysis import footprint as tfootprint
from repro_torch.analysis.diagnostics import AnalysisWarning, CATALOG, diag, enforce
from repro_torch.core import cuda_lowering as tlow
from repro_torch.core import executor as texec
from repro_torch.core.legality import LegalityError
from repro_torch.kernels import brgemm

# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

SPECS = ["bcaBCb", "bC{R:16}aB{C:4}cb", "bcaBCb @ schedule(dynamic,1)", "ab|c", "b|ca",
         "  a b c ", "bca @ megacore; vmem_limit=64MiB, x", "A{data:2}bc|", "Z", "abcdefg",
         "b{ R : 3 }ca"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_matches_reference(spec):
    got, want = tcore.parse_spec_string(spec), jcore.parse_spec_string(spec)
    assert got.raw == want.raw and got.directives == want.directives
    assert [dataclasses.asdict(o) for o in got.occurrences] == \
        [dataclasses.asdict(o) for o in want.occurrences]
    assert [o.loop_index for o in got.occurrences] == [o.loop_index for o in want.occurrences]
    assert got.letters == want.letters and got.mesh_axes == want.mesh_axes
    for name in ("schedule", "megacore", "x", "nothing"):
        assert got.has_directive(name) == want.has_directive(name)
    for letter in "abcz":
        assert got.occurrences_of(letter) == tuple(
            tcore.parser.Occurrence(**dataclasses.asdict(o)) for o in want.occurrences_of(letter))


@pytest.mark.parametrize("bad", ["", "a{b:}c", "1ab", "a{:4}", "|ab", "a{b:4", "   ", "ab@c",
                                 123])
def test_parse_rejects_what_the_reference_rejects(bad):
    try:
        jcore.parse_spec_string(bad)
        ref_ok = True
    except jcore.SpecSyntaxError:
        ref_ok = False
    if ref_ok:
        tcore.parse_spec_string(bad)
    else:
        with pytest.raises(tcore.SpecSyntaxError):
            tcore.parse_spec_string(bad)


# ---------------------------------------------------------------------------
# Legality: the same codes
# ---------------------------------------------------------------------------

def _loops(mod, kb=6, mb=4, nb=6):
    return [
        mod.LoopSpec(0, kb, 2, name="k"),
        mod.LoopSpec(0, mb, 1, block_steps=(2, 2), name="m"),
        mod.LoopSpec(0, nb, 1, block_steps=(3,), name="n"),
    ]


def _imperfect(mod):
    return [mod.LoopSpec(0, 6, 2, name="k"),
            mod.LoopSpec(0, 4, 1, block_steps=(3,), name="m"),
            mod.LoopSpec(0, 6, 1, name="n")]


ILLEGAL = [
    ("missing loop", _loops, "ab", ()),
    ("unknown letter", _loops, "abcd", ()),
    ("insufficient block steps", _loops, "aabc", ()),
    ("imperfect blocking", _imperfect, "abbc", ()),
    ("extent not divisible", lambda m: [m.LoopSpec(0, 5, 2), m.LoopSpec(0, 4, 1)], "ab", ()),
    ("racy parallel reduction", _loops, "Abc", ("a",)),
    ("racy reduction blocked", _loops, "bcaBCbA", ("a",)),
    ("mesh over a reduction", _loops, "a{R:3}bc", ("a",)),
    ("mesh ways do not divide", _loops, "b{R:3}ca", ("a",)),
    ("too many loops", lambda m: [m.LoopSpec(0, 2, 1)] * 27, "a", ()),
]


@pytest.mark.parametrize("what,loops,spec,red", ILLEGAL, ids=[c[0] for c in ILLEGAL])
def test_illegal_nests_raise_the_reference_codes(what, loops, spec, red):
    with pytest.raises(jcore.LegalityError) as want:
        jcore.ThreadedLoop(loops(jcore), spec, reduction_letters=red)
    with pytest.raises(LegalityError) as got:
        tcore.ThreadedLoop(loops(tcore), spec, reduction_letters=red)
    assert got.value.code == want.value.code
    assert tcore.LegalityError is LegalityError is tcore.loops.LegalityError


def test_allow_races_demotes_to_a_warning_in_both():
    with pytest.warns(JAnalysisWarning, match="TPP101"):
        jcore.ThreadedLoop(_loops(jcore), "Abc", reduction_letters=("a",), allow_races=True)
    with pytest.warns(AnalysisWarning, match="TPP101"):
        tl = tcore.ThreadedLoop(_loops(tcore), "Abc", reduction_letters=("a",), allow_races=True)
    assert tl.grid == (3, 4, 6)


@pytest.mark.parametrize("spec", ["bcaBCb", "bcabcb", "Bca", "abC", "b|ca", "bC{R:2}a",
                                  "cBA", "bca @ schedule(dynamic,1)"])
def test_describe_and_nest_match_reference(spec):
    red = ("a",) if spec != "cBA" else ()
    j = jcore.ThreadedLoop(_loops(jcore), spec, reduction_letters=red)
    t = tcore.ThreadedLoop(_loops(tcore), spec, reduction_letters=red)
    assert t.describe() == j.describe()
    assert t.grid == j.grid
    assert [dataclasses.asdict(l) for l in t.nest.levels] == \
        [dataclasses.asdict(l) for l in j.nest.levels]
    assert t.nest.total_body_calls() == j.nest.total_body_calls()
    assert t.nest.logical_index_exprs() == j.nest.logical_index_exprs()
    assert t.nest.mesh_axes == j.nest.mesh_axes
    for letter in "abc":
        assert t.nest.innermost_step(letter) == j.nest.innermost_step(letter)
    assert tcore.loop_signature(t.loops) == jcore.loop_signature(j.loops)
    assert t.loops[0].signature == j.loops[0].signature


def test_loop_spec_steps_and_errors():
    loop = tcore.LoopSpec(0, 8, 1, block_steps=(4, 2), name="m")
    assert loop.steps_for(1) == (1,) and loop.steps_for(3) == (4, 2, 1)
    assert loop.extent == 8
    with pytest.raises(LegalityError) as e:
        loop.steps_for(4)
    assert e.value.code == "TPP108"
    for bad in (dict(start=0, bound=4, step=0), dict(start=3, bound=3)):
        with pytest.raises(ValueError):
            tcore.LoopSpec(**bad)


def test_diagnostics_catalog_and_enforce():
    from repro.analysis.diagnostics import CATALOG as JCATALOG
    assert CATALOG == {c: v for c, v in JCATALOG.items() if c.startswith("TPP1")}
    d = diag("TPP102", "msg", site="bca")
    assert d.render() == "TPP102 reduction-outside-innermost-band [bca]: msg"
    with pytest.raises(LegalityError) as e:
        enforce([diag("TPP107", "a"), diag("TPP108", "b")])
    assert e.value.code == "TPP107"
    with pytest.warns(AnalysisWarning):
        enforce([diag("TPP101", "c")], downgrade_errors=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        enforce([])


# ---------------------------------------------------------------------------
# Executor: identical results across legal instantiations
# ---------------------------------------------------------------------------

BM, BK, BN = 4, 8, 16
MB, KB, NB = 4, 6, 6
RNG = np.random.default_rng(0)
A = RNG.normal(size=(MB, KB, BM, BK)).astype(np.float32)
Bm = RNG.normal(size=(NB, KB, BK, BN)).astype(np.float32)
REF = np.einsum("mkab,nkbc->nmac", A, Bm)
TA, TB = torch.from_numpy(A), torch.from_numpy(Bm)


def run_gemm(spec, loops=None, mode="auto"):
    loops = loops or _loops(tcore, KB, MB, NB)
    k_step = loops[0].step
    tl = tcore.ThreadedLoop(loops, spec, reduction_letters=("a",))

    def body(ind, c):
        ik, im, inn = ind
        acc = tcore.tpp.brgemm(TA[im, ik:ik + k_step], TB[inn, ik:ik + k_step])
        c[inn, im] = acc if ik == 0 else c[inn, im] + acc
        return c

    return tl(body, carry=torch.zeros(NB, MB, BM, BN), mode=mode).numpy()


@pytest.mark.parametrize("spec", [
    "abc", "acb", "bac", "bca", "cab", "cba",
    "bcaBCb", "bcabcb", "Bca", "bCa", "abC",
    "bca @ schedule(dynamic,1)", "b|ca",
])
def test_executor_all_orders_match(spec):
    np.testing.assert_allclose(run_gemm(spec), REF, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode", ["unroll", "lax"])
def test_executor_modes_run_the_same_loops(mode):
    np.testing.assert_array_equal(run_gemm("bcaBCb", mode=mode), run_gemm("bcaBCb", mode="auto"))


def test_executor_rejects_unknown_mode():
    tl = tcore.ThreadedLoop(_loops(tcore), "abc")
    with pytest.raises(ValueError):
        tl(lambda ind, c: c, carry=0, mode="vmap")


def test_executor_init_term_hooks_and_indices():
    tl = tcore.ThreadedLoop(_loops(tcore), "abc")
    calls = []
    out = tl(lambda ind, c: c + 1,
             init_func=lambda c: (calls.append("init"), c)[1],
             term_func=lambda c: (calls.append("term"), c)[1],
             carry=0)
    assert calls == ["init", "term"]
    assert out == tl.nest.total_body_calls()
    # indices in letter order, offset by each loop's start, in nest order
    loops = [tcore.LoopSpec(2, 6, 2), tcore.LoopSpec(10, 13, 1)]
    seen = tcore.ThreadedLoop(loops, "ba")(lambda ind, c: c + [ind], carry=[])
    assert seen == [(2, 10), (4, 10), (2, 11), (4, 11), (2, 12), (4, 12)]
    jloops = [jcore.LoopSpec(2, 6, 2), jcore.LoopSpec(10, 13, 1)]
    jseen = jcore.ThreadedLoop(jloops, "ba")(lambda ind, c: c + [ind], carry=[], mode="unroll")
    assert seen == [tuple(int(i) for i in ind) for ind in jseen]


@st.composite
def legal_specs(draw):
    reps = {
        "a": draw(st.sampled_from([1, 2])),
        "b": draw(st.sampled_from([1, 2])),
        "c": draw(st.sampled_from([1, 2])),
    }
    letters = [l for l, n in reps.items() for _ in range(n)]
    perm = draw(st.permutations(letters))
    s = "".join(perm)
    if draw(st.booleans()):
        idxs = [i for i, ch in enumerate(s) if ch in "bc"]
        i = draw(st.sampled_from(idxs))
        s = s[:i] + s[i].upper() + s[i + 1:]
    return s, reps


@given(legal_specs())
@settings(max_examples=30, deadline=None)
def test_property_any_legal_spec_same_result(spec_reps):
    spec, reps = spec_reps
    loops = [
        tcore.LoopSpec(0, KB, 2, block_steps=(3 * 2,) if reps["a"] > 1 else (), name="k"),
        tcore.LoopSpec(0, MB, 1, block_steps=(2,) if reps["b"] > 1 else (), name="m"),
        tcore.LoopSpec(0, NB, 1, block_steps=(3,) if reps["c"] > 1 else (), name="n"),
    ]
    np.testing.assert_allclose(run_gemm(spec, loops), REF, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# Plans: the reference's grid, semantics and block shapes; the visit order
# ---------------------------------------------------------------------------

def _plans(spec, maps, out, loops, red=("a",)):
    j = jcore.ThreadedLoop(loops(jcore), spec, reduction_letters=red)
    t = tcore.ThreadedLoop(loops(tcore), spec, reduction_letters=red)
    jp = jlow.plan_pallas(j.nest, [jlow.TensorMap(*m) for m in maps], jlow.TensorMap(*out),
                          reduction_letters=red)
    tp = tlow.plan_cuda(t.nest, [tlow.TensorMap(*m) for m in maps], tlow.TensorMap(*out),
                        reduction_letters=red)
    return jp, tp


def _reference_visits(jp, ndims):
    """The output's block indices in the order the reference's grid first
    reaches them through ``out_specs.index_map``."""
    seen = {}
    for g in itertools.product(*map(range, jp.grid)):
        v = tuple(int(x) for x in jp.out_specs.index_map(*g))[:ndims]
        seen.setdefault(v, None)
    return list(seen)


def test_grid_and_semantics():
    jp, tp = _plans("BCa", [(("b", "a"), (BM, BK)), (("c", "a"), (BK, BN))],
                    (("c", "b"), (BM, BN)), _loops)
    assert tp.grid == jp.grid == (MB, NB, KB // 2)
    assert tp.dimension_semantics == jp.dimension_semantics == \
        ("parallel", "parallel", "arbitrary")
    assert tp.out_block == tuple(jp.out_specs.block_shape)
    assert [tuple(b) for b in tp.in_blocks] == [tuple(s.block_shape) for s in jp.in_specs]


# tests/test_kernels.py's spec strings of matmul_pallas, at its 64x64x64
# problem in 16x16x16 tiles
KERNEL_SPECS = [("bca", {}), ("cba", {}), ("bcba", {"b": (2,)}), ("bcaa", {"a": (2,)}),
                ("BCa", {}), ("cbca", {"c": (2,)})]


def _matmul_loops(bs):
    return lambda mod: [mod.LoopSpec(0, 4, 1, block_steps=bs.get("a", ()), name="K"),
                        mod.LoopSpec(0, 4, 1, block_steps=bs.get("b", ()), name="M"),
                        mod.LoopSpec(0, 4, 1, block_steps=bs.get("c", ()), name="N")]


@pytest.mark.parametrize("layout", ["flat", "blocked"])
@pytest.mark.parametrize("spec,bs", KERNEL_SPECS)
def test_visit_order_is_the_reference_grids(spec, bs, layout):
    if layout == "flat":    # matmul_pallas's maps
        maps = [(("b", "a"), (16, 16), "flat"), (("a", "c"), (16, 16), "flat")]
        out = (("b", "c"), (16, 16), "flat")
    else:                   # brgemm_blocked_pallas's maps
        maps = [(("b", "a"), (16, 16)), (("c", "a"), (16, 16))]
        out = (("c", "b"), (16, 16))
    jp, tp = _plans(spec, maps, out, _matmul_loops(bs))
    assert tp.grid == jp.grid and tp.dimension_semantics == jp.dimension_semantics
    assert tp.out_block == tuple(jp.out_specs.block_shape)
    assert tp.visit_order.dtype == torch.int32
    assert [tuple(v) for v in tp.visit_order.tolist()] == _reference_visits(jp, 2)


@pytest.mark.parametrize("spec", ["bcaBCb", "cbacb", "bBcCa", "acb"])
def test_visit_order_multi_level(spec):
    red = ("a",)
    jp, tp = _plans(spec, [(("b", "a"), (BM, BK)), (("c", "a"), (BK, BN))],
                    (("c", "b"), (BM, BN)), lambda m: _loops(m, 6, 8, 6), red)
    assert [tuple(v) for v in tp.visit_order.tolist()] == _reference_visits(jp, 2)
    assert len(tp.visit_order) == 8 * 6


@pytest.mark.parametrize("spec", ["abc", "bac", "bca", "cab", "Bca", "bcaBCb", "bBcCa", "cbac",
                                  "a{R:3}bc"])
def test_reduction_innermost_matches_reference(spec):
    red = ("a",)
    allow = "{" in spec
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jcore.ThreadedLoop(_loops(jcore), spec, reduction_letters=red, allow_races=allow)
        t = tcore.ThreadedLoop(_loops(tcore), spec, reduction_letters=red, allow_races=allow)
    try:
        jlow.validate_reduction_innermost(j.nest, ("b", "c"), red)
        want = None
    except jcore.LegalityError as e:
        want = e.code
    try:
        tlow.validate_reduction_innermost(t.nest, ("b", "c"), red)
        got = None
    except LegalityError as e:
        got = e.code
    assert got == want
    assert tfootprint.check_reduction_innermost(t.nest, ("b", "c"), red) == [] or got == "TPP102"


def test_mesh_levels_parse_and_plan_but_do_not_run():
    loops = lambda m: _loops(m, 6, 4, 32)
    spec = "bC{R:16}a"
    jp, tp = _plans(spec, [(("b", "a"), (BM, BK)), (("c", "a"), (BK, BN))],
                    (("c", "b"), (BM, BN)), loops)
    assert tp.grid == jp.grid == (4, 2, 3)
    assert tp.dimension_semantics == jp.dimension_semantics
    assert tp.sharded_reduction_axes == jp.sharded_reduction_axes == ()
    assert tcore.parse_spec_string(spec).mesh_axes == ("R",)
    tl = tcore.ThreadedLoop(loops(tcore), spec, reduction_letters=("a",))
    assert tl.nest.mesh_axes == ("R",)
    with pytest.raises(LegalityError, match="Queue 1 item 12"):
        tl(lambda ind, c: c, carry=0)
    with pytest.raises(LegalityError, match="Queue 1 item 12"):
        texec.require_no_mesh(tl.nest)
    with pytest.raises(LegalityError, match="Queue 1 item 12"):
        brgemm.schedule(64, 96, 512, torch.float32, spec, tiles=(16, 32, 16))
    # split-K over a mesh: a race at nest level, planned with allow_races
    with pytest.warns(AnalysisWarning):
        tk = tcore.ThreadedLoop(_loops(tcore), "a{R:3}bc", reduction_letters=("a",),
                                allow_races=True)
    plan = tlow.plan_cuda(tk.nest, [tlow.TensorMap(("b", "a"), (BM, BK))],
                          tlow.TensorMap(("c", "b"), (BM, BN)), reduction_letters=("a",))
    assert plan.sharded_reduction_axes == ("R",) and plan.grid[0] == 1


# ---------------------------------------------------------------------------
# K1's order table: every CTA tile once, in the plan's order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,in_bf16,tile", [(2048, True, (128, 128)), (16, True, (16, 64)),
                                            (4, True, (16, 64)), (300, False, (64, 64))])
def test_cta_tile_follows_the_launch(m, in_bf16, tile):
    assert brgemm.cta_tile(m, in_bf16) == tile


def test_cta_order_of_bca_is_the_fixed_grids_raster():
    plan = brgemm.schedule(256, 64, 384, torch.bfloat16, "bca", tiles=(128, 32, 128))
    order = brgemm.cta_order(plan, 256, 384, (128, 128)).tolist()
    assert order == [[0, 0], [0, 128], [0, 256], [128, 0], [128, 128], [128, 256]]
    plan = brgemm.schedule(256, 64, 384, torch.bfloat16, "cba", tiles=(128, 32, 128))
    order = brgemm.cta_order(plan, 256, 384, (128, 128)).tolist()
    assert order == [[0, 0], [128, 0], [0, 128], [128, 128], [0, 256], [128, 256]]


@pytest.mark.parametrize("spec,tiles,bs", [("bca", None, None), ("cbca", (16, 16, 16), {"c": (2,)}),
                                           ("BCa", (32, 32, 48), None),
                                           ("bcba", (64, 16, 64), {"b": (3,)})])
def test_cta_order_covers_every_tile_once(spec, tiles, bs):
    m, k, n = 576, 64, 384
    plan = brgemm.schedule(m, k, n, torch.bfloat16, spec, tiles, bs)
    for cta in ((128, 128), (64, 64)):
        order = brgemm.cta_order(plan, m, n, cta).tolist()
        want = {(i, j) for i in range(0, m, cta[0]) for j in range(0, n, cta[1])}
        assert len(order) == len(want) and {tuple(o) for o in order} == want
    assert brgemm.schedule(m, k, n, torch.bfloat16) is None


def test_pick_tiles_matches_reference():
    from repro.kernels.brgemm import pick_tiles as jpick
    import jax.numpy as jnp
    for m, k, n in ((4096, 8192, 4096), (100352, 64, 256), (2048, 5120, 5120), (48, 77, 64)):
        assert brgemm.pick_tiles(m, k, n, torch.bfloat16) == jpick(m, k, n, jnp.bfloat16)
        assert brgemm.pick_tiles(m, k, n, torch.float32) == jpick(m, k, n, jnp.float32)
