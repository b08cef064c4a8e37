"""Fusion autodiff: derived backward TppGraphs and a ``torch.autograd.Function``.

Ported from ``repro/fusion/autodiff.py``.  For any forward graph

    y = epilogue( lhs_r @ rhs_r  for each root r )

the backward pass is three families of TppGraphs, with the reference's
names, operand specs, nodes and outputs, each run through
``lowering.compile_for_device`` with an fp32 output (K5 on the card, the
composed reference on the CPU):

  * **dz graphs** (``@bwd_dz*``): the epilogue backward.  The forward
    contraction is recomputed and the epilogue DAG replaced by derivative
    TPPs walking the forward DAG in reverse (``dropout_rng_grad`` carries
    the forward node's (rate, salt) and seed, so the backward regenerates
    the forward keep bits).  Groups that no fused graph can express (no
    contraction root referenced, or two reducers) run composed.
  * **dlhs graphs** (``@bwd_dlhs[p]``): dX = Σ_r dz_r @ rhs_rᵀ, the forward
    weights read through transposed loads.
  * **drhs graph** (``@bwd_drhs``): dW_r = lhsᵀ @ dz_r, stacked.

A chained graph (flash attention as IR) has its own six-graph recompute
decomposition, ``ChainedBackwardPlan``: p, dp, dz (whose ``softmax_grad``
row panel holds the D = rowsum(dO ∘ O) term), dq, dk and dv.

``compile_with_vjp(graph)`` wraps the forward and the derived graphs in a
memoized ``torch.autograd.Function``: the reference's ``custom_vjp``
becomes ``forward``/``backward``, and the ``float0`` zeros of integer
operands (the dropout seed) become ``None``.  ``residuals`` picks the
memory/compute trade: ``"recompute"`` (default) saves the call operands
only; ``"saved"`` also saves the roots' fp32 accumulators (a forward variant
that outputs them) and runs the epilogue backward composed on them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.fusion.graph import (EPILOGUE_OPS, ContractionRoot, FusionLegalityError, Node,
                                      OperandSpec, TppGraph, _check_grad_arity, simplify_graph)
from repro_torch.fusion.lowering import (HW_PRNG_OPS, _freeze, compile_for_device,
                                        contraction_operand_values)

__all__ = ["derive_vjp", "BackwardPlan", "ChainedBackwardPlan", "backward_graphs",
           "compile_with_vjp"]


# ---------------------------------------------------------------------------
# Reverse-mode sweep over the epilogue DAG
# ---------------------------------------------------------------------------

class _Sweep:
    """Shared node pool for one derivation: the replayed forward nodes
    followed by the emitted derivative nodes (pool order is topological).
    Grad rules receive this object and call :meth:`emit`."""

    def __init__(self, graph: TppGraph):
        self.graph = graph
        self.pool: list[Node] = list(graph.nodes)
        self._taken = (set(graph.operand_names) | set(graph.root_names)
                       | {"acc"} | {nd.name for nd in graph.nodes})
        self._n = 0

    def emit(self, op: str, inputs, attrs: Optional[dict] = None) -> str:
        name = f"b{self._n}_{op}"
        self._n += 1
        assert name not in self._taken
        self._taken.add(name)
        self.pool.append(Node(name, op, tuple(inputs), tuple(sorted((attrs or {}).items()))))
        return name

    def fresh_name(self, base: str) -> str:
        while base in self._taken:
            base = base + "_"
        self._taken.add(base)
        return base


def _named_grad(sweep: _Sweep, node: Node, dv: str) -> list:
    """A string grad rule: the derivative op substitutes dv for the primal
    value input (same arity) or takes dv prepended (+1 arity); either way it
    yields the cotangent of the node's first value input."""
    op = EPILOGUE_OPS[node.op]
    gop = EPILOGUE_OPS.get(op.grad)
    if gop is None:
        raise FusionLegalityError(f"epilogue op {node.op!r}: grad op {op.grad!r} is not registered")
    _check_grad_arity(op, gop)
    inputs = (dv, *node.inputs[1:]) if gop.value_arity == op.value_arity else (dv, *node.inputs)
    return [(node.inputs[0], sweep.emit(op.grad, inputs, node.attr_dict()))]


def _sum_values(sweep: _Sweep, vals: list) -> str:
    out = vals[0]
    for v in vals[1:]:
        out = sweep.emit("add", (out, v))
    return out


def _reverse(graph: TppGraph, sweep: _Sweep, contribs: dict, add_contrib) -> None:
    """Walk the forward nodes in reverse, turning each node's collected
    cotangents into contributions to its inputs."""
    for nd in reversed(graph.nodes):
        clist = contribs.pop(nd.name, [])
        if not clist:
            continue
        dv = clist[0] if len(clist) == 1 else _sum_values(sweep, clist)
        op = EPILOGUE_OPS[nd.op]
        if op.grad is None:
            raise FusionLegalityError(
                f"graph {graph.name!r}: epilogue op {nd.op!r} (node {nd.name!r}) has no "
                "grad rule — register one via the EpilogueOp.grad field to "
                "differentiate through it")
        if isinstance(op.grad, str):
            pairs = ([(nd.inputs[0], dv)] if op.grad == "identity"
                     else _named_grad(sweep, nd, dv))
        else:
            pairs = op.grad(sweep, nd, dv)
        for ref, val in pairs:
            if val is not None:
                add_contrib(ref, val)


# ---------------------------------------------------------------------------
# The backward plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Stage1Group:
    """One epilogue-backward unit: a fused TppGraph (``graph`` set) or a
    composed-TPP evaluation of the same node list."""

    nodes: tuple[Node, ...]
    roots: tuple[ContractionRoot, ...]
    operand_names: tuple[str, ...]
    dy_names: tuple[str, ...]
    outputs: tuple[str, ...]
    graph: Optional[TppGraph] = None
    single_fwd_root: bool = False


@dataclasses.dataclass
class BackwardPlan:
    """Everything needed to run the backward pass of one forward graph."""

    forward: TppGraph
    policy: str
    dy_names: tuple[str, ...]
    stage1: tuple[_Stage1Group, ...]
    value_loc: dict                           # value ref -> ("dy", i) | ("g", gi, oi)
    dacc: dict                                # root name -> value ref | None
    dlhs: dict                                # lhs operand -> (graph, root names) | None
    drhs: Optional[tuple]                     # (graph, {rhs operand -> out idx})
    cotangents: dict                          # operand -> tagged recipe
    aug_forward: Optional[TppGraph] = None
    aug_index: Optional[dict] = None

    def fused_graphs(self) -> dict:
        """Every derived backward TppGraph, by name."""
        out = {}
        for grp in self.stage1:
            if grp.graph is not None:
                out[grp.graph.name] = grp.graph
        for entry in self.dlhs.values():
            if entry is not None:
                out[entry[0].name] = entry[0]
        if self.drhs is not None:
            out[self.drhs[0].name] = self.drhs[0]
        return out

    def graph_role(self, name: str) -> str:
        """``"dz"`` | ``"dlhs"`` | ``"drhs"`` for a derived graph name."""
        for grp in self.stage1:
            if grp.graph is not None and grp.graph.name == name:
                return "dz"
        for entry in self.dlhs.values():
            if entry is not None and entry[0].name == name:
                return "dlhs"
        if self.drhs is not None and self.drhs[0].name == name:
            return "drhs"
        raise KeyError(name)

    def problem_shape(self, name: str, m: int, k: int, n: int):
        """(M', K', N') of a derived graph given the forward (M, K, N)."""
        return {"dz": (m, k, n), "dlhs": (m, n, k), "drhs": (k, m, n)}[self.graph_role(name)]


def _closure(pool: list[Node], seeds) -> list[Node]:
    by_name = {nd.name: nd for nd in pool}
    needed: set[str] = set()
    stack = [s for s in seeds if s in by_name]
    while stack:
        nd = by_name[stack.pop()]
        if nd.name in needed:
            continue
        needed.add(nd.name)
        stack.extend(r for r in nd.inputs if r in by_name)
    return [nd for nd in pool if nd.name in needed]


def _group_refs(graph: TppGraph, nodes: list[Node], dy_names) -> tuple:
    """(root names, operand names, dy names) referenced by ``nodes``."""
    refs = {r for nd in nodes for r in nd.inputs}
    roots = tuple(r for r in graph.roots
                  if r.name in refs or ("acc" in refs and len(graph.roots) == 1))
    opnames = [o.name for o in graph.operands if o.name in refs]
    for r in roots:
        for nm in (r.lhs, r.rhs):
            if nm not in opnames:
                opnames.append(nm)
    dys = tuple(d for d in dy_names if d in refs)
    return roots, tuple(opnames), dys


# ---------------------------------------------------------------------------
# Chained-root backward (flash attention derived)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ChainedBackwardPlan:
    """Backward plan of a chained graph (``o = softmax_online(...) @ v``):
    the flash-attention recompute decomposition as six derived graphs,
    p (the softmax panel), dp = dy @ vᵀ, dz (the epilogue backward seeded
    with dp, whose ``softmax_grad`` holds D = rowsum(dO ∘ O)), dq = dz @ k,
    dk (in the forward operand's stored layout) and dv = pᵀ @ dy."""

    forward: TppGraph
    policy: str
    graphs: dict                      # role -> TppGraph
    names: dict                       # "lhs"/"rhs"/"crhs"/"dy"/"dp"/"dz"/"p"
    rhs_trans: bool
    aug_forward: Optional[TppGraph] = None
    aug_index: Optional[dict] = None

    def fused_graphs(self) -> dict:
        return {g.name: g for g in self.graphs.values()}

    def graph_role(self, name: str) -> str:
        for role, g in self.graphs.items():
            if g.name == name:
                return role
        raise KeyError(name)

    def problem_shape(self, name: str, m: int, k: int, n: int):
        role = self.graph_role(name)
        if role == "dk":
            return (n, m, k) if self.rhs_trans else (k, m, n)
        return {"p": (m, k, n), "dp": (m, k, n), "dz": (m, k, n),
                "dq": (m, n, k), "dv": (n, m, k)}[role]


def _derive_chained(graph: TppGraph) -> ChainedBackwardPlan:
    chain = graph.chained_root()
    base = graph.base_roots
    if len(base) != 1:
        raise FusionLegalityError(
            f"graph {graph.name!r}: VJP of a chained graph supports exactly one base "
            f"root, got {[r.name for r in base]}")
    if graph.epilogue_operands:
        raise FusionLegalityError(
            f"graph {graph.name!r}: VJP of a chained graph with epilogue operands "
            f"({[o.name for o in graph.epilogue_operands]}) is not supported — the "
            "mask/dropout ops it uses regenerate their pattern from attrs + coordinates instead")
    root = base[0]
    lhs_spec = graph.operand(root.lhs)
    rhs_spec = graph.operand(root.rhs)
    if lhs_spec.trans:
        raise FusionLegalityError(
            f"graph {graph.name!r}: VJP through transposed lhs operand "
            f"{lhs_spec.name!r} of a chained graph is not supported")
    red = graph.reducing_node()
    qn, kn, vn = lhs_spec.name, rhs_spec.name, chain.rhs

    sweep = _Sweep(graph)
    dy_n = sweep.fresh_name("dy")
    dp_n = sweep.fresh_name("dp")
    dz_n = sweep.fresh_name("dz")
    p_n = sweep.fresh_name("p")

    p_graph = TppGraph(name=f"{graph.name}@bwd_p", operands=(lhs_spec, rhs_spec),
                       nodes=graph.nodes, roots=base, outputs=(red.name,))
    dp_graph = TppGraph(
        name=f"{graph.name}@bwd_dp",
        operands=(OperandSpec(dy_n, "lhs"), OperandSpec(vn, "rhs", trans=True)),
        roots=(ContractionRoot("t_dp", dy_n, vn),))

    contribs: dict[str, list[str]] = {}

    def add_contrib(ref: str, val: str):
        contribs.setdefault(graph.resolve_acc(ref), []).append(val)

    add_contrib(red.name, dp_n)
    _reverse(graph, sweep, contribs, add_contrib)
    stray = [r for r in contribs if r != root.name and r in graph.operand_names]
    if stray:
        raise FusionLegalityError(
            f"graph {graph.name!r}: chained VJP — epilogue cotangents flow to "
            f"contraction operands {stray}, which the chained backward "
            "decomposition does not carry")
    clist = contribs.get(root.name, [])
    if not clist:
        raise FusionLegalityError(
            f"graph {graph.name!r}: chained VJP — no cotangent reaches base root {root.name!r}")
    ds_ref = clist[0] if len(clist) == 1 else _sum_values(sweep, clist)
    dz_graph = TppGraph(
        name=f"{graph.name}@bwd_dz", operands=(lhs_spec, rhs_spec, OperandSpec(dp_n, "tile")),
        nodes=tuple(_closure(sweep.pool, [ds_ref])), roots=base, outputs=(ds_ref,))
    dq_graph = TppGraph(
        name=f"{graph.name}@bwd_dq",
        operands=(OperandSpec(dz_n, "lhs"), OperandSpec(kn, "rhs", trans=not rhs_spec.trans)),
        roots=(ContractionRoot("t_dq", dz_n, kn),))
    if rhs_spec.trans:       # stored (N, K): dK = dZᵀ @ q over (N, M, K)
        dk_graph = TppGraph(
            name=f"{graph.name}@bwd_dk",
            operands=(OperandSpec(dz_n, "lhs", trans=True), OperandSpec(qn, "rhs")),
            roots=(ContractionRoot("t_dk", dz_n, qn),))
    else:                    # stored (K, N): dK = qᵀ @ dZ over (K, M, N)
        dk_graph = TppGraph(
            name=f"{graph.name}@bwd_dk",
            operands=(OperandSpec(qn, "lhs", trans=True), OperandSpec(dz_n, "rhs")),
            roots=(ContractionRoot("t_dk", qn, dz_n),))
    dv_graph = TppGraph(
        name=f"{graph.name}@bwd_dv",
        operands=(OperandSpec(p_n, "lhs", trans=True), OperandSpec(dy_n, "rhs")),
        roots=(ContractionRoot("t_dv", p_n, dy_n),))
    return ChainedBackwardPlan(
        forward=graph, policy="recompute",
        graphs={"p": p_graph, "dp": dp_graph, "dz": dz_graph,
                "dq": dq_graph, "dk": dk_graph, "dv": dv_graph},
        names={"lhs": qn, "rhs": kn, "crhs": vn, "dy": dy_n, "dp": dp_n, "dz": dz_n, "p": p_n},
        rhs_trans=rhs_spec.trans)


def derive_vjp(graph: TppGraph, *, policy: str = "recompute") -> BackwardPlan:
    """Derive the backward pass of ``graph`` as new TppGraphs (see the module
    docstring).  ``graph`` is simplified first."""
    if policy not in ("recompute", "saved"):
        raise ValueError(f"unknown residual policy {policy!r}; use 'recompute' or 'saved'")
    graph = simplify_graph(graph)
    if graph.chained_root() is not None:
        return _derive_chained(graph)
    for o in graph.operands:
        if o.trans:
            raise FusionLegalityError(
                f"graph {graph.name!r}: deriving a VJP through transposed operand "
                f"{o.name!r} (a backward graph) is not supported")
    if graph.reducing_node() is not None:
        policy = "recompute"   # accumulators precede the reduction

    sweep = _Sweep(graph)
    n_out = len(graph.outputs)
    dy_names = tuple(sweep.fresh_name("dy" if n_out == 1 else f"dy{i}") for i in range(n_out))
    contribs: dict[str, list[str]] = {}

    def add_contrib(ref: str, val: str):
        contribs.setdefault(graph.resolve_acc(ref), []).append(val)

    for out, dy in zip(graph.outputs, dy_names):
        add_contrib(out, dy)
    _reverse(graph, sweep, contribs, add_contrib)

    def settle(ref: str) -> Optional[str]:
        clist = contribs.get(ref, [])
        if not clist:
            return None
        return clist[0] if len(clist) == 1 else _sum_values(sweep, clist)

    dacc = {r.name: settle(r.name) for r in graph.roots}
    op_targets: dict[str, Optional[str]] = {}
    for o in graph.operands:
        if o.kind not in ("mask", "scalar"):
            op_targets[o.name] = settle(o.name)

    pool = sweep.pool
    by_name = {nd.name: nd for nd in pool}
    needed = sorted({v for v in (*dacc.values(), *op_targets.values())
                     if v is not None and v in by_name})

    def reducer_of(ref: str) -> tuple:
        return tuple(nd.name for nd in _closure(pool, [ref])
                     if EPILOGUE_OPS[nd.op].reduces is not None)

    groups_by_key: dict[Any, list[str]] = {}
    for ref in needed:
        reds = reducer_of(ref)
        if len(reds) > 1:
            key = ("fallback", ref)
        elif len(reds) == 1:
            key = ("red", reds[0])
        else:
            key = ("plain",)
        groups_by_key.setdefault(key, []).append(ref)

    stage1: list[_Stage1Group] = []
    value_loc: dict[str, tuple] = {d: ("dy", i) for i, d in enumerate(dy_names)}
    single_fwd_root = len(graph.roots) == 1
    for gi, (key, refs) in enumerate(sorted(groups_by_key.items(), key=lambda kv: str(kv[0]))):
        outputs = tuple(dict.fromkeys(refs))
        nodes = _closure(pool, outputs)
        roots, opnames, dys = _group_refs(graph, nodes, dy_names)
        grp = _Stage1Group(nodes=tuple(nodes), roots=roots, operand_names=opnames,
                           dy_names=dys, outputs=outputs, single_fwd_root=single_fwd_root)
        if key[0] != "fallback" and roots and policy == "recompute":
            specs = tuple([graph.operand(nm) for nm in opnames]
                          + [OperandSpec(d, "tile") for d in dys])
            try:
                g = TppGraph(name=f"{graph.name}@bwd_dz{gi}", operands=specs,
                             nodes=tuple(nodes), roots=roots, outputs=outputs)
                # a grad rule that reads a contraction operand as a value
                # stays composed: no fused kernel takes that (TPP207)
                grp.graph = g if not contraction_operand_values(g) else None
            except FusionLegalityError:
                grp.graph = None
        stage1.append(grp)
        for oi, ref in enumerate(outputs):
            value_loc[ref] = ("g", gi, oi)

    live_roots = [r for r in graph.roots if dacc[r.name] is not None]

    def dz_opname(root: ContractionRoot) -> str:
        return f"dz_{root.name}"

    dlhs: dict[str, Optional[tuple]] = {}
    for o in graph.operands:
        if o.kind != "lhs":
            continue
        roots_p = [r for r in live_roots if r.lhs == o.name]
        if not roots_p:
            dlhs[o.name] = None
            continue
        specs = {}
        for r in roots_p:
            specs[dz_opname(r)] = OperandSpec(dz_opname(r), "lhs")
            if r.rhs not in specs:
                specs[r.rhs] = OperandSpec(r.rhs, "rhs", trans=True)
        broots = tuple(ContractionRoot(f"t_{r.name}", dz_opname(r), r.rhs) for r in roots_p)
        nodes, prev = [], broots[0].name
        for i, br in enumerate(broots[1:]):
            nd = Node(f"s{i}_add", "add", (prev, br.name))
            nodes.append(nd)
            prev = nd.name
        g = TppGraph(name=f"{graph.name}@bwd_dlhs[{o.name}]", operands=tuple(specs.values()),
                     nodes=tuple(nodes), roots=broots, outputs=(prev,))
        dlhs[o.name] = (g, tuple(r.name for r in roots_p))

    drhs = None
    rhs_specs = [o for o in graph.operands if o.kind == "rhs"]
    if live_roots and rhs_specs:
        specs = {}
        broots = []
        for r in live_roots:
            if r.lhs not in specs:
                specs[r.lhs] = OperandSpec(r.lhs, "lhs", trans=True)
            specs[dz_opname(r)] = OperandSpec(dz_opname(r), "rhs")
            broots.append(ContractionRoot(f"w_{r.name}", r.lhs, dz_opname(r)))
        nodes = []
        out_for: dict[str, str] = {}
        for o in rhs_specs:
            rs = [br for br, r in zip(broots, live_roots) if r.rhs == o.name]
            if not rs:
                continue
            prev = rs[0].name
            for i, br in enumerate(rs[1:]):
                nd = Node(f"s{o.name}{i}_add", "add", (prev, br.name))
                nodes.append(nd)
                prev = nd.name
            out_for[o.name] = prev
        outputs = tuple(dict.fromkeys(out_for.values()))
        g = TppGraph(name=f"{graph.name}@bwd_drhs", operands=tuple(specs.values()),
                     nodes=tuple(nodes), roots=tuple(broots), outputs=outputs)
        drhs = (g, {nm: outputs.index(v) for nm, v in out_for.items()})

    cot: dict[str, tuple] = {}
    for o in graph.operands:
        t = op_targets.get(o.name)
        if o.kind in ("mask", "scalar"):
            cot[o.name] = ("none",)
        elif o.kind == "lhs":
            cot[o.name] = (("dlhs", o.name, t) if dlhs.get(o.name)
                           else (("value", t) if t is not None else ("zero",)))
        elif o.kind == "rhs":
            cot[o.name] = (("drhs", o.name, t) if drhs is not None and o.name in drhs[1]
                           else (("value", t) if t is not None else ("zero",)))
        elif o.kind == "tile":
            cot[o.name] = ("value", t) if t is not None else ("zero",)
        else:  # rowvec: (N,) = column sum of the (M, N) integrand
            cot[o.name] = ("colsum", t) if t is not None else ("zero",)

    aug_forward = aug_index = None
    if policy == "saved":
        aug_outputs = tuple(dict.fromkeys((*graph.outputs, *graph.root_names)))
        if aug_outputs != graph.outputs:
            aug_forward = TppGraph(name=f"{graph.name}@fwd_acc", operands=graph.operands,
                                   nodes=graph.nodes, roots=graph.roots, outputs=aug_outputs)
        aug_index = {v: i for i, v in enumerate(aug_outputs)}

    return BackwardPlan(forward=graph, policy=policy, dy_names=dy_names, stage1=tuple(stage1),
                        value_loc=value_loc, dacc=dacc, dlhs=dlhs, drhs=drhs, cotangents=cot,
                        aug_forward=aug_forward, aug_index=aug_index)


def backward_graphs(graph: TppGraph, *, policy: str = "recompute") -> dict:
    """Every fused backward TppGraph derived for ``graph``, by name."""
    return derive_vjp(graph, policy=policy).fused_graphs()


# ---------------------------------------------------------------------------
# Runtime evaluation
# ---------------------------------------------------------------------------

_F32 = torch.float32


def _eval_composed(graph: TppGraph, grp: _Stage1Group, ops_env: dict, acc_env: dict) -> list:
    """Composed-TPP evaluation of one stage-1 group (the reference path's
    semantics on the derived node list)."""
    env = dict(acc_env)
    if grp.single_fwd_root and graph.roots and graph.roots[0].name in env:
        env.setdefault("acc", env[graph.roots[0].name])

    def val(ref):
        if ref in env:
            return env[ref]
        v = ops_env[ref]
        spec = graph.operand(ref) if ref in graph.operand_names else None
        if spec is not None and spec.kind in ("mask", "scalar"):
            return v
        return v.float()

    for nd in grp.nodes:
        env[nd.name] = EPILOGUE_OPS[nd.op].apply(*(val(r) for r in nd.inputs), **nd.attr_dict())
    return [env[o] for o in grp.outputs]


def _run(graph: TppGraph, feed: dict):
    return compile_for_device(graph, out_dtype=_F32)(**feed)


def _run_backward_chained(plan: ChainedBackwardPlan, ops_env: dict, dy):
    """p → dp → dz → dq/dk/dv, each a derived graph; → {operand: fp32
    cotangent}.  Operands may be batched (the attention's (B, H) axes)."""
    nm = plan.names
    g = plan.graphs
    q, k, v = ops_env[nm["lhs"]], ops_env[nm["rhs"]], ops_env[nm["crhs"]]
    p = _run(g["p"], {nm["lhs"]: q, nm["rhs"]: k})
    dp = _run(g["dp"], {nm["dy"]: dy, nm["crhs"]: v})
    dz = _run(g["dz"], {nm["lhs"]: q, nm["rhs"]: k, nm["dp"]: dp})
    del dp
    dq = _run(g["dq"], {nm["dz"]: dz, nm["rhs"]: k})
    dk = (_run(g["dk"], {nm["dz"]: dz, nm["lhs"]: q}) if plan.rhs_trans
          else _run(g["dk"], {nm["lhs"]: q, nm["dz"]: dz}))
    del dz
    dv = _run(g["dv"], {nm["p"]: p, nm["dy"]: dy})
    return {nm["lhs"]: dq, nm["rhs"]: dk, nm["crhs"]: dv}


def _run_backward(plan, ops_env: dict, accs: Optional[dict], dy):
    """Stage-1 dz values, stage-2 contraction cotangents, rowvec column
    sums; → {operand name: fp32 cotangent} (``None`` for masks and seeds)."""
    if isinstance(plan, ChainedBackwardPlan):
        return _run_backward_chained(plan, ops_env, dy)
    graph = plan.forward
    n_out = len(graph.outputs)
    dy_vals = {d: (dy[i] if n_out > 1 else dy) for i, d in enumerate(plan.dy_names)}
    group_res: list[Optional[list]] = [None] * len(plan.stage1)

    def eval_group(gi: int) -> list:
        if group_res[gi] is not None:
            return group_res[gi]
        grp = plan.stage1[gi]
        feed = {nm: ops_env[nm] for nm in grp.operand_names}
        feed.update({d: dy_vals[d] for d in grp.dy_names})
        if grp.graph is not None:
            out = _run(grp.graph, feed)
            res = [out[i] for i in range(len(grp.outputs))] if len(grp.outputs) > 1 else [out]
        else:
            if accs is not None:
                acc_env = {r.name: accs[r.name] for r in grp.roots}
            else:
                acc_env = {r.name: torch.matmul(ops_env[r.lhs].float(), ops_env[r.rhs].float())
                           for r in grp.roots}
            feed.update(dy_vals)
            res = _eval_composed(graph, grp, feed, acc_env)
        group_res[gi] = res
        return res

    def value_of(ref: Optional[str]):
        if ref is None:
            return None
        loc = plan.value_loc[ref]
        if loc[0] == "dy":
            return dy_vals[plan.dy_names[loc[1]]].float()
        return eval_group(loc[1])[loc[2]].float()

    dz = {r: value_of(ref) for r, ref in plan.dacc.items() if ref is not None}
    out: dict[str, Optional[torch.Tensor]] = {}
    drhs_out = None
    for o in graph.operands:
        recipe = plan.cotangents[o.name]
        if recipe[0] == "none":
            out[o.name] = None
        elif recipe[0] == "zero":
            out[o.name] = torch.zeros(ops_env[o.name].shape, dtype=_F32,
                                      device=ops_env[o.name].device)
        elif recipe[0] == "value":
            out[o.name] = value_of(recipe[1])
        elif recipe[0] == "colsum":
            out[o.name] = value_of(recipe[1]).sum(dim=0)
        elif recipe[0] == "dlhs":
            g, root_names = plan.dlhs[o.name]
            feed = {f"dz_{r}": dz[r] for r in root_names}
            # dz carries the stacked (zero-padded) width; a narrow forward
            # rhs (per-root N widths, GQA) is zero-padded up to it
            kmax = max(int(feed[f"dz_{r}"].shape[1]) for r in root_names)
            for s in g.operands:
                if s.name in feed:
                    continue
                arr = ops_env[s.name]
                if s.kind == "rhs" and s.trans and int(arr.shape[1]) < kmax:
                    arr = torch.cat([arr, arr.new_zeros(arr.shape[0], kmax - arr.shape[1])], dim=1)
                feed[s.name] = arr
            c = _run(g, feed)
            if recipe[2] is not None:
                c = c + value_of(recipe[2])
            out[o.name] = c
        else:  # drhs
            g, index = plan.drhs
            if drhs_out is None:
                feed = {f"dz_{r.name}": dz[r.name] for r in graph.roots if r.name in dz}
                feed.update({s.name: ops_env[s.name] for s in g.operands if s.name not in feed})
                drhs_out = _run(g, feed)
            c = drhs_out[index[o.name]] if len(g.outputs) > 1 else drhs_out
            w = int(ops_env[o.name].shape[1])
            if int(c.shape[1]) > w:
                # narrow forward rhs: the columns past its width differentiate
                # the forward's zero padding
                c = c[:, :w]
            if recipe[2] is not None:
                c = c + value_of(recipe[2])
            out[o.name] = c
    return out


# ---------------------------------------------------------------------------
# The autograd Function
# ---------------------------------------------------------------------------

_VJP_CACHE: dict = {}


def compile_with_vjp(graph: TppGraph, *, residuals: str = "recompute", **kw):
    """``fn(**operands)`` whose forward equals ``compile_for_device(graph,
    **kw)`` and whose backward, under autograd, runs the graphs
    :func:`derive_vjp` derives (through ``compile_for_device``, fp32 out),
    each cotangent cast to its operand's dtype.  Schedule keywords
    (``spec_string``, ``tiles``, ``block_steps``) apply to the forward
    kernel; the backward graphs have their own problem shapes and keep
    their own grids, as in the reference.  ``hw_prng=True`` on a graph with
    a PRNG node raises ``FusionLegalityError``: the derived backward graphs
    regenerate the counter path's bits, which would not be the forward's
    mask (the reference hands ``hw_prng`` to the forward only and so takes
    a wrong gradient).  Memoized per graph, ``residuals`` and schedule."""
    key = (graph, residuals, _freeze(kw))
    hit = _VJP_CACHE.get(key)
    if hit is not None:
        return hit
    lowered = simplify_graph(graph)
    if kw.get("hw_prng") and any(nd.op in HW_PRNG_OPS for nd in lowered.nodes):
        raise FusionLegalityError(
            f"graph {graph.name!r}: hw_prng=True draws the forward's dropout bits per "
            "plan tile, which the derived backward graphs cannot regenerate; use the "
            "counter path (hw_prng=False) to differentiate this graph, or "
            "compile_for_device for a forward without a gradient", code="TPP227")
    plan = derive_vjp(lowered, policy=residuals)
    names = tuple(s.name for s in lowered.contraction_operands + lowered.epilogue_operands)
    fwd_fn = compile_for_device(lowered, **kw)
    aug_fn = (compile_for_device(plan.aug_forward, out_dtype=_F32)
              if plan.aug_forward is not None else None)
    n_out = len(lowered.outputs)

    class _Fused(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            env = dict(zip(names, args))
            accs = None
            if aug_fn is not None:
                aug = aug_fn(**env)
                idx = plan.aug_index
                y = (torch.stack([aug[..., idx[o], :, :] for o in lowered.outputs], dim=-3)
                     if n_out > 1 else aug[..., idx[lowered.outputs[0]], :, :])
                y = y.to(args[0].dtype)
                accs = tuple(aug[..., idx[r], :, :] for r in lowered.root_names)
            else:
                y = fwd_fn(**env)
                if plan.policy == "saved":
                    # the outputs already cover every root: the primal is
                    # the accumulator stack
                    idx = plan.aug_index
                    accs = tuple((y[..., idx[r], :, :] if n_out > 1 else y).float()
                                 for r in lowered.root_names)
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            ctx.save_for_backward(*tensors, *(accs or ()))
            ctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
            ctx.others = [None if t else a for a, t in zip(args, ctx.is_tensor)]
            ctx.has_accs = accs is not None
            return y

        @staticmethod
        def backward(ctx, dy):
            saved = ctx.saved_tensors
            it = iter(saved[:sum(ctx.is_tensor)])
            args = [next(it) if t else o for t, o in zip(ctx.is_tensor, ctx.others)]
            accs = saved[sum(ctx.is_tensor):] if ctx.has_accs else None
            ops_env = dict(zip(names, args))
            acc_env = dict(zip(lowered.root_names, accs)) if accs is not None else None
            cots = _run_backward(plan, ops_env, acc_env, dy)
            grads = []
            for nm, x in zip(names, args):
                c = cots.get(nm)
                if c is None or not isinstance(x, torch.Tensor) or not x.is_floating_point():
                    grads.append(None)
                else:
                    grads.append(c.to(x.dtype))
            return tuple(grads)

    accepted = frozenset(graph.operand_names)

    def apply(**operands):
        extra = set(operands) - accepted
        if extra:
            raise TypeError(f"graph {graph.name!r}: unexpected operands {sorted(extra)}")
        missing = [nm for nm in names if nm not in operands]
        if missing:
            raise TypeError(f"graph {graph.name!r}: missing operands {missing}")
        return _Fused.apply(*[operands[nm] for nm in names])

    _VJP_CACHE[key] = apply
    return apply
