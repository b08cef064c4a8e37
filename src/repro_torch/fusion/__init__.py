"""TPP-chain fusion: the ``TppGraph`` IR, its composed reference path and
K5, a CUDA C++ code generator for every graph the library and its derived
backward graphs use (``kernels/fused_gemm.py``); the library's fused-layer
graphs; the derived backward graphs and their autograd Function
(``autodiff``); the counter-based random bits and K13's per-tile Philox
bits (``rng``); graphs scheduled from a PARLOOPER spec string
(``lowering.plan_graph``); the cost path (``cost``: a graph's predicted
cost on the card, its schedules tuned by ``core.autotune``, measured on K5
by ``measured_autotune_graph``).  Ported from ``repro/fusion``."""
from repro_torch.fusion import rng
from repro_torch.fusion.autodiff import (BackwardPlan, ChainedBackwardPlan, backward_graphs,
                                         compile_with_vjp, derive_vjp)
from repro_torch.fusion.graph import (EPILOGUE_OPS, ONLINE_REDUCERS, ContractionRoot,
                                      EpilogueOp, FusionLegalityError, Node, OperandSpec,
                                      TppGraph, register_epilogue, simplify_graph)
from repro_torch.fusion.library import (fused_attention_apply, fused_attention_graph,
                                        fused_attn_out_apply, fused_attn_out_graph,
                                        fused_gated_mlp_apply, fused_gated_mlp_graph,
                                        fused_mlp_apply, fused_mlp_graph, fused_output_apply,
                                        fused_output_graph, fused_qkv_apply, fused_qkv_graph)
from repro_torch.fusion.lowering import (DEFAULT_SPEC, compile, compile_for_device,
                                        plain_version, validate_epilogue_band)
from repro_torch.fusion.cost import (UnfusedEstimate, autotune_graph, estimate_unfused,
                                     graph_cost, graph_signature, measured_autotune_graph,
                                     schedule_kwargs)

__all__ = [
    "TppGraph", "ContractionRoot", "Node", "OperandSpec", "EpilogueOp",
    "EPILOGUE_OPS", "ONLINE_REDUCERS", "register_epilogue", "FusionLegalityError",
    "simplify_graph", "rng", "compile", "compile_for_device", "plain_version",
    "compile_with_vjp", "DEFAULT_SPEC", "validate_epilogue_band",
    "derive_vjp", "backward_graphs", "BackwardPlan", "ChainedBackwardPlan",
    "graph_cost", "autotune_graph", "measured_autotune_graph",
    "estimate_unfused", "UnfusedEstimate", "schedule_kwargs", "graph_signature",
    "fused_output_graph", "fused_mlp_graph", "fused_gated_mlp_graph",
    "fused_qkv_graph", "fused_attn_out_graph", "fused_attention_graph",
    "fused_output_apply", "fused_mlp_apply", "fused_gated_mlp_apply", "fused_qkv_apply",
    "fused_attn_out_apply", "fused_attention_apply",
]
