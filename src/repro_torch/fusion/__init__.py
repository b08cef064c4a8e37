"""TPP-chain fusion: the ``TppGraph`` IR, its composed reference path and
K5, a CUDA C++ code generator for graphs of base contraction roots and
pointwise epilogues (``kernels/fused_gemm.py``); the library's fused-layer
graphs; and the counter-based random bits (``rng``).  Ported from
``repro/fusion``.  Still to come with the fusion compiler's training slice
(ROADMAP.md, Queue 1 item 8): the chained root, the row-panel norms,
in-kernel dropout bits and transposed operands on the card, the derived
backward graphs (``autodiff``) and the cost path (``cost``)."""
from repro_torch.fusion import rng
from repro_torch.fusion.graph import (EPILOGUE_OPS, ONLINE_REDUCERS, ContractionRoot,
                                      EpilogueOp, FusionLegalityError, Node, OperandSpec,
                                      TppGraph, register_epilogue, simplify_graph)
from repro_torch.fusion.library import (fused_attention_graph, fused_attn_out_apply,
                                        fused_attn_out_graph, fused_gated_mlp_apply,
                                        fused_gated_mlp_graph, fused_mlp_apply,
                                        fused_mlp_graph, fused_output_graph,
                                        fused_qkv_apply, fused_qkv_graph)
from repro_torch.fusion.lowering import compile, compile_for_device

__all__ = [
    "TppGraph", "ContractionRoot", "Node", "OperandSpec", "EpilogueOp",
    "EPILOGUE_OPS", "ONLINE_REDUCERS", "register_epilogue", "FusionLegalityError",
    "simplify_graph", "rng", "compile", "compile_for_device",
    "fused_output_graph", "fused_mlp_graph", "fused_gated_mlp_graph",
    "fused_qkv_graph", "fused_attn_out_graph", "fused_attention_graph",
    "fused_mlp_apply", "fused_gated_mlp_apply", "fused_qkv_apply",
    "fused_attn_out_apply",
]
