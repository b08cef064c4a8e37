"""The paper's primary contribution: PARLOOPER (declarative outer loops with
a single loop_spec_string instantiation knob) and the TPP 2D-tile operator
set, ported from ``repro/core``: the nest runs on the executor, or is
planned for a CUDA kernel (``plan_cuda``).  The reference's
``make_pallas_fn``, ``perf_model``, ``autotune`` and ``tunecache`` have no
counterpart yet (ROADMAP.md, Queue 1 item 10)."""
from repro_torch.core.loops import LegalityError, LoopSpec, ThreadedLoop
from repro_torch.core.parser import ParsedSpec, SpecSyntaxError, parse_spec_string
from repro_torch.core.cuda_lowering import CudaPlan, TensorMap, plan_cuda
from repro_torch.core.executor import run_nest
from repro_torch.core.loops import loop_signature
from repro_torch.core import tpp

__all__ = [
    "LegalityError", "LoopSpec", "ThreadedLoop", "loop_signature",
    "ParsedSpec", "SpecSyntaxError", "parse_spec_string",
    "CudaPlan", "TensorMap", "plan_cuda",
    "run_nest", "tpp",
]
