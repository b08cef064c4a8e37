"""The paper's primary contribution: PARLOOPER (declarative outer loops with
a single loop_spec_string instantiation knob) and the TPP 2D-tile operator
set, ported from ``repro/core``: the nest runs on the executor, or is
planned for a CUDA kernel (``plan_cuda``).  ``perf_model`` scores a planned
nest against the card (``H100Target``: the L2 walk of the plan's visit
order) or the reference's ``TpuTarget``; ``autotune`` chooses the knob by
that score, and measurement where a ``measure_fn`` is given; ``tunecache``
keeps its results across processes.  The reference's ``make_pallas_fn``
has no counterpart: each kernel's wrapper launches its own plan."""
from repro_torch.core.loops import LegalityError, LoopSpec, ThreadedLoop
from repro_torch.core.parser import ParsedSpec, SpecSyntaxError, parse_spec_string
from repro_torch.core.cuda_lowering import CudaPlan, TensorMap, plan_cuda
from repro_torch.core.executor import run_nest
from repro_torch.core.loops import loop_signature
from repro_torch.core import tpp, perf_model, autotune, tunecache

__all__ = [
    "LegalityError", "LoopSpec", "ThreadedLoop", "loop_signature",
    "ParsedSpec", "SpecSyntaxError", "parse_spec_string",
    "CudaPlan", "TensorMap", "plan_cuda",
    "run_nest", "tpp", "perf_model", "autotune", "tunecache",
]
