"""Serving: the continuous-batching engine over a paged KV cache, the
dense-cache loop, counter-based sampling, and the host-side page allocator,
scheduler and fault plans.  Same exports as ``repro.serve``."""
from repro_torch.serve.decode import (ServeConfig, generate, generate_loop,
                                      make_serve_step)
from repro_torch.serve.engine import Engine, EngineConfig, EngineDrainError
from repro_torch.serve.faults import NO_FAULTS, FaultPlan
from repro_torch.serve.kvcache import PagedKvCache
from repro_torch.serve.scheduler import Request, RequestStatus, Scheduler

__all__ = ["ServeConfig", "generate", "generate_loop", "make_serve_step",
           "Engine", "EngineConfig", "EngineDrainError", "FaultPlan",
           "NO_FAULTS", "PagedKvCache", "Request", "RequestStatus",
           "Scheduler"]
