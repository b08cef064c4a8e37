"""The port's engine-sizing probe (``repro_torch.serve.probe``) against the
reference's, on the CPU at minicpm-2b's and gemma3-12b's ``reduced()``
configs: the mirror of ``tests/test_serve_engine.py``'s probe test, the
byte count of the reference's ``_abstract_bytes`` for the same spec, and
what ``trial(execute=True)`` catches (out of memory) and lets through
(everything else)."""
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.serve import probe as jprobe
from repro_torch.configs.base import get_config as torch_config
from repro_torch.models import lm as tlm
from repro_torch.serve import probe
from repro_torch.serve.probe import BatchSpec, max_feasible_slots, trial


def _cfg():
    return torch_config("minicpm_2b").reduced()


def test_floor_refusal():
    """The pool must cover at least one slot's reservation."""
    bad = BatchSpec(num_slots=1, num_pages=1, page_size=4, max_seq=32)
    assert bad.max_pages_per_slot == 8
    assert not trial(_cfg(), bad)
    assert not trial(_cfg(), BatchSpec(num_slots=0, num_pages=16, page_size=4, max_seq=32))
    assert trial(_cfg(), bad, min_pages=1)


def test_trial_by_bytes_and_executed_on_the_cpu():
    good = BatchSpec(num_slots=2, num_pages=16, page_size=4, max_seq=32)
    assert trial(_cfg(), good)
    assert trial(_cfg(), good, execute=True, device="cpu")   # one real decode step
    need = probe._abstract_bytes(_cfg(), good)
    assert trial(_cfg(), good, budget_bytes=int(need * 1.25) + 1)
    assert not trial(_cfg(), good, budget_bytes=int(need * 1.25) - 1)


def test_no_budget_gives_hi():
    spec = max_feasible_slots(_cfg(), page_size=4, max_seq=32, hi=64)
    assert spec == BatchSpec(num_slots=64, num_pages=64 * 8, page_size=4, max_seq=32)


def test_budget_admits_exactly_five():
    """Cache bytes grow linearly in slots: a budget between 5 and 6 slots."""
    cfg = _cfg()
    base = probe._abstract_bytes(cfg, BatchSpec(num_slots=1, num_pages=8, page_size=4, max_seq=32))
    per_slot = probe._abstract_bytes(
        cfg, BatchSpec(num_slots=2, num_pages=16, page_size=4, max_seq=32)) - base
    budget = int((base + 4.5 * per_slot) * 1.25)
    spec = max_feasible_slots(cfg, page_size=4, max_seq=32, budget_bytes=budget, hi=64)
    assert spec.num_slots == 5 and spec.num_pages == 40
    # the reference's search at the same budget
    want = jprobe.max_feasible_slots(jax_config("minicpm_2b").reduced(), page_size=4, max_seq=32,
                                     budget_bytes=budget, hi=64)
    assert (want.num_slots, want.num_pages) == (spec.num_slots, spec.num_pages)


def test_budget_of_one_byte_raises():
    with pytest.raises(ValueError, match="no feasible batch"):
        max_feasible_slots(_cfg(), page_size=4, max_seq=32, budget_bytes=1)
    with pytest.raises(ValueError, match="pages_per_slot"):
        max_feasible_slots(_cfg(), page_size=4, max_seq=32, pages_per_slot=9)


@pytest.mark.parametrize("arch", ["minicpm_2b", "gemma3_12b", "falcon_mamba_7b"])
@pytest.mark.parametrize("slots,pages", [(1, 8), (3, 40)])
def test_abstract_bytes_equal_reference(arch, slots, pages):
    """At the fp32 ``reduced()`` configs the port counts the reference's
    bytes, and what ``init_params``/``init_paged_cache`` allocate on the
    CPU; nothing is allocated to count them."""
    spec = BatchSpec(num_slots=slots, num_pages=pages, page_size=4, max_seq=32)
    tcfg = torch_config(arch).reduced()
    got = probe._abstract_bytes(tcfg, spec)
    assert got == jprobe._abstract_bytes(jax_config(arch).reduced(),
                                         jprobe.BatchSpec(slots, pages, 4, 32))
    real = probe.tree_bytes(tlm.init_params(tcfg, 0, device="cpu")) + probe.tree_bytes(
        tlm.init_paged_cache(tcfg, slots, pages, 4, device="cpu"))
    assert got == real


def test_full_width_bytes_are_the_ports_bf16_weights():
    """At full width the count is the port's bf16 serving weights (gemma3:
    11.77 G parameters, norms fp32) plus its bf16 pools."""
    cfg = torch_config("gemma3_12b")
    spec = BatchSpec(num_slots=1, num_pages=129, page_size=16, max_seq=2064)
    params = tlm.init_params(cfg, 0, device="meta")
    assert params["embed"].dtype == torch.bfloat16 and params["embed"].device.type == "meta"
    pool = 2 * cfg.num_layers * 130 * 16 * cfg.num_kv_heads * cfg.head_dim * 2
    assert probe._abstract_bytes(cfg, spec) == probe.tree_bytes(params) + pool
    assert 23.5e9 < probe.tree_bytes(params) < 23.6e9


def test_out_of_memory_returns_false(monkeypatch):
    """An out-of-memory error inside the executed step is the probe's
    "does not fit"."""
    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(tlm, "init_paged_cache", oom)
    good = BatchSpec(num_slots=2, num_pages=16, page_size=4, max_seq=32)
    assert not trial(_cfg(), good, execute=True, device="cpu")


def test_other_errors_propagate(monkeypatch):
    """Any other error inside the executed step propagates: the reference
    would take it for "does not fit"."""
    def broken(*a, **k):
        raise RuntimeError("kernel failed to launch")

    monkeypatch.setattr(tlm, "decode_step", broken)
    good = BatchSpec(num_slots=2, num_pages=16, page_size=4, max_seq=32)
    with pytest.raises(RuntimeError, match="kernel failed to launch"):
        trial(_cfg(), good, execute=True, device="cpu")
    with pytest.raises(RuntimeError, match="kernel failed to launch"):
        max_feasible_slots(_cfg(), page_size=4, max_seq=32, execute=True, hi=4, device="cpu")
