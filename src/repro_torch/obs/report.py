"""``python -m repro_torch.obs.report`` — the model-vs-measured attribution
report, a port of ``repro/obs/report.py``.

For a smoke set of library fusion graphs the report:

1. autotunes each graph at the requested shape (persistent tune cache on, so
   the run also exercises and then prints the ``tune.cache.*`` counters);
2. profiles the winning schedule with the warmup + median discipline
   (:mod:`repro_torch.obs.profiler`) on the requested device: K5 on the
   card (the default), its plain version with ``--device cpu``;
3. prints one row per graph — predicted seconds, measured seconds, drift
   ratio, roofline bound class — flagging rows whose drift strays from the
   set's median by more than ``--threshold``×;
4. prints the process-global registry's tune/fusion counter section.

The prediction is the card's (``perf_model.H100Target.from_device``) on
CUDA.  Drift flags are informational by default; ``--fail-on-drift`` turns
flags into exit code 1.  ``--json`` also writes the records and the
registry snapshot.  Without a card, ``--device cuda`` fails.
"""
from __future__ import annotations

import json
import sys


def _smoke_graphs(smoke: bool):
    from repro_torch.fusion import library

    graphs = [
        library.fused_mlp_graph("gelu"),
        library.fused_gated_mlp_graph("silu"),
    ]
    if not smoke:
        graphs += [
            library.fused_qkv_graph(),
            library.fused_output_graph(0.1),
            library.fused_attn_out_graph(residual=True, norm="layernorm"),
        ]
    return graphs


def run_report(m: int, k: int, n: int, *, device="cuda", dtype=None,
               iters: int = 3, warmup: int = 1, threshold: float = 3.0,
               smoke: bool = False, max_candidates: int = 24,
               clock=None, target=None, cache_dir=None) -> dict:
    """Tune + profile the report's graph set on ``device``; returns the
    payload the CLI prints/dumps: records, flags, and the registry counter
    snapshot.  ``dtype`` defaults to bf16 on CUDA, fp32 on the CPU;
    ``target`` to the card's, read from it on CUDA."""
    import torch

    from repro_torch.core import perf_model
    from repro_torch.fusion import cost
    from repro_torch.obs import profiler
    from repro_torch.obs.metrics import default_registry

    cuda = torch.device(device).type == "cuda"
    if dtype is None:
        dtype = torch.bfloat16 if cuda else torch.float32
    if target is None:
        target = perf_model.H100Target.from_device(device) if cuda else perf_model.H100Target()
    records = []
    for g in _smoke_graphs(smoke):
        results = cost.autotune_graph(
            g, m, k, n, dtype=dtype, max_candidates=max_candidates, top_k=8,
            target=target, cache_dir=cache_dir)
        kw = cost.schedule_kwargs(results[0].candidate)
        records.append(profiler.profile_graph(
            g, m, k, n, dtype=dtype, device=device, iters=iters, warmup=warmup,
            clock=clock, target=target, **kw))
    flags = profiler.drift_flags(records, threshold)
    counters = {
        name: value
        for name, value in sorted(default_registry().snapshot().items())
        if name.startswith(("tune.", "fusion."))
    }
    return {
        "shape": [m, k, n],
        "device": str(torch.device(device)),
        "device_name": torch.cuda.get_device_name(torch.device(device)) if cuda else "cpu",
        "dtype": perf_model.dtype_name(dtype),
        "target": target.name,
        "threshold": threshold,
        "records": [r.to_dict() for r in records],
        "drift_flags": flags,
        "counters": counters,
        "_table": profiler.attribution_table(records, threshold),
    }


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Per-graph predicted-vs-measured attribution table "
                    "(drift ratios, roofline bound class) plus the "
                    "tune-cache/fusion counter section.")
    ap.add_argument("--shape", nargs=3, type=int, default=(128, 256, 256),
                    metavar=("M", "K", "N"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: K5 on the card (default); cpu: its plain version")
    ap.add_argument("--dtype", default=None, choices=("bfloat16", "float32"),
                    help="default bfloat16 on cuda, float32 on cpu")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--threshold", type=float, default=3.0,
                    help="flag drift ratios more than this factor away from "
                         "the set's median (default 3.0)")
    ap.add_argument("--smoke", action="store_true", help="the 2-graph fast path")
    ap.add_argument("--max-candidates", type=int, default=24)
    ap.add_argument("--fail-on-drift", action="store_true",
                    help="exit 1 when any row is flagged (default: report only)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write records + registry snapshot as JSON")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("repro_torch.obs.report: no CUDA device (pass --device cpu for the plain "
              "version on the host)", file=sys.stderr)
        return 2
    m, k, n = args.shape
    payload = run_report(m, k, n, device=args.device,
                         dtype=getattr(torch, args.dtype) if args.dtype else None,
                         iters=args.iters, warmup=args.warmup, threshold=args.threshold,
                         smoke=args.smoke, max_candidates=args.max_candidates)

    print(f"model-vs-measured attribution — shape {m}x{k}x{n}, "
          f"{payload['dtype']} on {payload['device_name']} ({payload['device']}), "
          f"target {payload['target']}, {args.iters} iters after "
          f"{args.warmup} warmup (median)")
    print()
    print(payload["_table"])
    flagged = sum(payload["drift_flags"])
    if flagged:
        print(f"\n{flagged} row(s) exceed the {args.threshold:g}x relative "
              f"drift threshold")
    from repro_torch.obs.metrics import default_registry

    print("\ntune / fusion counters (process registry):")
    if payload["counters"]:
        for name, value in payload["counters"].items():
            print(f"  {name:<32} {value}")
    elif not default_registry().enabled:
        print("  (observability disabled: REPRO_OBS=0)")
    else:
        print("  (none recorded)")

    if args.json:
        out = {key: val for key, val in payload.items() if key != "_table"}
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"\nwrote {args.json}")

    if args.fail_on_drift and flagged:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
