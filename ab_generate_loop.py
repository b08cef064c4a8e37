#!/usr/bin/env python3
"""Time llama2-13b's ``generate_loop``, unfused and ``use_fusion=True``, for
two checkouts of the PyTorch/CUDA port on one NVIDIA GPU, back to back.

    python3 ab_generate_loop.py BEFORE_DIR AFTER_DIR [--reps N]

Each directory is a checkout of this repository; its port
(``src/repro_torch``) is imported from there alone and builds its kernels
into that checkout's ``build/kernels/``.  First both checkouts build and
warm up at once (one process each).  Then the timed runs go before, after,
after, before, each in a process of its own: full-width llama2-13b (bf16,
40 layers, random weights from seed 0) serves ``chip_smoke.py`` phase 5's
batch (4 prompts of 512 tokens from seed 1, 16 new tokens); after one
warm-up call of each path, ``--reps`` rounds each time ``generate_loop``
for 1 token (prefill and the first token) and for 16, unfused then fused
(wall ms, the device synchronized around each call); then one call of each
path runs under ``torch.profiler`` (summed device time of its kernels, and
K3's: the device kernels whose name holds ``flash_decode``).  Prints one
JSON line per process, then the card's name and power limit and, last, a
JSON summary: per checkout and path the median and quartiles of the wall,
the median prefill and decode ms per token over both of its processes,
and after / before of the medians.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

NEW = 16            # tokens generated a call, as chip_smoke.py phase 5
BATCH, PROMPT = 4, 512


def one(checkout: Path, reps: int, warm_only: bool) -> dict:
    """Serve from ``checkout``'s port in this process; → its timings."""
    sys.path.insert(0, str(checkout / "src"))
    import dataclasses

    import torch
    import repro_torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    from repro_torch.serve.decode import ServeConfig, generate_loop
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if Path(repro_torch.__file__).resolve().parents[2] != checkout:
        raise RuntimeError(f"imported {repro_torch.__file__}, not the port of {checkout}")
    cfg = get_config("llama2_13b")
    paths = {"unfused": cfg, "fused": dataclasses.replace(cfg, use_fusion=True)}
    params = lm.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device="cuda")
    scfg = ServeConfig(max_seq=PROMPT + NEW)

    def call(c, n):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = generate_loop(c, params, prompts, n, scfg=scfg)
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3, out

    tokens = {name: call(c, NEW)[1][:, PROMPT:].tolist() for name, c in paths.items()}
    result = {"checkout": str(checkout), "tokens": tokens}
    if warm_only:
        return result
    runs = {name: {"prefill_ms": [], "total_ms": []} for name in paths}
    for _ in range(reps):
        for name, c in paths.items():
            runs[name]["prefill_ms"].append(call(c, 1)[0])
            runs[name]["total_ms"].append(call(c, NEW)[0])
    for name, c in paths.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            generate_loop(c, params, prompts, NEW, scfg=scfg)
            torch.cuda.synchronize()
        busy = k3 = 0.0
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
                busy += ev.self_device_time_total / 1e3
                k3 += ev.self_device_time_total / 1e3 if "flash_decode" in ev.key else 0.0
        runs[name].update(device_busy_ms=busy, k3_device_ms=k3)
    result["runs"] = runs
    return result


def spawn(checkout: Path, reps: int, warm_only: bool) -> subprocess.Popen:
    cmd = [sys.executable, str(Path(__file__).resolve()), "--one", str(checkout),
           "--reps", str(reps)] + (["--warm-only"] if warm_only else [])
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)


def finish(proc: subprocess.Popen, timeout: float) -> dict:
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(proc.args)} exited with {proc.returncode}")
    return json.loads(out.strip().splitlines()[-1])


def main() -> int:
    args = sys.argv[1:]
    reps = int(args[args.index("--reps") + 1]) if "--reps" in args else 5
    if "--one" in args:
        checkout = Path(args[args.index("--one") + 1]).resolve()
        print(json.dumps(one(checkout, reps, "--warm-only" in args)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("ab_generate_loop: no CUDA device", file=sys.stderr)
        return 1
    before, after = (Path(a).resolve() for a in args[:2])
    for d in (before, after):
        if not (d / "src" / "repro_torch").is_dir():
            print(f"ab_generate_loop: {d} holds no src/repro_torch", file=sys.stderr)
            return 1
    start = time.perf_counter()
    warm = [finish(p, 1800) for p in [spawn(d, reps, True) for d in (before, after)]]
    agree = {name: warm[0]["tokens"][name] == warm[1]["tokens"][name] for name in warm[0]["tokens"]}
    print(json.dumps({"built_and_warm_s": time.perf_counter() - start,
                      "greedy_tokens_equal": agree}), flush=True)
    results = {"before": [], "after": []}
    for label, d in (("before", before), ("after", after), ("after", after), ("before", before)):
        r = finish(spawn(d, reps, False), 900)
        r.pop("tokens")
        print(json.dumps({"label": label, **r}), flush=True)
        results[label].append(r["runs"])
    summary = {}
    for label, procs in results.items():
        for name in ("unfused", "fused"):
            total = [t for r in procs for t in r[name]["total_ms"]]
            prefill = [t for r in procs for t in r[name]["prefill_ms"]]
            summary[f"{label} {name}"] = {
                "total_ms": statistics.median(total),
                "total_ms_quartiles": statistics.quantiles(total, n=4)[::2],
                "prefill_ms": statistics.median(prefill),
                "decode_ms_per_token": (statistics.median(total) - statistics.median(prefill))
                / (NEW - 1),
                "device_busy_ms": [r[name]["device_busy_ms"] for r in procs],
                "k3_device_ms": [r[name]["k3_device_ms"] for r in procs]}
    for name in ("unfused", "fused"):
        summary[f"after/before {name} total"] = (summary[f"after {name}"]["total_ms"]
                                                 / summary[f"before {name}"]["total_ms"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
