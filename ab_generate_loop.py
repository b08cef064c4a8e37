#!/usr/bin/env python3
"""Time llama2-13b's ``generate_loop``, unfused and ``use_fusion=True``, or
its serving engine, for two checkouts of the PyTorch/CUDA port on one
NVIDIA GPU, back to back.

    python3 ab_generate_loop.py BEFORE_DIR AFTER_DIR [--reps N] [--paths P,...]

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
the decode attention's: the device kernels whose name holds
``flash_decode``, K3).  ``--paths`` picks among ``unfused``, ``fused`` and
``engine`` (default ``unfused,fused``): ``engine`` drains ``chip_smoke.py``
phase 6's profiled wave through a fresh ``serve.Engine`` (the first 8 of
its seeded requests, greedy and sampled, on 8 slots of 16-token pages;
the engine built before the clock starts), timed whole, and profiled as
above with K4's kernels (``paged_decode``) as its decode attention.
Prints one JSON line per process, then the card's name and power limit
and, last, a JSON summary: per checkout and path the median and quartiles
of the wall over both of its processes, for ``generate_loop`` the median
prefill and decode ms per token, and after / before of the medians.
Imports nothing of JAX.
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
# chip_smoke.py's ENGINE and its sampled requests' knobs
ENGINE = dict(num_slots=8, page_size=16, max_seq=1024, segment_len=8, admission="reserve", seed=0)
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95)
WAVE = 8            # requests of the profiled engine drain, as chip_smoke.py phase 6
# the device kernels each path's decode attention runs
DECODE_KERNEL = {"unfused": "flash_decode", "fused": "flash_decode", "engine": "paged_decode"}


def engine_requests(vocab_size, n):
    """``chip_smoke.engine_requests``' first ``n``: prompts of 32..480
    tokens, 8..40 new tokens, even uids greedy, odd ones sampled."""
    import numpy as np
    rng = np.random.default_rng(5)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(32, 481))
        reqs.append(dict(prompt=rng.integers(0, vocab_size, plen).tolist(),
                         max_new=int(rng.integers(8, 41)), **(SAMPLED if i % 2 else {})))
    return reqs


def one(checkout: Path, reps: int, warm_only: bool, names: list) -> dict:
    """Serve from ``checkout``'s port in this process; → its timings."""
    sys.path.insert(0, str(checkout / "src"))
    import dataclasses

    import torch
    import repro_torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    from repro_torch.serve import Engine, EngineConfig
    from repro_torch.serve.decode import ServeConfig, generate_loop
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if Path(repro_torch.__file__).resolve().parents[2] != checkout:
        raise RuntimeError(f"imported {repro_torch.__file__}, not the port of {checkout}")
    cfg = get_config("llama2_13b")
    configs = {"unfused": cfg, "fused": dataclasses.replace(cfg, use_fusion=True), "engine": cfg}
    params = lm.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device="cuda")
    scfg = ServeConfig(max_seq=PROMPT + NEW)
    reqs = engine_requests(cfg.vocab_size, WAVE)

    def call(name, n):
        """One call of path ``name`` (n tokens for generate_loop); → (wall
        ms, its tokens)."""
        if name == "engine":
            eng = Engine(cfg, params, EngineConfig(**ENGINE))
            for r in reqs:
                eng.submit(r["prompt"], r["max_new"], temperature=r.get("temperature", 0.0),
                           top_k=r.get("top_k", 0), top_p=r.get("top_p", 1.0))
        torch.cuda.synchronize()
        start = time.perf_counter()
        if name == "engine":
            while not eng.idle:
                eng.step()
        else:
            out = generate_loop(configs[name], params, prompts, n, scfg=scfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1e3
        if name == "engine":
            return wall, [eng.collect(uid) for uid in range(len(reqs))]
        return wall, out[:, PROMPT:].tolist()

    tokens = {name: call(name, NEW)[1] for name in names}
    result = {"checkout": str(checkout), "tokens": tokens}
    if warm_only:
        return result
    runs = {name: {"prefill_ms": [], "total_ms": []} for name in names}
    for _ in range(reps):
        for name in names:
            if name != "engine":
                runs[name]["prefill_ms"].append(call(name, 1)[0])
            runs[name]["total_ms"].append(call(name, NEW)[0])
    for name in names:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call(name, NEW)
        busy = attn = 0.0
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
                busy += ev.self_device_time_total / 1e3
                attn += (ev.self_device_time_total / 1e3
                         if DECODE_KERNEL[name] in ev.key else 0.0)
        runs[name].update(device_busy_ms=busy, decode_attention_device_ms=attn)
    result["runs"] = runs
    return result


def spawn(checkout: Path, reps: int, warm_only: bool, names: list) -> subprocess.Popen:
    cmd = [sys.executable, str(Path(__file__).resolve()), "--one", str(checkout),
           "--reps", str(reps), "--paths", ",".join(names)] + (["--warm-only"] if warm_only else [])
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
    names = (args[args.index("--paths") + 1] if "--paths" in args else "unfused,fused").split(",")
    if not names or any(n not in DECODE_KERNEL for n in names):
        print(f"ab_generate_loop: --paths takes some of {', '.join(DECODE_KERNEL)}", file=sys.stderr)
        return 1
    if "--one" in args:
        checkout = Path(args[args.index("--one") + 1]).resolve()
        print(json.dumps(one(checkout, reps, "--warm-only" in args, names)))
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
    warm = [finish(p, 1800) for p in [spawn(d, reps, True, names) for d in (before, after)]]
    agree = {name: warm[0]["tokens"][name] == warm[1]["tokens"][name] for name in warm[0]["tokens"]}
    print(json.dumps({"built_and_warm_s": time.perf_counter() - start,
                      "tokens_equal": agree}), flush=True)
    results = {"before": [], "after": []}
    for label, d in (("before", before), ("after", after), ("after", after), ("before", before)):
        r = finish(spawn(d, reps, False, names), 900)
        r.pop("tokens")
        print(json.dumps({"label": label, **r}), flush=True)
        results[label].append(r["runs"])
    summary = {}
    for label, procs in results.items():
        for name in names:
            total = [t for r in procs for t in r[name]["total_ms"]]
            prefill = [t for r in procs for t in r[name]["prefill_ms"]]
            row = summary[f"{label} {name}"] = {
                "total_ms": statistics.median(total),
                "total_ms_quartiles": statistics.quantiles(total, n=4)[::2],
                "device_busy_ms": [r[name]["device_busy_ms"] for r in procs],
                "decode_attention_device_ms": [r[name]["decode_attention_device_ms"]
                                               for r in procs]}
            if prefill:
                row["prefill_ms"] = statistics.median(prefill)
                row["decode_ms_per_token"] = (row["total_ms"] - row["prefill_ms"]) / (NEW - 1)
    for name in names:
        summary[f"after/before {name} total"] = (summary[f"after {name}"]["total_ms"]
                                                 / summary[f"before {name}"]["total_ms"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
