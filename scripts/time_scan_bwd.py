#!/usr/bin/env python3
"""Time K8's backward (``kernels/mamba_scan.py::mamba_scan_bwd``) on one
NVIDIA GPU at falcon-mamba-7b's training layer (L 2048, D 8192, N 16, bf16,
B and C strided column slices of the x projection) at B 2 and B 1.

    python3 scripts/time_scan_bwd.py [--src DIR]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so that two trees can be timed in turns on one
card: unpack the other commit with ``git archive`` into a directory that
``.gitignore`` lists and run this script on each, alternating.  Each run
builds that tree's kernels into its own ``build/``.  The operands are
``chip_smoke.py``'s (``scan_bwd_operands``, seed 11).  For each batch it
prints, after the ``src`` path, the device time and a lone call's median as
``chip_smoke.py``'s ``device_ms`` and ``time_ms`` take them, with the
card's name and power limit.  Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

SHAPES = ((2, 2048, 8192, 16), (1, 2048, 8192, 16))
ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=str(ROOT / "src"))
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_scan_bwd: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_ms, scan_bwd_operands, time_ms
    from repro_torch.kernels import mamba_scan as scan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    for b, l, d, n in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(11)
        x, dtv, a, bi, ci, dsk, _, dy = scan_bwd_operands(torch, gen, b, l, d, n, torch.bfloat16,
                                                          True, False)
        dh = torch.zeros(b, d, n, device="cuda")
        _, _, states = scan.mamba_scan(x, dtv, a, bi, ci, dsk, states=True)

        def fn():
            return scan.mamba_scan_bwd(x, dtv, a, bi, ci, dsk, states, dy, dh_final=dh,
                                       with_dh0=False)

        before = scan.SCAN_BWD_LAUNCHES
        fn()
        torch.cuda.synchronize()
        launches = scan.SCAN_BWD_LAUNCHES - before
        print(f"{args.src}: K8 backward B{b} L{l} D{d} N{n} bf16: device"
              f" {device_ms(torch, fn):.4f} ms, lone call {time_ms(torch, fn):.4f} ms"
              f" ({launches} launch(es) a call) on {card}", flush=True)
        del x, dtv, a, bi, ci, dsk, dy, dh, states, fn
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
