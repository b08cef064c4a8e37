#!/usr/bin/env python3
"""Why falcon-mamba-7b's loss rises in ``chip_smoke.py`` phase 10d's trainer,
on one NVIDIA GPU.

    python3 train_divergence.py

Phase 10d's settings: falcon-mamba-7b at full width, 16 of its 64
layers, random weights from seed 0, B 2 x S 2048 of the synthetic corpus
(seed 0), fp32 masters, bf16 compute, remat, loss_chunk 512, AdamW
defaults, WSD with 2 warm-up steps.  For each peak lr of 3e-4, 1e-4 and
3e-5, 6 trainer steps with K8's forward and backward; then, on the held-out batch
phase 10d descends on, the gradient's 1-norm |g|_1 (a fresh AdamW's first
step at lr moves each parameter by about lr against its gradient's sign:
a first-order drop of lr |g|_1) and 3 steps at lr 1e-5 and at 1e-6 on
that batch from fresh moments (phase 10d's downhill), each from the
trained parameters.  At the first lr also ``chip_smoke.gradient_slope``
(each group of leaves against the loss it predicts) as phase 10d runs it,
with the causal conv's sum in fp32, and with the whole forward in fp32;
and the same 6 steps and the 1e-5 downhill with the scan replaced by its
plain version under autograd on the card (``ref.mamba_scan_chunked``, the
CPU's path: no K8 launch), against the K8 run step by step.  Last,
minicpm-2b at phase 9's settings (16 of 40 layers, B 4 x S 1024) the same
way at 3e-4.
Prints a line per run, the card's name and power limit, and last one JSON
summary.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DOWNHILL_LRS = (1e-5, 1e-6)
PEAK_LRS = (3e-4, 1e-4, 3e-5)


def trainer(cfg, peak_lr, batch, seq):
    """6 trainer steps at phase 10d's settings; → (params, losses, grad norms)."""
    from repro_torch.data import DataConfig
    from repro_torch.train import TrainConfig, TrainerConfig, train

    tcfg = TrainConfig(schedule="wsd", peak_lr=peak_lr, warmup_steps=2, total_steps=100,
                       loss_chunk=512, remat=True)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0)
    params, opt, hist = train(cfg, tcfg, dcfg, TrainerConfig(num_steps=6, log_every=0), seed=0,
                              device="cuda")
    del opt
    return params, hist["loss"], hist["grad_norm"]


def held_out(cfg, batch, seq):
    from repro_torch.data import DataConfig, SyntheticCorpus, to_device

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0)
    return to_device(SyntheticCorpus(dcfg).batch_at(1000), "cuda")


def downhill(torch, cfg, params, one, lr):
    """Phase 10d's downhill: 3 steps at a constant ``lr`` from fresh AdamW
    moments on ``one``, then the loss; the parameters are restored."""
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import TrainConfig, make_train_step

    saved = [p.detach().clone() for p in tree_leaves(params)]
    fixed = TrainConfig(schedule="wsd", peak_lr=lr, warmup_steps=0, total_steps=10**6,
                        loss_chunk=512, remat=True)
    opt = init_state(params, AdamWConfig())
    step_fn = make_train_step(cfg, fixed)
    losses = []
    for i in range(3):
        params, opt, metrics = step_fn(params, opt, one, i)
        losses.append(float(metrics["loss"]))
    with torch.no_grad():
        losses.append(float(lm.lm_loss(cfg, params, one, loss_chunk=512)[0]))
        for p, s in zip(tree_leaves(params), saved):
            p.copy_(s)
    return losses


@contextlib.contextmanager
def plain_scan():
    """``ops.mamba_scan`` as the plain chunked scan under autograd."""
    from repro_torch.kernels import ops, ref

    kernel = ops.mamba_scan

    def plain(x, dt, a, b_in, c_in, d_skip, *, h0=None, h_out=None):
        assert h_out is None
        return ref.mamba_scan_chunked(x, dt, a, b_in, c_in, d_skip, h0=h0)

    ops.mamba_scan = plain
    try:
        yield
    finally:
        ops.mamba_scan = kernel


@contextlib.contextmanager
def conv_sum_fp32():
    """``blocks._causal_conv`` summing its taps and bias in fp32, rounding
    once to x's dtype (the model's: every product and sum in x's dtype)."""
    import torch
    from repro_torch.models import blocks

    bf16_conv = blocks._causal_conv

    def conv(w, b, x, state=None):
        c = w.shape[0]
        if state is None:
            state = x.new_zeros(x.shape[0], c - 1, x.shape[2])
        xp = torch.cat([state, x], dim=1)
        s = x.shape[1]
        y = sum(xp[:, i:i + s].float() * w[i].float() for i in range(c)) + b.float()
        return y.to(x.dtype), xp[:, s:]

    blocks._causal_conv = conv
    try:
        yield
    finally:
        blocks._causal_conv = bf16_conv


def slope(torch, cs, cfg, params, one):
    """``chip_smoke.gradient_slope``, its failure recorded, not raised."""
    try:
        return cs.gradient_slope(torch, cfg, params, one)
    except cs.SmokeFailure as e:
        return {"failed": str(e)}


def grad_l1(torch, cfg, params, one):
    """|g|_1 of ``lm_loss`` (remat) at ``params`` on ``one``."""
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves

    loss, _ = lm.lm_loss(cfg, params, one, remat=True, loss_chunk=512)
    return sum(float(g.float().abs().sum())
               for g in torch.autograd.grad(loss, tree_leaves(params)))


def run(torch, cs, cfg, peak_lr, batch, seq, *, lrs=DOWNHILL_LRS, plain=False, variants=False):
    from repro_torch.kernels import mamba_scan as scan

    before = (scan.SCAN_LAUNCHES, scan.SCAN_BWD_LAUNCHES)
    with plain_scan() if plain else contextlib.nullcontext():
        params, losses, norms = trainer(cfg, peak_lr, batch, seq)
        one = held_out(cfg, batch, seq)
        row = {"arch": cfg.name, "layers": cfg.num_layers, "peak_lr": peak_lr,
               "scan": "plain" if plain else "K8", "losses": losses, "grad_norms": norms}
        print(f"{cfg.name} ({cfg.num_layers} layers) {row['scan']}, peak lr {peak_lr:g}: losses"
              f" {[round(x, 4) for x in losses]}, grad norms {[round(x, 3) for x in norms]}",
              flush=True)
        row["grad_l1"] = grad_l1(torch, cfg, params, one)
        print(f"  |g|_1 {row['grad_l1']:.4e} on the held-out batch: a fresh AdamW's first step"
              f" drops the loss by {[round(lr * row['grad_l1'], 4) for lr in lrs]} at lr {lrs}"
              " to first order", flush=True)
        if variants:
            with conv_sum_fp32():
                row["slope"] = {"bf16, conv sum fp32": slope(torch, cs, cfg, params, one)}
            row["slope"]["bf16"] = slope(torch, cs, cfg, params, one)
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            row["slope"]["fp32"] = slope(torch, cs, cfg32, params, one)
        row["downhill"] = {}
        for lr in lrs:
            row["downhill"][str(lr)] = downhill(torch, cfg, params, one, lr)
            print(f"  3 steps at lr {lr:g} on the held-out batch: {row['downhill'][str(lr)]}",
                  flush=True)
    row["k8_launches"] = [scan.SCAN_LAUNCHES - before[0], scan.SCAN_BWD_LAUNCHES - before[1]]
    del params, one
    torch.cuda.empty_cache()
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_divergence: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(names=("gemm", "mamba_scan"))
    mamba = dataclasses.replace(get_config("falcon_mamba_7b"), num_layers=16)
    runs = [run(torch, cs, mamba, PEAK_LRS[0], 2, 2048, variants=True)]
    runs.append(run(torch, cs, mamba, PEAK_LRS[0], 2, 2048, lrs=DOWNHILL_LRS[:1], plain=True))
    k8, plain = runs
    gap = max(abs(a - b) / abs(b) for a, b in zip(k8["losses"], plain["losses"]))
    print(f"  K8 against the plain scan, 6 steps at {PEAK_LRS[0]:g}: losses within {gap:.3e}"
          " relative", flush=True)
    runs += [run(torch, cs, mamba, lr, 2, 2048) for lr in PEAK_LRS[1:]]
    minicpm = dataclasses.replace(get_config("minicpm_2b"), num_layers=16)
    runs.append(run(torch, cs, minicpm, PEAK_LRS[0], 4, 1024, lrs=DOWNHILL_LRS[:1]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"card": smi, "runs": runs, "k8_vs_plain_loss_rel": gap}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
