#!/usr/bin/env python3
"""``olmoe_1b_7b``'s training runs at the learning rates ``chip_smoke.py``
chooses among, on one CUDA card.

    python3 tools/olmoe_lr_sweep.py [--lr 3e-3 --lr 1e-3 ...]
        [--precision fp8] [--layers N] [--rank R] [--steps S]

Trains ``olmoe_1b_7b`` at full width and depth (16 layers, 64 experts
top-8, ``--tnn``'s default: TT rank 64 experts, 1,565,067,264
parameters) through the train entry point, ``cuda`` backend, bf16,
batch 8 x seq 128, 12 steps from seed 0, once per learning rate (default
3e-3, 1e-3, 3e-4, in that order), and prints one JSON line per run: the
losses, grad norms, router load-balance and z losses, whether the run
passes ``chip_smoke.py``'s loss-descent gate (every loss finite, the mean
of the last five below the first), the median step time after step 3
and the peak device memory; then the first learning rate that passed and
the card's name and power limit.  ``--precision`` (``fp8``, ``int8``,
...) trains the quantized experts at ``chip_smoke.FP8_LOSS_SCALE`` and
adds, for each step, how much of them is live
(``chip_smoke.ExpertActivity``: outputs and core gradients non-zero,
the largest history slot);
``--layers``, ``--rank`` and ``--steps`` set the depth, the experts' TT
rank and the step count (``chip_smoke.py``'s ``train_olmoe_fp8_rank8``:
``--rank 8 --layers 2 --steps 8``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lr", type=float, action="append",
                    help="a learning rate to try (repeatable; default "
                         "3e-3, 1e-3, 3e-4)")
    ap.add_argument("--precision", default=None,
                    help="--tnn-precision of the run (default bf16)")
    ap.add_argument("--layers", type=int, default=None,
                    help="layers (default: all 16)")
    ap.add_argument("--rank", type=int, default=None,
                    help="the experts' TT rank (default: --tnn's 64)")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps (default: chip_smoke.OLMOE_STEPS)")
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as cs
    import math

    import torch
    if not torch.cuda.is_available():
        print("olmoe_lr_sweep: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import dataclasses

    from repro_torch.configs import base as cfgbase
    from repro_torch.kernels import build
    from repro_torch.launch import train as train_cli

    build.build_all()
    arch = cfgbase.get(cs.OLMOE_ARCH)
    tnn_cfg = (dataclasses.replace(arch.tnn_default, rank=args.rank)
               if args.rank else None)
    first = None
    for lr in args.lr or (3e-3, 1e-3, 3e-4):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        watch, activity = cs.ExpertActivity(train_cli.steps_lib), []
        with watch:
            out = train_cli.train(cs.OLMOE_ARCH, smoke=False, tnn=True,
                                  steps=args.steps or cs.OLMOE_STEPS,
                                  global_batch=cs.TRAIN_BATCH,
                                  seq_len=cs.TRAIN_SEQ, lr=lr,
                                  tnn_backend="cuda", device="cuda",
                                  log_every=4, tnn_cfg=tnn_cfg,
                                  num_layers=args.layers,
                                  tnn_precision=args.precision,
                                  loss_scale=(cs.FP8_LOSS_SCALE
                                              if args.precision else 1.0),
                                  on_step=lambda *_: activity.append(
                                      watch.step()))
        losses = out["losses"]
        passed = (all(math.isfinite(x) for x in losses)
                  and statistics.mean(losses[-5:]) < losses[0])
        if passed and first is None:
            first = lr
        print(json.dumps({
            "phase": "olmoe_lr", "lr": lr, "passes_gate": passed,
            "precision": args.precision or "bf16",
            "layers": args.layers or 16, "rank": args.rank or 64,
            "losses": losses, "grad_norms": out["grad_norms"],
            "lb_losses": out["lb_losses"], "z_losses": out["z_losses"],
            "first_loss": losses[0],
            "last5_mean_loss": statistics.mean(losses[-5:]),
            "step_ms_median_after_3": statistics.median(
                out["step_s"][3:]) * 1e3,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "expert_activity": activity if watch.layers else None,
            "params": sum(p.numel()
                          for p in out["state"]["params"].values())}),
            flush=True)
        del out
    print(json.dumps({"phase": "olmoe_lr_choice", "first_passing_lr": first}))
    print(cs.nvidia_smi(), flush=True)
    return 0 if first is not None else 1


if __name__ == "__main__":
    sys.exit(main())
