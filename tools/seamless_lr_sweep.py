#!/usr/bin/env python3
"""``seamless_m4t_medium``'s training runs at the learning rates
``chip_smoke.py`` chooses among, on one CUDA card.

    python3 tools/seamless_lr_sweep.py [--lr 3e-3 --lr 1e-3 ...]

Trains ``seamless_m4t_medium`` at full width and depth (12 + 12 layers,
``--tnn``'s default: TT rank 64 on both stacks' SwiGLU, 704,624,640
parameters) through ``steps.make_train_step``, ``cuda`` backend, bf16,
remat, batch 8 of 128 encoder frames and 128 decoder tokens
(``chip_smoke.seamless_batches``), 12 steps from the same seed-0 weights,
once per learning rate (default 3e-3, 1e-3, 3e-4, in that order), and
prints one JSON line per run: the losses, grad norms, whether the run
passes ``chip_smoke.py``'s loss-descent gate (every loss finite, the mean
of the last five below the first), the median step time after step 3
and the peak device memory; then the first learning rate that passed and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lr", type=float, action="append",
                    help="a learning rate to try (repeatable; default "
                         "3e-3, 1e-3, 3e-4)")
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as cs

    import torch
    if not torch.cuda.is_available():
        print("seamless_lr_sweep: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import memory
    from repro_torch.configs import base as cfgbase
    from repro_torch.kernels import build, fused_contraction as fc
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import modality

    build.build_all(("fused_contraction", "flash_attention", "quantized"))
    arch = cfgbase.get(cs.SEAMLESS_ARCH)
    tnn = dataclasses.replace(arch.tnn_default, backend="cuda")
    model, cfg = steps_lib.build_model(arch, tnn, device="cuda", seed=0)
    init = {k: v.detach().cpu().clone() for k, v in
            model.state_dict().items()}
    first = None
    for lr in args.lr or (3e-3, 1e-3, 3e-4):
        model.load_state_dict(init)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run = cs.seamless_train_run(torch, fc, memory, modality, steps_lib,
                                    model, cfg, lr, cs.SEAMLESS_STEPS)
        losses = run["losses"]
        passed = (all(math.isfinite(x) for x in losses)
                  and statistics.mean(losses[-5:]) < losses[0])
        if passed and first is None:
            first = lr
        print(json.dumps({
            "phase": "seamless_lr", "lr": lr, "passes_gate": passed,
            "losses": losses, "grad_norms": run["grad_norms"],
            "first_loss": losses[0],
            "last5_mean_loss": statistics.mean(losses[-5:]),
            "step_ms_median_after_3": statistics.median(
                run["step_s"][3:]) * 1e3,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "params": sum(p.numel() for p in model.parameters())}),
            flush=True)
    print(json.dumps({"phase": "seamless_lr_choice",
                      "first_passing_lr": first}))
    print(cs.nvidia_smi(), flush=True)
    return 0 if first is not None else 1


if __name__ == "__main__":
    sys.exit(main())
