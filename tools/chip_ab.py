#!/usr/bin/env python3
"""Interleaved A/B of the ATIS serve and training phases of checkouts of
this repository, on one CUDA card.

    python3 tools/chip_ab.py --order ABBAAB --out chiprun_out/ab \\
        A=scratch_tree/parent B=.

Each letter of ``--order`` is one run: a fresh process that puts the
named tree's ``src`` and root first on ``sys.path``, imports that tree's
own ``chip_smoke.py`` and port, builds its kernels (cached under the
tree's ``build/``) and runs three of its phases through its own helpers:

* ``serve`` (phase 4): ``paper_atis_tt`` at full width through
  ``ServeEngine`` at the serve defaults; tok/s over an untraced
  ``run()``, then the median traced decode tick;
* ``train`` (phase 6): 20 bf16 steps, the median step after step 3;
* ``train_fp8`` (phase 9): the same under ``fp8`` with loss scale 128.

The runs alternate in the given order, so drift of the card or the host
falls on every tree alike.  Each run's JSON lines go to
``<out>/<letter><i>.log``; the last line printed is one JSON object with
each tree's per-run numbers, their medians and their spreads (max - min).
A tree whose ``chip_smoke.py`` lacks a helper of these phases cannot be
run.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

METRICS = (("serve", "tok_per_s"), ("serve", "decode_tick_ms_median"),
           ("train", "step_ms_median_after_3"),
           ("train_fp8", "step_ms_median_after_3"))


def worker(tree: str) -> int:
    tree = os.path.abspath(tree)
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    import chip_smoke as cs
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import telemetry as tm
    from repro_torch.configs import base as cfgbase
    from repro_torch.core import plan_compiler
    from repro_torch.kernels import build, fused_contraction as fc
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train as train_cli
    from repro_torch.serving import profiles
    from repro_torch.serving.engine import Request, ServeEngine

    t0 = time.perf_counter()
    build.build_all()
    cs.emit("env", tree=tree, nvidia_smi=cs.nvidia_smi(),
            build_wall_s=time.perf_counter() - t0)
    arch = cfgbase.get(cs.ARCH)
    model, cfg = steps_lib.build_model(arch, device="cuda", seed=0,
                                       backend="cuda")
    profiles.build_profiles(cfg, batch_size=cs.BATCH, prefill_chunk=cs.CHUNK)
    done, secs, engine = cs.run_engine(torch, model, cfg.vocab, ServeEngine,
                                       Request)
    tick_ms = cs.tick_spans_ms(torch, tm, model, cfg.vocab, ServeEngine,
                               Request)
    tokens = sum(len(r.out_tokens) for r in done)
    cs.emit("serve", ok=len(done) == cs.REQUESTS, tokens=tokens,
            seconds=secs, tok_per_s=tokens / secs,
            decode_tick_ms_median=statistics.median(tick_ms["decode"]),
            prefill_tick_ms=tick_ms["prefill"])
    del model, engine
    _, bf16_last5 = cs.train_phase(torch, fc, plan_compiler, train_cli, 0)
    cs.train_phase(torch, fc, plan_compiler, train_cli, 0, name="train_fp8",
                   precision=cs.FP8_POLICY, loss_scale=cs.FP8_LOSS_SCALE,
                   bf16_last5=bf16_last5)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", metavar="TREE", help=argparse.SUPPRESS)
    ap.add_argument("--order", default="ABBAAB")
    ap.add_argument("--out", default="chiprun_out/ab")
    ap.add_argument("trees", nargs="*", metavar="LETTER=TREE")
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker)
    trees = {k: os.path.abspath(v)
             for k, v in (t.split("=", 1) for t in args.trees)}
    if set(args.order) - set(trees):
        ap.error(f"--order {args.order} names a tree not given: {trees}")
    os.makedirs(args.out, exist_ok=True)
    runs: dict[str, list[dict]] = {k: [] for k in trees}
    for i, letter in enumerate(args.order):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             trees[letter]], capture_output=True, text=True,
            cwd=os.path.abspath(trees[letter]))
        log = os.path.join(args.out, f"{letter}{i}.log")
        with open(log, "w") as f:
            f.write(proc.stdout)
            f.write(proc.stderr)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"run {i} ({letter}) failed: see {log}")
        recs = {}
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                rec = json.loads(line)
                recs[rec.get("phase")] = rec
        row = {f"{p}.{m}": recs[p][m] for p, m in METRICS}
        row["wall_s"] = time.perf_counter() - t0
        runs[letter].append(row)
        print(json.dumps({"run": i, "tree": letter, **row}), flush=True)
    summary = {}
    for letter, rows in runs.items():
        summary[letter] = {"tree": trees[letter], "runs": rows}
        for key in rows[0]:
            vals = [r[key] for r in rows]
            summary[letter][key] = {"median": statistics.median(vals),
                                    "spread": max(vals) - min(vals)}
    print(json.dumps({"ab": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
