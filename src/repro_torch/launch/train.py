"""End-to-end training entry point: data -> train loop -> checkpoints,
with a step watchdog and restarts.

Port of ``src/repro/launch/train.py`` (single device)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch paper_atis_tt \
      --tnn --tnn-backend cuda --steps 20 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper_atis_tt \
      --smoke --tnn --tnn-backend cuda --device cpu --steps 3 --batch 2 \
      --seq 16
  PYTHONPATH=src python -m repro_torch.launch.train --arch paper_atis_tt \
      --tnn --tnn-backend cuda --tnn-precision fp8 --loss-scale 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6_7b \
      --tnn --tnn-backend cuda --steps 12 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2_7b \
      --smoke --tnn --device cpu --steps 3 --batch 2 --seq 16
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_7b \
      --tnn --tnn-backend cuda --steps 12 --batch 8 --seq 128 --lr 3e-4
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe_1b_7b \
      --tnn --tnn-backend cuda --steps 12 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe_1b_7b \
      --tnn --tnn-backend cuda --tnn-precision fp8 --loss-scale 128 \
      --steps 12 --batch 8 --seq 128 --lr 1e-3

The default lr (3e-3) suits the small models; at ``qwen2_7b``'s and
``zamba2_7b``'s width the loss climbs at it, and both train at 3e-4.

``--arch zamba2_7b --tnn`` builds ``tnn_default`` (the MLP only), whose
training state does not fit one 80 GB card; the full model trains there
through ``train(..., tnn_cfg=arch.tnn_one_card)`` (``chip_smoke.py``).

A MoE model (``olmoe_1b_7b``, ``qwen3_moe_235b_a22b``) logs its router's
load-balance and z losses (``lb``, ``z``) beside the loss.  Under
``--tnn-precision`` its experts train quantized per (expert, group)
instance, as the reference's vmap over the token groups does, with one
delayed-scaling history ``[E, 2 + cores, 16]`` per expert layer; a
quantized ``--tnn-remat`` stashes per instance too.

An embeddings-input architecture (``llava_next_34b``) trains on the
data's pseudo-embeddings (``DataConfig.embed_dim = d_model``), as the
reference CLI does.  An encoder-decoder one (``seamless_m4t_medium``) is
refused: the loop's batches carry no encoder frames (the reference CLI
stops there too, with a ``KeyError``); it trains through
``steps.build_model`` and ``steps.make_train_step`` on batches of
``enc_embeds``, ``dec_inputs`` and ``dec_targets``.

``--device`` defaults to ``cuda``; ``--device cpu`` runs the kernels'
plain versions.  The loop, its ``train.step`` / ``train.data`` /
``train.step_fn`` spans and its log line are the reference's.  Weights
are random from seed 0.

``--tnn-precision`` (``fp8`` / ``fp8_e5m2`` / ``int8``, optional
``:tile``) trains every tensorized layer quantized with delayed scaling;
``--tnn-remat quantized[:dtype]`` stashes activations in fp8/int8.

``--ckpt-dir DIR`` saves every ``--ckpt-every`` steps (and at the end)
through the asynchronous :class:`~repro_torch.checkpoint.manager.
CheckpointManager`, in the reference's layout, and a run finding a
committed step there resumes from it (so does a restart under
``run_with_restarts``)::

  PYTHONPATH=src python -m repro_torch.launch.train --arch paper_atis_tt \
      --smoke --tnn --device cpu --steps 6 --batch 2 --seq 16 \
      --ckpt-dir /tmp/ckpt --ckpt-every 3

``--tnn-memory-budget`` (``64MB``, ``1.5GB``, bytes) caps CSSE's plan
peak and makes the stash planner raise the microbatch count until the
modeled activation stash fits.  The stash is logged and sampled as
``train.peak_activation_bytes``: modeled before the loop, then, on a
card, measured around the first step (:mod:`repro_torch.memory.probe`).

The reference's other flags are refused with the ROADMAP.md item that
ports them, never ignored: ``--tnn-autotune`` and ``--tnn-search joint``
(queue A item 5), ``--tnn-mesh``, ``--tnn-pipeline`` and
``--production-mesh`` (item 8).  ``phase_paths=False`` (autodiff through
the FP plan) has no flag in either package; ``train(..., tnn_cfg=...)``
takes it.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import memory
from repro_torch import telemetry as tm
from repro_torch.checkpoint import store
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import base as cfgbase
from repro_torch.core.tensorized import TNNConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.launch import steps as steps_lib
from repro_torch.optim.adamw import AdamW
from repro_torch.precision.policy import QuantPolicy

_log = tm.get_logger("train")

#: reference flags this port refuses, with the ROADMAP.md item porting them
UNPORTED_FLAGS = {
    "tnn_autotune": ("--tnn-autotune", "queue A item 5 (autotune)"),
    "tnn_mesh": ("--tnn-mesh", "queue A item 8 (distributed)"),
    "tnn_pipeline": ("--tnn-pipeline", "queue A item 8 (distributed)"),
    "production_mesh": ("--production-mesh", "queue A item 8 (distributed)"),
}

#: why the train loop refuses an encoder-decoder architecture
ENCDEC_REFUSAL = (
    "{arch} is an encoder-decoder model: the train loop's synthetic "
    "batches carry no encoder frames (the reference CLI stops there too); "
    "train it through repro_torch.launch.steps.build_model and "
    "make_train_step with enc_embeds / dec_inputs / dec_targets batches")


def train(arch_id: str, *, smoke: bool, tnn: bool, steps: int,
          global_batch: int, seq_len: int, lr: float,
          ckpt_dir: str | None = None, ckpt_every: int = 50,
          resume: bool = True,
          microbatches: int = 1, log_every: int = 10,
          tnn_backend: str | None = None, tnn_remat: str | None = None,
          tnn_precision: str | None = None, tnn_memory_budget=None,
          loss_scale: float = 1.0, trace_path: str | None = None,
          device: str = "cuda", on_step=None,
          tnn_cfg: TNNConfig | None = None,
          num_layers: int | None = None) -> dict:
    """Train ``arch_id`` for ``steps`` steps on synthetic data; returns
    the per-step losses, grad norms and step seconds of the steps run,
    the activation-memory probe, the final state and the model.
    ``on_step(step, metrics)``, when given, runs after each step.
    ``tnn_cfg``, when given, takes the place of the arch's
    ``tnn_default`` (the backend, precision, remat and budget overrides
    still apply on top); ``num_layers`` cuts the depth.  With ``ckpt_dir`` the state is saved every
    ``ckpt_every`` steps and at the end, and with ``resume`` the run
    starts from the latest committed step there."""
    owns_trace = bool(trace_path) and not tm.enabled()
    if owns_trace:
        tm.configure(trace_path)
    arch = cfgbase.get(arch_id)
    if arch.model_kind == "encdec":
        raise ValueError(ENCDEC_REFUSAL.format(arch=arch.id))
    if tnn_cfg is None:
        tnn_cfg = arch.tnn_default if tnn else None
    if tnn_cfg is not None and tnn_backend is not None:
        tnn_cfg = dataclasses.replace(tnn_cfg, backend=tnn_backend)
    if tnn_cfg is not None and tnn_precision:
        # Quantized contraction execution with delayed scaling: every
        # phase runs under the policy, CSSE prices the policy's byte
        # widths, and the layers carry amax histories.
        tnn_cfg = dataclasses.replace(
            tnn_cfg, precision=QuantPolicy.parse(tnn_precision))
    if tnn_cfg is not None and tnn_remat:
        tnn_cfg = dataclasses.replace(
            tnn_cfg, remat=memory.StashPolicy.parse(tnn_remat).tag())
    budget = memory.parse_budget(tnn_memory_budget)
    if tnn_cfg is not None and budget is not None:
        # One number, two levels: CSSE rejects plans whose modeled
        # live-tensor peak exceeds it, and the stash planner below fits
        # the step's activation stash by microbatching.
        tnn_cfg = dataclasses.replace(tnn_cfg, memory_budget=budget)
    model, cfg = steps_lib.build_model(arch, tnn=tnn_cfg, smoke=smoke,
                                       device=device, seed=0,
                                       num_layers=num_layers)

    mem_probe = modeled = None
    if tnn_cfg is not None:
        stash_policy = tnn_cfg.stash_policy()
        if budget is not None:
            planned, report = memory.plan_microbatches(
                cfg, global_batch, seq_len, budget, stash_policy,
                at_least=microbatches)
            if planned != microbatches:
                _log.info(f"memory planner: budget "
                          f"{memory.format_bytes(budget)} -> "
                          f"{planned} microbatches "
                          f"(stash {memory.format_bytes(report.peak_bytes)})")
                microbatches = planned
        mem_probe = modeled = memory.probe_training(
            cfg, global_batch, seq_len, microbatches, stash_policy)
        _log.info(f"activation stash [{stash_policy.tag()}]: "
                  f"{memory.format_bytes(mem_probe.peak_bytes)}/device "
                  f"({mem_probe.source})")
        tm.sample("train.peak_activation_bytes", mem_probe.peak_bytes)
    # On a card the probe is measured around the first step run.
    probe_first = mem_probe is not None and model.device.type == "cuda"

    data = SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch,
        embed_dim=cfg.d_model if arch.input_kind == "embeds" else None))
    opt = AdamW(lr=lr, total_steps=max(steps, 2), warmup_steps=min(20, steps),
                loss_scale=loss_scale)
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    step_fn = steps_lib.make_train_step(model, opt,
                                        microbatches=microbatches)

    manager = (CheckpointManager(ckpt_dir, every=ckpt_every)
               if ckpt_dir else None)
    start = 0
    if ckpt_dir and resume and store.latest_step(ckpt_dir) is not None:
        start, state = store.restore(ckpt_dir, state)
        _log.info(f"resumed from step {start}")

    watchdog = ft.StepWatchdog()
    history, gnorms, step_s, router = [], [], [], []
    saved = False
    t_start = time.time()
    try:
        for step in range(start, steps):
            with tm.span("train.step", step=step):
                with tm.span("train.data"):
                    batch = {k: torch.as_tensor(v).to(model.device)
                             for k, v in data.batch(step).items()}
                t0 = time.time()
                with tm.span("train.step_fn"):
                    if probe_first:
                        ran = []
                        mem_probe = memory.probe_training(
                            cfg, global_batch, seq_len, microbatches,
                            stash_policy, device=model.device,
                            run=lambda: ran.append(step_fn(state, batch)))
                        (state, metrics), probe_first = ran[0], False
                        peak = memory.format_bytes(mem_probe.peak_bytes)
                        _log.info(f"activation peak of step {step}: {peak}"
                                  f" ({mem_probe.source})")
                        tm.sample("train.peak_activation_bytes",
                                  mem_probe.peak_bytes)
                    else:
                        state, metrics = step_fn(state, batch)
                    loss = float(metrics["loss"])    # waits for the device
                dur = time.time() - t0
            watchdog.observe(step, dur)
            history.append(loss)
            gnorms.append(float(metrics["grad_norm"]))
            step_s.append(dur)
            if "lb_loss" in metrics:
                router.append((float(metrics["lb_loss"]),
                               float(metrics["z_loss"])))
            if manager:
                with tm.span("train.checkpoint", step=step):
                    saved = manager.maybe_save(step + 1, state)
            if on_step is not None:
                on_step(step, metrics)
            if step % log_every == 0 or step == steps - 1:
                tok_s = global_batch * seq_len / max(dur, 1e-9)
                aux = (f"lb {router[-1][0]:.4f} z {router[-1][1]:.3f} "
                       if "lb_loss" in metrics else "")
                _log.info(f"step {step:5d} loss {loss:8.4f} {aux}"
                          f"gnorm {gnorms[-1]:7.3f} "
                          f"lr {float(metrics['lr']):.2e} {dur*1e3:7.1f}ms "
                          f"({tok_s:,.0f} tok/s)")
        if manager and not saved:
            manager.maybe_save(steps, state, force=True)
    finally:
        if manager:
            manager.close()
    wall = time.time() - t_start
    if owns_trace:
        tm.finalize()
    return {"losses": history, "grad_norms": gnorms, "step_s": step_s,
            "lb_losses": [lb for lb, _ in router],
            "z_losses": [z for _, z in router],
            "final_loss": history[-1] if history else None, "wall_s": wall,
            "stragglers": len(watchdog.straggler_events),
            "start_step": start,
            "peak_activation_bytes": (mem_probe.peak_bytes
                                      if mem_probe else None),
            "peak_source": mem_probe.source if mem_probe else None,
            "modeled_activation_bytes": (modeled.peak_bytes
                                         if modeled else None),
            "microbatches": microbatches, "cfg": cfg, "state": state,
            "model": model}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Train an architecture with the PyTorch/CUDA port.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--tnn", action="store_true",
                    help="enable the paper's tensorized layers")
    ap.add_argument("--tnn-backend", choices=["einsum", "cuda", "pallas"],
                    default=None,
                    help="contraction executor for tensorized layers: "
                         "einsum (torch.einsum per step) or cuda (the "
                         "hand-written GEMM/chain kernels; pallas is an "
                         "alias)")
    ap.add_argument("--tnn-precision", default=None, metavar="POLICY",
                    help="quantized execution of the tensorized layers: "
                         "bf16 (default) | fp8[_e4m3] | fp8_e5m2 | int8, "
                         "optional ':tile'; the layers carry delayed-"
                         "scaling amax histories and every FP/BP/WG plan "
                         "runs through the scaled kernels")
    ap.add_argument("--tnn-remat", default=None, metavar="POLICY",
                    help="activation stash policy of the tensorized "
                         "layers: store (default) | recompute (per-layer "
                         "checkpointing re-runs the FP plans in the "
                         "backward) | quantized[:dtype] (fp8/int8 stash; "
                         "lossless under --tnn-precision)")
    ap.add_argument("--tnn-trace", default=None, metavar="PATH",
                    help="write a telemetry trace of the run ('*.jsonl' "
                         "streams events, any other suffix writes Chrome "
                         "trace-event JSON)")
    ap.add_argument("--loss-scale", type=float, default=1.0,
                    help="static loss scaling: the loss is multiplied by "
                         "this before the backward and the gradients "
                         "divided back in AdamW")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the kernels) or cpu (their plain "
                         "versions)")
    ap.add_argument("--tnn-memory-budget", default=None, metavar="BYTES",
                    help="peak activation-memory budget ('64MB', '1.5GB', "
                         "or bytes): CSSE never picks a plan whose "
                         "modeled live-tensor peak exceeds it, and the "
                         "stash planner raises the microbatch count "
                         "(gradient accumulation) until the step's "
                         "modeled activation stash fits")
    ap.add_argument("--ckpt-dir", default=None,
                    help="save checkpoints here (the reference's layout) "
                         "and resume from the latest committed one")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints (with --ckpt-dir)")
    unported = ap.add_argument_group(
        "not ported yet (refused; see ROADMAP.md)")
    unported.add_argument("--tnn-autotune", action="store_true")
    unported.add_argument("--tnn-search", choices=["per-axis", "joint"],
                          default="per-axis")
    unported.add_argument("--tnn-mesh", default=None)
    unported.add_argument("--tnn-pipeline", type=int, default=None)
    unported.add_argument("--production-mesh", action="store_true")
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    for dest, (flag, item) in UNPORTED_FLAGS.items():
        if getattr(args, dest) not in (None, False):
            ap.error(f"{flag} is not ported yet (ROADMAP.md, {item})")
    if args.tnn_search != "per-axis":
        ap.error("--tnn-search joint is not ported yet (ROADMAP.md, "
                 "queue A item 5 (autotune and joint search))")
    for flag, val in (("--tnn-backend", args.tnn_backend),
                      ("--tnn-remat", args.tnn_remat),
                      ("--tnn-precision", args.tnn_precision),
                      ("--tnn-memory-budget", args.tnn_memory_budget)):
        if val is not None and not args.tnn:
            ap.error(f"{flag} requires --tnn (no tensorized layers "
                     "without it)")
    try:
        if args.tnn_remat is not None:
            memory.StashPolicy.parse(args.tnn_remat)
        if args.tnn_precision is not None:
            QuantPolicy.parse(args.tnn_precision)
        memory.parse_budget(args.tnn_memory_budget)
    except ValueError as e:
        ap.error(str(e))
    if args.ckpt_every < 1:
        ap.error("--ckpt-every must be >= 1")
    if cfgbase.get(args.arch).model_kind == "encdec":
        ap.error(ENCDEC_REFUSAL.format(arch=args.arch))
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA card visible (use --device cpu "
                 "for the kernels' plain versions)")

    def run(start_step: int) -> int:
        out = train(args.arch, smoke=args.smoke, tnn=args.tnn,
                    steps=args.steps, global_batch=args.batch,
                    seq_len=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every,
                    microbatches=args.microbatches,
                    tnn_backend=args.tnn_backend, tnn_remat=args.tnn_remat,
                    tnn_precision=args.tnn_precision,
                    tnn_memory_budget=args.tnn_memory_budget,
                    loss_scale=args.loss_scale, trace_path=args.tnn_trace,
                    device=args.device)
        _log.info(f"done: final loss {out['final_loss']:.4f} "
                  f"in {out['wall_s']:.1f}s, stragglers={out['stragglers']}")
        return args.steps

    try:
        ft.run_with_restarts(
            run, max_restarts=2,
            on_failure=lambda e: _log.info(f"RESTART: {e}"))
    finally:
        tm.finalize()


if __name__ == "__main__":
    main()
