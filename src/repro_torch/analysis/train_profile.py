"""Where a training step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.analysis.train_profile
    PYTHONPATH=src python -m repro_torch.analysis.train_profile \
        --arch rwkv6_7b --precision bf16
    PYTHONPATH=src python -m repro_torch.analysis.train_profile \
        --arch zamba2_7b --precision bf16
    PYTHONPATH=src python -m repro_torch.analysis.train_profile \
        --arch qwen2_7b --precision bf16
    PYTHONPATH=src python -m repro_torch.analysis.train_profile \
        --arch olmoe_1b_7b --precision bf16
    PYTHONPATH=src python -m repro_torch.analysis.train_profile \
        --arch seamless_m4t_medium --precision bf16

Trains ``--arch``'s full-width config (default ``paper_atis_tt``;
``tnn_one_card`` where the arch has one, as ``zamba2_7b`` does, else
``tnn_default``; ``cuda`` backend, bf16, seed 0) at the train CLI's
default batch 8 x seq 128 (an encoder-decoder: 8 x 128 encoder frames,
``modality.frame_embeddings`` seeded by the step, and 8 x 128 decoder
tokens), once per ``--precision`` (default: each entry
of :data:`PRECISIONS`, the tensorized layers' ``--tnn-precision`` with
its loss scale; ``fp8`` runs every plan through the scaled and
quantize/dequantize kernels), with
the train loop's pieces (:func:`repro_torch.launch.steps.build_model`,
:class:`~repro_torch.optim.adamw.AdamW`,
:func:`~repro_torch.launch.steps.make_train_step`): :data:`WARMUP` steps,
then :data:`STEPS` steps timed without the profiler, then :data:`STEPS`
more under ``torch.profiler`` with CPU and CUDA activities.  Prints one JSON
line per precision: wall ms per step with and without the profiler (host clock around
steps that end in a synchronise), device busy ms per step (the sum of
device-side kernel and copy times; one stream, so they do not overlap),
the device's idle share against the unprofiled wall time, device time
and device events (kernel launches and copies) per step by group — the
port's kernels by their names (the scaled GEMM and chain by their
fp8/int8 template arguments), PyTorch's own matrix products as
``torch_gemm``, the rest as ``torch`` — with the ten largest kernels by
name, and device time by phase: the kernel time inside the tensorized
layers' ``tnn.fp`` / ``tnn.bp`` / ``tnn.wg`` ranges, attention's
``attn.fwd`` / ``attn.bwd``, the scan's ``ssm.scan`` (forward kernel and
the plain twin's backward), a MoE layer's ``moe.route`` (router, top-k,
slot tables, dispatch gather), ``moe.experts`` (the expert FFNs: their
``tnn.fp`` ranges inside) and ``moe.combine`` (the scatter-add), and
AdamW's ``optim.update`` (``tnn.fp`` and the ``moe.*`` forward ranges
hold the forward twice under remat), beside each range's span on the
device timeline.  Needs a CUDA card; if the profiler records no
device time, the device figures are reported as not measured.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

BATCH, SEQ = 8, 128   # the train CLI's defaults
WARMUP, STEPS = 5, 3
#: (--tnn-precision, loss scale) of each profiled run
PRECISIONS = (("bf16", 1.0), ("fp8", 128.0))
#: substrings of the port's kernel names -> report group, first match
#: wins (a scaled kernel's name carries its fp8/int8 operand type;
#: "dequantize_kernel" contains "quantize_kernel", so it comes first, and
#: the requantize kernels, ``requant_block_kernel`` / ``requant_amax_kernel``
#: / ``requant_cast_kernel``, have a prefix of their own)
GROUPS = (("requant_", "requantize"),
          ("dequantize_kernel", "dequantize"),
          ("quantize_kernel", "quantize"),
          ("gemm_tc_kernel<__nv_fp8", "matmul_scaled"),
          ("gemm_tc_kernel<signed char", "matmul_scaled"),
          ("gemm_splitk_reduce<__nv_fp8", "matmul_scaled"),
          ("gemm_splitk_reduce<signed char", "matmul_scaled"),
          ("gemm_tc_kernel", "matmul"),
          ("gemm_simt_kernel", "matmul"),
          ("gemm_splitk_reduce", "matmul"),
          ("chain_tc_kernel<__nv_fp8", "chain_n_scaled"),
          ("chain_tc_kernel<signed char", "chain_n_scaled"),
          ("chain_tc_kernel", "chain_n"),
          ("chain_kernel", "chain_n"),
          ("flash_fwd", "flash_attention_fwd"),
          ("scan_tc_kernel", "linear_scan"),
          ("gemm", "torch_gemm"))
#: profiler ranges the training path opens around its phases
PHASES = ("tnn.fp", "tnn.bp", "tnn.wg", "attn.fwd", "attn.bwd", "ssm.scan",
          "moe.route", "moe.experts", "moe.combine", "optim.update")


def _group(name: str) -> str:
    for key, group in GROUPS:
        if key in name:
            return group
    return "torch"


def profile(precision: str = "bf16", loss_scale: float = 1.0,
            arch_id: str = "paper_atis_tt", phase_paths: bool = True,
            model=None, warmup: int = WARMUP, steps: int = STEPS) -> dict:
    """One precision's profile (the module's docstring); ``phase_paths``
    False profiles the ablation, autodiff through the FP plans.  A
    ``model`` already built on the card (``arch_id``'s, with its own TNN
    config) is trained as it is instead of a new one.  ``warmup`` and
    ``steps`` replace :data:`WARMUP` and :data:`STEPS`."""
    import dataclasses

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from repro_torch.configs import base as cfgbase
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import modality
    from repro_torch.optim.adamw import AdamW
    from repro_torch.precision.policy import QuantPolicy

    if not torch.cuda.is_available():
        raise SystemExit("train_profile: needs a CUDA card")
    batch, seq = BATCH, SEQ
    arch = cfgbase.get(arch_id)
    tnn = dataclasses.replace(arch.tnn_one_card or arch.tnn_default,
                              precision=QuantPolicy.parse(precision),
                              phase_paths=phase_paths)
    if model is None:
        model, cfg = steps_lib.build_model(arch, tnn, device="cuda", seed=0,
                                           backend="cuda")
    else:
        cfg = model.cfg
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch))
    total = warmup + 2 * steps
    opt = AdamW(lr=3e-3, total_steps=max(total, 2),
                warmup_steps=min(20, total), loss_scale=loss_scale)
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    step_fn = steps_lib.make_train_step(model, opt)

    def run(s):
        nonlocal state
        b = {k: torch.as_tensor(v).to("cuda")
             for k, v in data.batch(s).items()}
        if arch.model_kind == "encdec":
            b = {"enc_embeds": modality.frame_embeddings(
                     torch.Generator().manual_seed(s), batch, seq,
                     cfg.d_model, cfg.compute_dtype, "cuda"),
                 "dec_inputs": b["inputs"], "dec_targets": b["targets"]}
        state, m = step_fn(state, b)
        return float(m["loss"])

    def timed(s, out):
        t0 = time.perf_counter()
        run(s)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)

    for s in range(warmup):
        run(s)
    torch.cuda.synchronize()
    plain_wall, wall = [], []
    for s in range(warmup, warmup + steps):
        timed(s, plain_wall)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for s in range(warmup + steps, total):
            timed(s, wall)
    # Device-side events: kernels and copies, and the device spans of the
    # phase ranges (the profiler mirrors each record_function range onto
    # the device timeline; its span includes idle gaps).  A phase's busy
    # time is the kernel time that starts inside its spans.
    kernels, spans = [], {p: [] for p in PHASES}
    for e in prof.events():
        if str(e.device_type).split(".")[-1] != "CUDA":
            continue
        rng = (e.time_range.start, e.time_range.end)
        if e.name in spans:
            spans[e.name].append(rng)
        else:
            kernels.append((e.name, *rng))
    by_group: dict[str, float] = {}
    by_name: dict[str, float] = {}
    launches: dict[str, int] = {}
    for name, t0, t1 in kernels:
        by_group[_group(name)] = by_group.get(_group(name), 0.0) + t1 - t0
        by_name[name] = by_name.get(name, 0.0) + t1 - t0
        launches[_group(name)] = launches.get(_group(name), 0) + 1
    by_phase = {p: sum(t1 - t0 for _, t0, t1 in kernels
                       if any(a <= t0 < b for a, b in spans[p]))
                for p in PHASES}
    span_ms = {p: sum(b - a for a, b in spans[p]) / 1e3 / steps
               for p in PHASES}
    wall_ms = statistics.median(plain_wall) * 1e3
    busy_ms = sum(by_group.values()) / 1e3 / steps
    measured = busy_ms > 0
    return {
        "arch": arch_id, "precision": precision, "loss_scale": loss_scale,
        "phase_paths": phase_paths,
        "batch": batch, "seq": seq,
        "steps_profiled": steps, "device": torch.cuda.get_device_name(0),
        "wall_ms_per_step": wall_ms,
        "wall_ms_per_step_profiled": statistics.median(wall) * 1e3,
        "device_busy_ms_per_step": busy_ms if measured else "not measured",
        "device_idle_share": (1 - busy_ms / wall_ms) if measured
        else "not measured",
        "device_ms_per_step_by_group": {
            g: us / 1e3 / steps for g, us in sorted(by_group.items())},
        "device_events_per_step": len(kernels) / steps,
        "device_events_per_step_by_group": {
            g: c / steps for g, c in sorted(launches.items())},
        "device_ms_per_step_by_phase": (
            {p: us / 1e3 / steps for p, us in by_phase.items()}
            if any(spans.values()) else "not measured"),
        "device_span_ms_per_step_by_phase": span_ms,
        "top_kernels_ms_per_step": [
            [name[:120], us / 1e3 / steps] for name, us in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:10]],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="paper_atis_tt")
    ap.add_argument("--precision", action="append",
                    choices=[p for p, _ in PRECISIONS],
                    help="profile this precision (repeatable; default: "
                         "all of PRECISIONS)")
    args = ap.parse_args(argv)
    for precision, loss_scale in PRECISIONS:
        if args.precision is None or precision in args.precision:
            print(json.dumps({"phase": "train_profile", **profile(
                precision, loss_scale, args.arch)}), flush=True)


if __name__ == "__main__":
    main()
