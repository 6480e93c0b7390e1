#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
``nvcc``; it exits non-zero without a result line when either the card
or the port's sources are missing.  Phases, each printing one JSON line
and failing the script when it fails:

1. ``env`` — card name and power limit, torch/CUDA versions, and the
   time to build every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once).
2. ``kernel:matmul`` / ``kernel:chain_n`` — every GEMM and chain geometry
   the serving path gives the kernels (``paper_atis_tt`` at full width,
   the prefill and decode token batches), in bf16 and f32, then every
   further geometry of the training path's FP/BP/WG plans (batch 8 x seq
   128 tokens), checked in both types and timed in bf16: the kernel
   against its plain PyTorch version on the same inputs, and the times
   of kernel, plain version and (for the GEMM) ``torch.matmul`` as a
   yardstick, beside the least time the card could take.
3. ``kernel:flash_attention_fwd`` — the attention kernel against its
   plain version (out and lse) in bf16 and f32, both stepping over the
   same kv chunk: at the training shape and the model's chunks, at T 1024
   causal (4 chunks) and not (1 chunk of 1024), and at a GQA shape (G 4,
   D 128, 4 chunks); its time beside the plain version's,
   ``scaled_dot_product_attention``'s and the bound.  Then every element
   of its bf16 output on ``flash_attention.rounding_probe`` within one ulp
   of the plain version's, where the plain version without ``p``'s
   rounding, or stepped over half the chunk, misses by more than four.
4. ``serve`` — ``paper_atis_tt`` at full width through the port's
   ``ServeEngine`` with the ``cuda`` backend (8 greedy requests, batch 4,
   prompt 16, 16 new tokens, prefill chunk 32); every request must
   complete, the GEMM and chain kernels must have launched, and no chain
   may have degraded at run time.
5. ``serve_parity`` — the same model on the ``einsum`` backend: bf16
   logits of the first prefill and decode ticks within tolerance, and
   identical greedy tokens in f32.
6. ``train`` — ``paper_atis_tt`` at full width through the port's train
   entry point (``repro_torch.launch.train.train``), ``cuda`` backend,
   bf16, batch 8, seq 128, 20 steps from seed 0: every loss finite, the
   mean of the last 5 below the first, all three kernels launched, no
   runtime degrade.
7. ``train_parity`` — the same initial parameters on the ``cuda`` and
   ``einsum`` backends for 3 steps on the same batches: loss and grad
   norm within tolerance in f32 and in bf16.

It then prints the ``{"kernels": [...]}`` line (every ported kernel with
its launches in the serve run and the train run and its timings at the
main paths' shapes), the card's ``nvidia-smi`` name and power limit,
and, last, ``{"ok": true, ...}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# The least time the card could take: device-memory rate and dense peaks
# of one H100 SXM at its 700 W limit (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# Serve-phase shape: the reference serve CLI's defaults, all greedy.
ARCH, BATCH, PROMPT, MAX_NEW, CHUNK, REQUESTS = ("paper_atis_tt", 4, 16, 16,
                                                 32, 8)
# Train-phase shape: the reference train CLI's defaults (batch, seq, lr).
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 128, 20, 3e-3
PARITY_STEPS = 3
# Attention shapes (B, T, H, KV, D, causal, kv_chunk): the training
# path's first; kv_chunk None is the model config's (the main path's).
FLASH_SHAPES = [(8, 128, 12, 12, 64, True, None),
                (2, 1024, 12, 12, 64, True, 256),
                (2, 1024, 12, 12, 64, False, None),
                (2, 256, 16, 4, 128, True, 64)]

DEVICE = "cuda"

REPLACES = {
    "matmul": "src/repro/kernels/fused_contraction.py:186",
    "chain_n": "src/repro/kernels/fused_contraction.py:317",
    "flash_attention_fwd": "src/repro/kernels/flash_attention.py:77",
}
SOURCES = {
    "matmul": "src/repro_torch/kernels/csrc/fused_contraction.cu",
    "chain_n": "src/repro_torch/kernels/csrc/fused_contraction.cu",
    "flash_attention_fwd": "src/repro_torch/kernels/csrc/flash_attention.cu",
}
KERNELS = ("matmul", "chain_n", "flash_attention_fwd")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, inner: int = 20, reps: int = 25) -> float:
    """Median device time of one ``fn()`` call: ``inner`` calls captured
    in a CUDA graph (no host launch cost between them), replayed ``reps``
    times between CUDA events after warm-up."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def bound_ms(nbytes: int, flops: int, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bf16_ulp(scale: float) -> float:
    """One bf16 ulp at magnitude ``scale`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)


def main_path_geometries(cfg, plan_compiler, profiles, tensorized):
    """Every distinct GEMM ``(m, n, k, transpose_rhs)`` and chain
    ``(m0, link_shapes)`` the serve path launches: the compiled FP plans
    of each tensorized projection at the prefill and decode batches."""
    gemms, chains = set(), set()
    for tokens in (BATCH * CHUNK, BATCH):
        for _, d_in, d_out in profiles.tensorized_projections(cfg):
            layer = tensorized.make_tensorized_linear(
                d_out, d_in, cfg.tnn, compute_dtype=cfg.compute_dtype,
                device="meta")
            plan = tensorized.fp_plan(layer.fact, tokens, layer.opts).plan
            compiled = plan_compiler.compile_cached(
                plan, fuse=layer.opts.fused_chain,
                max_chain_len=layer.opts.max_chain_len)
            for op in compiled.ops:
                if isinstance(op, plan_compiler.GemmOp):
                    m = op.mat
                    gemms.add((m.m, m.n, m.k, m.transpose_rhs))
                elif isinstance(op, plan_compiler.ChainOp):
                    chains.add((op.m0, op.link_shapes))
    return sorted(gemms), sorted(chains)


def train_path_geometries(cfg, plan_compiler, profiles, tensorized):
    """Every GEMM and chain geometry of the training step's FP, BP and WG
    plans (``{geometry: phases}``), and the number of steps those plans
    lower to ``EinsumOp`` (the einsum fallback)."""
    gemms, chains, einsum_ops = {}, {}, 0
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for _, d_in, d_out in profiles.tensorized_projections(cfg):
        layer = tensorized.make_tensorized_linear(
            d_out, d_in, cfg.tnn, compute_dtype=cfg.compute_dtype,
            device="meta")
        for phase, results in tensorized.phase_plans(
                layer.fact, tokens, layer.opts).items():
            for r in results:
                compiled = plan_compiler.compile_cached(
                    r.plan, fuse=layer.opts.fused_chain,
                    max_chain_len=layer.opts.max_chain_len)
                for op in compiled.ops:
                    if isinstance(op, plan_compiler.GemmOp):
                        m = op.mat
                        gemms.setdefault((m.m, m.n, m.k, m.transpose_rhs),
                                         set()).add(phase)
                    elif isinstance(op, plan_compiler.ChainOp):
                        chains.setdefault((op.m0, op.link_shapes),
                                          set()).add(phase)
                    else:
                        einsum_ops += 1
    return gemms, chains, einsum_ops


def new_totals() -> dict:
    return {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
            "max_abs_err": 0.0, "bound_by": set(), "shapes": 0}


def add_total(t: dict, ms, plain, lib, b, by) -> None:
    t["ms"] += ms
    t["plain_ms"] += plain
    t["library_ms"] = None if lib is None else t["library_ms"] + lib
    t["bound_ms"] += b
    t["bound_by"].add(by)
    t["shapes"] += 1


def kernel_phase(torch, fc, ref, gemms, chains, totals, *, path: str,
                 phases=None, time_dtypes=("bfloat16", "float32")) -> None:
    """Hold each kernel against its plain version at every geometry
    (bf16 and f32); time both (in ``time_dtypes``), and torch.matmul for
    the GEMM.  bf16 times add to ``totals[kernel][path]`` and, for WG
    geometries, to ``totals[kernel]["wg"]``."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    phases = phases or {}

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)

    def account(name, geo, dname, err, timed):
        t = totals[name]
        t["max_abs_err"] = max(t["max_abs_err"], err)
        if timed is None or dname != "bfloat16":
            return
        add_total(t.setdefault(path, new_totals()), *timed)
        if "wg" in phases.get(geo, ()):
            add_total(t.setdefault("wg", new_totals()), *timed)

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        size = dtype.itemsize
        timing = dname in time_dtypes
        for m, n, k, trans in gemms:
            x = rand((m, k), dtype)
            w = rand((n, k) if trans else (k, n), dtype)
            got = fc.matmul_cuda(x, w, transpose_rhs=trans)
            want = ref.matmul(x, w, transpose_rhs=trans)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            tol = (1e-5 * scale if dtype == torch.float32
                   else bf16_ulp(scale))
            geo = (m, n, k, trans)
            rec = {"path": path, "m": m, "n": n, "k": k,
                   "transpose_rhs": trans, "phases": sorted(phases.get(
                       geo, ())), "dtype": dname, "max_abs_err": err,
                   "max_rel_err": err / max(scale, 1e-30), "scale": scale,
                   "tol": tol}
            if not err <= tol:
                emit("kernel:matmul", ok=False, **rec)
                raise AssertionError(f"matmul kernel disagrees: {rec}")
            timed = None
            if timing:
                ms = device_ms(torch, lambda: fc.matmul_cuda(
                    x, w, transpose_rhs=trans))
                plain = device_ms(torch, lambda: ref.matmul(
                    x, w, transpose_rhs=trans))
                lib = device_ms(torch, lambda: torch.matmul(
                    x, w.t() if trans else w))
                b, by = bound_ms((m * k + k * n + m * n) * size,
                                 2 * m * n * k, dname)
                timed = (ms, plain, lib, b, by)
                rec.update(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=b, bound_by=by)
            emit("kernel:matmul", ok=True, **rec)
            account("matmul", geo, dname, err, timed)
        for m0, shapes in chains:
            x = rand((m0, shapes[0][0]), dtype)
            ws = [rand(s, dtype) for s in shapes]
            got = fc.chain_n_cuda(x, ws)
            want = ref.chain_n(x, ws)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            # f32: sums in another order.  bf16: the same, and a rounding
            # of an intermediate to bf16 can land one ulp apart, which the
            # next link carries into the output: two ulps of its scale.
            tol = (1e-5 * scale if dtype == torch.float32
                   else 2 * bf16_ulp(scale))
            rows, _ = fc.chain_plan(m0, shapes)
            geo = (m0, shapes)
            rec = {"path": path, "m0": m0, "links": [list(s) for s in shapes],
                   "phases": sorted(phases.get(geo, ())), "dtype": dname,
                   "band_rows": fc.chain_band_rows(m0, shapes),
                   "max_abs_err": err, "max_rel_err": err / max(scale, 1e-30),
                   "scale": scale, "tol": tol}
            if not err <= tol:
                emit("kernel:chain_n", ok=False, **rec)
                raise AssertionError(f"chain kernel disagrees: {rec}")
            timed = None
            if timing:
                ms = device_ms(torch, lambda: fc.chain_n_cuda(x, ws))
                plain = device_ms(torch, lambda: ref.chain_n(x, ws))
                nbytes = (m0 * shapes[0][0] + sum(a * c for a, c in shapes)
                          + rows[-1] * shapes[-1][1]) * size
                flops = sum(2 * r * a * c for r, (a, c) in zip(rows, shapes))
                b, by = bound_ms(nbytes, flops, dname)
                timed = (ms, plain, None, b, by)
                rec.update(ms=ms, plain_ms=plain, library_ms=None,
                           bound_ms=b, bound_by=by)
            emit("kernel:chain_n", ok=True, **rec)
            account("chain_n", geo, dname, err, timed)


def flash_phase(torch, fa, ref, cfg, totals) -> None:
    """Hold the attention kernel against its plain version (out and lse)
    at every ``FLASH_SHAPES`` entry in bf16 and f32, both stepping the
    online softmax over the same kv chunk (the model config's, as the
    training path passes it, or the entry's), and time it beside the
    plain version and scaled_dot_product_attention.  Then, at the
    training shape and chunk, hold every element of its bf16 output on
    the rounding probe to one ulp, where a kernel that skipped ``p``'s
    rounding or stepped over half the chunk misses by several."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for i, (B, T, H, KV, D, causal, kv_chunk) in enumerate(FLASH_SHAPES):
        chunks = dict(q_chunk=min(cfg.q_chunk, T),
                      kv_chunk=min(kv_chunk or cfg.kv_chunk, T))
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            q, k, v = (torch.randn(s, generator=gen, device=DEVICE).to(dtype)
                       for s in ((B, T, H, D), (B, T, KV, D), (B, T, KV, D)))
            out, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                              **chunks)

            def plain():
                return ref.flash_attention_fwd(q, k, v, causal=causal,
                                               **chunks)

            want, want_lse = plain()
            torch.cuda.synchronize()
            scale = want.float().abs().max().item()
            err = (out.float() - want.float()).abs().max().item()
            lse_scale = want_lse.abs().max().item()
            lse_err = (lse - want_lse).abs().max().item()
            # f32: sums in another order.  bf16: out is rounded to bf16
            # once, and p's rounding can land one ulp apart where the two
            # sum the score in another order: one ulp of the scale.
            tol = (1e-5 * scale if dtype == torch.float32
                   else bf16_ulp(scale))
            ok = err <= tol and lse_err <= 1e-5 * lse_scale
            rec = {"B": B, "T": T, "H": H, "KV": KV, "D": D,
                   "causal": causal, **chunks, "dtype": dname,
                   "max_abs_err": err,
                   "max_rel_err": err / max(scale, 1e-30), "scale": scale,
                   "tol": tol, "lse_max_rel_err": lse_err / lse_scale}
            if not ok:
                emit("kernel:flash_attention_fwd", ok=False, **rec)
                raise AssertionError(f"attention kernel disagrees: {rec}")
            qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            ms = device_ms(torch, lambda: fa.flash_attention_fwd(
                q, k, v, causal=causal, **chunks))
            plain_ms = device_ms(torch, plain)
            lib = device_ms(torch, lambda: sdpa(qs, ks, vs, is_causal=causal,
                                                enable_gqa=H != KV))
            nbytes = ((q.numel() + k.numel() + v.numel() + out.numel())
                      * dtype.itemsize + lse.numel() * 4)
            flops = 4 * B * H * T * T * D // (2 if causal else 1)
            b, by = bound_ms(nbytes, flops, dname)
            emit("kernel:flash_attention_fwd", ok=True, ms=ms,
                 plain_ms=plain_ms, library_ms=lib, bound_ms=b, bound_by=by,
                 **rec)
            t = totals["flash_attention_fwd"]
            t["max_abs_err"] = max(t["max_abs_err"], err)
            if i == 0 and dtype == torch.bfloat16:   # the training shape
                add_total(t.setdefault("train", new_totals()), ms, plain_ms,
                          lib, b, by)

    # The rounding probe at the training shape and chunk (non-causal).
    B, T, H, _, D, _, _ = FLASH_SHAPES[0]
    kc = min(cfg.kv_chunk, T)
    q, k, v = fa.rounding_probe(B, T, H, D, device=DEVICE)
    kw = dict(causal=False, q_chunk=T, kv_chunk=kc)
    out, _ = fa.flash_attention_fwd(q, k, v, **kw)
    want, _ = ref.flash_attention_fwd(q, k, v, **kw)
    unrounded, _ = ref.flash_attention_fwd(q, k, v.float(), **kw)
    half, _ = ref.flash_attention_fwd(q, k, v, causal=False, q_chunk=T,
                                      kv_chunk=max(kc // 2, 1))
    w = want.float()
    ulp = 2.0 ** (torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)

    def ulps(x):
        return (x.float() - w).abs() / ulp

    rec = {"check": "rounding_probe", "B": B, "T": T, "H": H, "D": D,
           "kv_chunk": kc, "dtype": "bfloat16",
           "max_elem_ulps": ulps(out).max().item(),
           "unrounded_min_elem_ulps": ulps(unrounded).min().item(),
           "half_chunk_min_elem_ulps_peak_last":
               ulps(half)[:, :, 1::2].min().item(), "tol_elem_ulps": 1.0}
    ok = (rec["max_elem_ulps"] <= 1.0
          and rec["unrounded_min_elem_ulps"] > 4.0
          and rec["half_chunk_min_elem_ulps_peak_last"] > 4.0)
    emit("kernel:flash_attention_fwd", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"attention kernel fails the probe: {rec}")
    totals["flash_attention_fwd"]["max_abs_err"] = max(
        totals["flash_attention_fwd"]["max_abs_err"],
        (out.float() - w).abs().max().item())


def serve_requests(vocab: int, Request):
    import numpy as np
    rng = np.random.default_rng(0)
    return [Request(rid=rid, prompt=rng.integers(0, vocab, size=PROMPT,
                                                 dtype=np.int32),
                    max_new_tokens=MAX_NEW, temperature=0.0)
            for rid in range(REQUESTS)]


def run_engine(torch, model, vocab, ServeEngine, Request):
    """Serve the phase's requests; returns (completed, wall seconds of
    ``engine.run()``, engine).  Nothing times the ticks inside the run."""
    engine = ServeEngine(model, batch_size=BATCH,
                         max_len=PROMPT + MAX_NEW + 8, prefill_chunk=CHUNK)
    for req in serve_requests(vocab, Request):
        engine.submit(req)
    engine.warmup()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    return done, time.perf_counter() - t0, engine


def tick_spans_ms(torch, tm, model, vocab, ServeEngine, Request) -> dict:
    """Tick times from the engine's own ``serve.prefill_chunk`` /
    ``serve.decode_step`` spans, over one traced run of the phase's
    requests (with tracing on, each span closes when the card is done)."""
    tm.reset()
    tm.configure()
    try:
        run_engine(torch, model, vocab, ServeEngine, Request)
        spans = [e for e in tm.snapshot() if e.get("type") == "span"]
    finally:
        tm.reset()
    return {name: [e["dur"] / 1e3 for e in spans
                   if e["name"] == f"serve.{span}"]
            for name, span in (("prefill", "prefill_chunk"),
                               ("decode", "decode_step"))}


def train_phase(torch, fc, plan_compiler, train_cli, einsum_ops) -> dict:
    """Full-width training through the port's train entry point; returns
    the kernel launches of the run."""
    import numpy as np
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fc.reset_launches()
    plan_compiler.reset_degrade_counts()
    t0 = time.perf_counter()
    out = train_cli.train(ARCH, smoke=False, tnn=True, steps=TRAIN_STEPS,
                          global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                          lr=TRAIN_LR, tnn_backend="cuda", device=DEVICE,
                          log_every=5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fc.LAUNCHES)
    degrades = dict(plan_compiler.DEGRADE_COUNTS)
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    step_ms = statistics.median(out["step_s"][3:]) * 1e3
    ok = (all(np.isfinite(losses)) and len(losses) == TRAIN_STEPS
          and statistics.mean(losses[-5:]) < losses[0]
          and all(launches[k] > 0 for k in KERNELS)
          and degrades["runtime"] == 0)
    cfg = out["cfg"]
    emit("train", ok=bool(ok), arch=ARCH, d_model=cfg.d_model,
         layers=cfg.num_layers, remat=cfg.remat,
         dtype=str(cfg.compute_dtype).split(".")[-1], batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, steps=TRAIN_STEPS, losses=losses,
         grad_norms=out["grad_norms"], first_loss=losses[0],
         last5_mean_loss=statistics.mean(losses[-5:]),
         step_ms_median_after_3=step_ms,
         tok_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
         first_step_s=out["step_s"][0], wall_s=wall,
         launches=launches,
         launches_per_step={k: launches[k] / TRAIN_STEPS for k in KERNELS},
         degrades=degrades, einsum_ops_in_plans=einsum_ops,
         max_memory_allocated=peak)
    if not ok:
        raise AssertionError("train phase failed")
    return launches


def train_parity_phase(torch, arch, steps_lib) -> None:
    """The same initial parameters trained on the cuda and einsum
    backends for PARITY_STEPS steps on the same batches."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim.adamw import AdamW
    # f32: the executors sum in other orders; 1e-4 relative holds that
    # apart from a wrong result.  bf16: roundings to bf16 between the
    # contraction steps land at other points and grow over the steps.
    tols = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 5e-2)}
    report, ok = {}, True
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        runs = {}
        base_sd = None
        for backend in ("cuda", "einsum"):
            model, cfg = steps_lib.build_model(arch, device=DEVICE, seed=0,
                                               backend=backend,
                                               compute_dtype=dtype)
            if base_sd is None:
                base_sd = {k: v.clone() for k, v in
                           model.state_dict().items()}
            else:
                model.load_state_dict(base_sd)
            data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                          global_batch=TRAIN_BATCH))
            opt = AdamW(lr=TRAIN_LR, total_steps=TRAIN_STEPS,
                        warmup_steps=TRAIN_STEPS)
            params = dict(model.named_parameters())
            state = {"params": params, "opt": opt.init(params)}
            step = steps_lib.make_train_step(model, opt)
            hist = []
            for s in range(PARITY_STEPS):
                batch = {k: torch.as_tensor(v).to(DEVICE)
                         for k, v in data.batch(s).items()}
                state, m = step(state, batch)
                hist.append((float(m["loss"]), float(m["grad_norm"])))
            runs[backend] = hist
        loss_rel = [abs(a[0] - b[0]) / abs(b[0])
                    for a, b in zip(runs["cuda"], runs["einsum"])]
        gn_rel = [abs(a[1] - b[1]) / abs(b[1])
                  for a, b in zip(runs["cuda"], runs["einsum"])]
        tl, tg = tols[dname]
        good = max(loss_rel) <= tl and max(gn_rel) <= tg
        ok = ok and good
        report[dname] = {"ok": good, "cuda": runs["cuda"],
                         "einsum": runs["einsum"], "loss_rel": loss_rel,
                         "grad_norm_rel": gn_rel, "tol_loss_rel": tl,
                         "tol_grad_norm_rel": tg}
    emit("train_parity", ok=ok, steps=PARITY_STEPS, **report)
    if not ok:
        raise AssertionError("train parity failed")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import telemetry as tm
    from repro_torch.configs import base as cfgbase
    from repro_torch.core import plan_compiler, tensorized
    from repro_torch.kernels import build, fused_contraction as fc, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train as train_cli
    from repro_torch.serving import profiles
    from repro_torch.serving.engine import Request, ServeEngine

    # -- 1. env ---------------------------------------------------------------
    smi = nvidia_smi()
    t0 = time.perf_counter()
    build_s = build.build_all()
    emit("env", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], build_s=build_s,
         build_wall_s=time.perf_counter() - t0)

    # -- 2./3. kernels at every main-path geometry ------------------------------
    arch = cfgbase.get(ARCH)
    cfg = arch.model()
    totals = {name: new_totals() for name in KERNELS}
    gemms, chains = main_path_geometries(cfg, plan_compiler, profiles,
                                         tensorized)
    kernel_phase(torch, fc, ref, gemms, chains, totals, path="serve")
    t_gemms, t_chains, train_einsum_ops = train_path_geometries(
        cfg, plan_compiler, profiles, tensorized)
    kernel_phase(torch, fc, ref,
                 sorted(g for g in t_gemms if g not in set(gemms)),
                 sorted(c for c in t_chains if c not in set(chains)),
                 totals, path="train", phases={**t_gemms, **t_chains},
                 time_dtypes=("bfloat16",))
    flash_phase(torch, fa, ref, cfg, totals)
    emit("kernel_totals", ok=True, bf16_sums={
        name: {path: {k: (sorted(v) if isinstance(v, set) else v)
                      for k, v in t.items()}
               for path, t in totals[name].items() if isinstance(t, dict)}
        for name in KERNELS},
        train_geometries={"gemm": len(t_gemms), "chain": len(t_chains)})

    # -- 4. serve at full width through the kernels -----------------------------
    model, cfg = steps_lib.build_model(arch, device=DEVICE, seed=0,
                                       backend="cuda")
    profiles.build_profiles(cfg, batch_size=BATCH, prefill_chunk=CHUNK)
    fc.reset_launches()
    plan_compiler.reset_degrade_counts()
    done, secs, engine = run_engine(torch, model, cfg.vocab, ServeEngine,
                                    Request)
    launches = {"serve": dict(fc.LAUNCHES)}
    degrades = dict(plan_compiler.DEGRADE_COUNTS)
    tick_ms = tick_spans_ms(torch, tm, model, cfg.vocab, ServeEngine,
                            Request)
    tokens = sum(len(r.out_tokens) for r in done)
    cuda_tokens = {r.rid: r.out_tokens for r in done}
    ok = (len(done) == REQUESTS
          and all(len(r.out_tokens) == MAX_NEW for r in done)
          and launches["serve"]["matmul"] > 0
          and launches["serve"]["chain_n"] > 0
          and degrades["runtime"] == 0
          and tick_ms["prefill"] and tick_ms["decode"])
    emit("serve", ok=bool(ok), arch=ARCH, d_model=cfg.d_model,
         layers=cfg.num_layers, requests=len(done), tokens=tokens,
         seconds=secs, tok_per_s=tokens / secs, ticks=engine.tick,
         prefill_tick_ms=tick_ms["prefill"],
         decode_tick_ms_median=statistics.median(tick_ms["decode"] or [0]),
         decode_ticks=len(tick_ms["decode"]),
         launches=launches["serve"], degrades=degrades)
    if not ok:
        raise AssertionError("serve phase failed")

    # -- 5. parity with the einsum executor ------------------------------------
    import numpy as np
    ein, _ = steps_lib.build_model(arch, device=DEVICE, seed=0,
                                   backend="einsum")
    ein.load_state_dict(model.state_dict())
    reqs = serve_requests(cfg.vocab, Request)[:BATCH]
    toks = np.zeros((BATCH, CHUNK), np.int32)
    for i, r in enumerate(reqs):
        toks[i, :PROMPT] = r.prompt
    valid = torch.full((BATCH,), PROMPT, dtype=torch.int32)
    diffs = {}
    with torch.inference_mode():
        outs = []
        for m in (model, ein):
            cache = m.init_cache(BATCH, PROMPT + MAX_NEW + 8 + CHUNK)
            cache = cache._replace(length=torch.zeros(BATCH,
                                                      dtype=torch.int32))
            lp, cache = m.extend(torch.as_tensor(toks, device=DEVICE),
                                 cache, valid=valid)
            nxt = lp[:, PROMPT - 1].float().argmax(-1) if not outs else (
                outs[0][2])
            ld, _ = m.decode_step(nxt, cache)
            outs.append((lp[:, :PROMPT].float(), ld.float(), nxt))
    for name, a, b in (("prefill", outs[0][0], outs[1][0]),
                       ("decode", outs[0][1], outs[1][1])):
        diffs[name] = {"max_abs_diff": (a - b).abs().max().item(),
                       "mean_abs_diff": (a - b).abs().mean().item(),
                       "max_abs_logit": b.abs().max().item()}
    # bf16 tolerance: the executors sum each contraction in another order,
    # so a bf16 rounding can land one ulp apart and propagate through both
    # layers; 5% of the logit scale separates that from a wrong result.
    tol_rel = 0.05
    bf16_ok = all(d["max_abs_diff"] <= tol_rel * d["max_abs_logit"]
                  for d in diffs.values())

    f32_tokens = {}
    for backend in ("cuda", "einsum"):
        m32, c32 = steps_lib.build_model(arch, device=DEVICE, seed=0,
                                         backend=backend,
                                         compute_dtype=torch.float32)
        m32.load_state_dict(model.state_dict())
        d32, _, _ = run_engine(torch, m32, c32.vocab, ServeEngine, Request)
        f32_tokens[backend] = {r.rid: r.out_tokens for r in d32}
    f32_ok = f32_tokens["cuda"] == f32_tokens["einsum"]
    emit("serve_parity", ok=bf16_ok and f32_ok, bf16_logits=diffs,
         bf16_tol_rel=tol_rel, f32_greedy_identical=f32_ok,
         bf16_cuda_tokens_req0=cuda_tokens[0],
         f32_tokens_req0=f32_tokens["cuda"][0])
    if not (bf16_ok and f32_ok):
        raise AssertionError("serve parity failed")

    # -- 6. train at full width through the kernels -----------------------------
    launches["train"] = train_phase(torch, fc, plan_compiler, train_cli,
                                    train_einsum_ops)

    # -- 7. training parity with the einsum executor ---------------------------
    train_parity_phase(torch, arch, steps_lib)

    # -- the kernel line ---------------------------------------------------------
    kernels = []
    for name in KERNELS:
        t = totals[name]
        sums = [t[p] for p in ("serve", "train") if p in t]
        by = set().union(*(s_["bound_by"] for s_ in sums))
        lib = [s_["library_ms"] for s_ in sums]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": launches["serve"][name] + launches["train"][name],
            "launches_serve_run": launches["serve"][name],
            "launches_train_run": launches["train"][name],
            "launches_per_train_step": launches["train"][name] / TRAIN_STEPS,
            "max_abs_err": t["max_abs_err"],
            "ms": sum(s_["ms"] for s_ in sums),
            "plain_ms": sum(s_["plain_ms"] for s_ in sums),
            "bound_ms": sum(s_["bound_ms"] for s_ in sums),
            "bound_by": "bytes" if by == {"bytes"} else "operations",
            "library_ms": None if None in lib else sum(lib),
            "shapes_timed": sum(s_["shapes"] for s_ in sums)})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
