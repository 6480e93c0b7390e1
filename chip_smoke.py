#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
``nvcc``; it exits non-zero without a result line when either the card
or the port's sources are missing.  Phases, each printing one JSON line
and failing the script when it fails:

1. ``env`` — card name and power limit, torch/CUDA versions, and the
   time to build every CUDA kernel from ``src/repro_torch/kernels/csrc``.
2. ``kernel:matmul`` / ``kernel:chain_n`` — every GEMM and chain geometry
   the serving path gives the kernels (``paper_atis_tt`` at full width,
   the prefill and decode token batches), in bf16 and f32: the kernel
   against its plain PyTorch version on the same inputs, and the times
   of kernel, plain version and (for the GEMM) ``torch.matmul`` as a
   yardstick, beside the least time the card could take.
3. ``serve`` — ``paper_atis_tt`` at full width through the port's
   ``ServeEngine`` with the ``cuda`` backend (8 greedy requests, batch 4,
   prompt 16, 16 new tokens, prefill chunk 32); every request must
   complete, both kernels must have launched, and no chain may have
   degraded at run time.
4. ``serve_parity`` — the same model on the ``einsum`` backend: bf16
   logits of the first prefill and decode ticks within tolerance, and
   identical greedy tokens in f32.

It then prints the ``{"kernels": [...]}`` line (every ported kernel with
its launches in the serve phase and its timings), the card's
``nvidia-smi`` name and power limit, and, last, ``{"ok": true, ...}``.
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

DEVICE = "cuda"

REPLACES = {
    "matmul": "src/repro/kernels/fused_contraction.py:186",
    "chain_n": "src/repro/kernels/fused_contraction.py:317",
}
SOURCE = "src/repro_torch/kernels/csrc/fused_contraction.cu"


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


def kernel_phase(torch, fc, ref, gemms, chains) -> dict:
    """Hold each kernel against its plain version at every main-path
    geometry (bf16 and f32); time both, and torch.matmul for the GEMM."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "library_ms": 0.0, "max_abs_err": 0.0,
                     "bound_by": set()} for name in ("matmul", "chain_n")}
    totals["chain_n"]["library_ms"] = None

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        size = dtype.itemsize
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
            rec = {"m": m, "n": n, "k": k, "transpose_rhs": trans,
                   "dtype": dname, "max_abs_err": err,
                   "max_rel_err": err / max(scale, 1e-30), "scale": scale,
                   "tol": tol}
            if not err <= tol:
                emit("kernel:matmul", ok=False, **rec)
                raise AssertionError(f"matmul kernel disagrees: {rec}")
            ms = device_ms(torch, lambda: fc.matmul_cuda(
                x, w, transpose_rhs=trans))
            plain = device_ms(torch, lambda: ref.matmul(
                x, w, transpose_rhs=trans))
            lib = device_ms(torch, lambda: torch.matmul(
                x, w.t() if trans else w))
            b, by = bound_ms((m * k + k * n + m * n) * size, 2 * m * n * k,
                             dname)
            emit("kernel:matmul", ok=True, ms=ms, plain_ms=plain,
                 library_ms=lib, bound_ms=b, bound_by=by, **rec)
            t = totals["matmul"]
            t["max_abs_err"] = max(t["max_abs_err"], err)
            if dtype == torch.bfloat16:   # the serve path's dtype
                t["ms"] += ms
                t["plain_ms"] += plain
                t["library_ms"] += lib
                t["bound_ms"] += b
                t["bound_by"].add(by)
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
            rec = {"m0": m0, "links": [list(s) for s in shapes],
                   "dtype": dname, "band_rows": fc.chain_band_rows(m0, shapes),
                   "max_abs_err": err, "max_rel_err": err / max(scale, 1e-30),
                   "scale": scale, "tol": tol}
            if not err <= tol:
                emit("kernel:chain_n", ok=False, **rec)
                raise AssertionError(f"chain kernel disagrees: {rec}")
            ms = device_ms(torch, lambda: fc.chain_n_cuda(x, ws))
            plain = device_ms(torch, lambda: ref.chain_n(x, ws))
            nbytes = (m0 * shapes[0][0] + sum(a * c for a, c in shapes)
                      + rows[-1] * shapes[-1][1]) * size
            flops = sum(2 * r * a * c for r, (a, c) in zip(rows, shapes))
            b, by = bound_ms(nbytes, flops, dname)
            emit("kernel:chain_n", ok=True, ms=ms, plain_ms=plain,
                 library_ms=None, bound_ms=b, bound_by=by, **rec)
            t = totals["chain_n"]
            t["max_abs_err"] = max(t["max_abs_err"], err)
            if dtype == torch.bfloat16:
                t["ms"] += ms
                t["plain_ms"] += plain
                t["bound_ms"] += b
                t["bound_by"].add(by)
    return totals


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
    from repro_torch.launch import steps as steps_lib
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

    # -- 2. kernels at every main-path geometry --------------------------------
    arch = cfgbase.get(ARCH)
    cfg = arch.model()
    gemms, chains = main_path_geometries(cfg, plan_compiler, profiles,
                                         tensorized)
    totals = kernel_phase(torch, fc, ref, gemms, chains)

    # -- 3. serve at full width through the kernels -----------------------------
    model, cfg = steps_lib.build_model(arch, device=DEVICE, seed=0,
                                       backend="cuda")
    profiles.build_profiles(cfg, batch_size=BATCH, prefill_chunk=CHUNK)
    fc.reset_launches()
    plan_compiler.reset_degrade_counts()
    done, secs, engine = run_engine(torch, model, cfg.vocab, ServeEngine,
                                    Request)
    launches = dict(fc.LAUNCHES)
    degrades = dict(plan_compiler.DEGRADE_COUNTS)
    tick_ms = tick_spans_ms(torch, tm, model, cfg.vocab, ServeEngine,
                            Request)
    tokens = sum(len(r.out_tokens) for r in done)
    cuda_tokens = {r.rid: r.out_tokens for r in done}
    ok = (len(done) == REQUESTS
          and all(len(r.out_tokens) == MAX_NEW for r in done)
          and launches["matmul"] > 0 and launches["chain_n"] > 0
          and degrades["runtime"] == 0
          and tick_ms["prefill"] and tick_ms["decode"])
    emit("serve", ok=bool(ok), arch=ARCH, d_model=cfg.d_model,
         layers=cfg.num_layers, requests=len(done), tokens=tokens,
         seconds=secs, tok_per_s=tokens / secs, ticks=engine.tick,
         prefill_tick_ms=tick_ms["prefill"],
         decode_tick_ms_median=statistics.median(tick_ms["decode"] or [0]),
         decode_ticks=len(tick_ms["decode"]),
         launches=launches, degrades=degrades)
    if not ok:
        raise AssertionError("serve phase failed")

    # -- 4. parity with the einsum executor ------------------------------------
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

    # -- 5. the kernel line ----------------------------------------------------
    kernels = []
    for name in ("matmul", "chain_n"):
        t = totals[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bound_by"] == {"bytes"}
                         else "operations"),
            "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
