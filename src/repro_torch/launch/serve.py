"""Batched serving driver (continuous batching over the ServeEngine).

Port of ``src/repro/launch/serve.py``; takes the reference CLI's flags
plus ``--tnn-backend`` (the executor of the tensorized projections:
``cuda`` runs the hand-written kernels, ``pallas`` is its alias,
``einsum`` the plain torch executor) and ``--device``::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch paper_atis_tt \\
      --tnn --tnn-backend cuda --requests 8 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_7b \\
      --tnn --tnn-backend cuda --serve-kv-dtype fp8

``--serve-kv-dtype`` is ``bf16`` (the default) or, for attention models,
a quantized K/V store: ``fp8`` (e4m3), ``fp8_e5m2`` or ``int8``, with
running per-layer scales (:mod:`repro_torch.serving.kv_cache`); the
engine refuses it for the others.  SSM and hybrid models (``rwkv6_7b``,
``zamba2_7b``) are served through the engine's sequential
``decode_step`` fallback.  An embeddings-input architecture
(``llava_next_34b``) is served on token-id prompts; an encoder-decoder
one (``seamless_m4t_medium``) is refused, as the reference engine never
builds one: it serves through ``steps.make_prefill_step`` and
``make_decode_step``.  Server start builds the phase-specialized plan
profiles when the model is tensorized, then runs the slot-table engine.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import telemetry as tm
from repro_torch.configs import base as cfgbase
from repro_torch.core.contraction import canonical_backend
from repro_torch.launch import steps as steps_lib
from repro_torch.memory.planner import format_bytes
from repro_torch.serving import profiles as profiles_lib
from repro_torch.serving.engine import Request, ServeEngine

_log = tm.get_logger("serve")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--tnn", action="store_true")
    ap.add_argument("--tnn-backend", choices=["einsum", "cuda", "pallas"],
                    default=None,
                    help="contraction executor for tensorized layers "
                         "(default: the arch config's TNNConfig.backend)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--serve-kv-dtype", default="bf16",
                    help="KV cache storage: bf16, or fp8 | fp8_e5m2 | int8 "
                         "with running per-layer scales (attention models)")
    ap.add_argument("--serve-memory-budget", default=None,
                    help="KV admission budget, e.g. 64MB (modeled bytes)")
    ap.add_argument("--serve-prefill-chunk", type=int, default=32,
                    help="prompt tokens a slot ingests per tick")
    ap.add_argument("--serve-max-prefill-tokens", type=int, default=None,
                    help="global prefill token budget per tick")
    ap.add_argument("--serve-trace", default=None, metavar="PATH",
                    help="write a telemetry trace of the serving run "
                         "('*.jsonl' streams events, any other suffix "
                         "writes Chrome trace-event JSON)")
    return ap.parse_args(argv)


def main(argv=None) -> list[Request]:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu "
                         "to run the plain versions on the CPU)")
    owns_trace = bool(args.serve_trace) and not tm.enabled()
    if owns_trace:
        tm.configure(args.serve_trace)

    arch = cfgbase.get(args.arch)
    if arch.model_kind == "encdec":
        raise SystemExit(
            f"{arch.id} is an encoder-decoder model, which the engine does "
            "not serve (nor does the reference's): serve it through "
            "repro_torch.launch.steps.make_prefill_step and "
            "make_decode_step")
    tnn_cfg = arch.tnn_default if args.tnn else None
    model, cfg = steps_lib.build_model(arch, tnn=tnn_cfg, smoke=args.smoke,
                                       device=args.device,
                                       backend=args.tnn_backend)

    prof = profiles_lib.build_profiles(
        cfg, batch_size=args.batch, prefill_chunk=args.serve_prefill_chunk)
    if prof:
        print(profiles_lib.profile_summary(prof))

    engine = ServeEngine(
        model, batch_size=args.batch,
        max_len=args.prompt_len + args.max_new + 8,
        prefill_chunk=args.serve_prefill_chunk,
        max_prefill_tokens=args.serve_max_prefill_tokens,
        kv_policy=args.serve_kv_dtype,
        memory_budget=args.serve_memory_budget)
    _log.info(f"slot KV: {format_bytes(engine.slot_cost['total'])} "
              f"({args.serve_kv_dtype}), capacity {engine.capacity}/"
              f"{args.batch} slots, device {args.device}, backend "
              f"{canonical_backend(cfg.tnn.backend)}")
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        engine.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab, size=args.prompt_len,
                                dtype=np.int32),
            max_new_tokens=args.max_new,
            temperature=0.0 if rid % 2 == 0 else 0.8))
    engine.warmup()
    t0 = time.time()
    done = engine.run()
    if args.device == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    total_new = sum(len(r.out_tokens) for r in done)
    _log.info(f"{len(done)} requests, {total_new} tokens "
              f"in {dt:.2f}s ({total_new/dt:.1f} tok/s), "
              f"{engine.tick} ticks, peak occupancy {engine.max_occupancy}")
    for r in done[:4]:
        print(f"  req {r.rid}: {r.out_tokens[:12]}...")
    if owns_trace:
        tm.finalize()
    return done


if __name__ == "__main__":
    main()
