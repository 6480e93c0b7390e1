#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for ``sm_90a``) and
``nvcc``; it exits non-zero without a result line when either the card
or the port's sources are missing.  Phases, each printing one JSON line
and failing the script when it fails:

1. ``env`` — card name and power limit, torch/CUDA versions, and the
   time to build every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started at once; the scan's, the slowest,
   is waited for only at phase 11, which first needs it, and reported
   there); then ``ptxas``: each kernel's registers, stack and spills as
   ``nvcc -Xptxas -v`` reported them in that build.
2. ``kernel:matmul`` / ``kernel:chain_n`` — every GEMM and chain geometry
   the serving path gives the kernels (``paper_atis_tt`` at full width,
   the prefill and decode token batches), in bf16 and f32, then every
   further geometry of the training path's FP/BP/WG plans (batch 8 x seq
   128 tokens), checked in both types and timed in bf16: the kernel
   against its plain PyTorch version on the same inputs, and the times
   of kernel, plain version and (for the GEMM) ``torch.matmul`` as a
   yardstick, beside the least time the card could take.  Each GEMM line
   carries the configuration ``gemm_config`` chose (tile, K splits, copy
   width, tensor cores or not); each chain line the kernel that ran
   (``chain_tc_kernel`` in bf16, ``chain_kernel`` in f32), the
   ``chain_config`` it ran with, and ``unfused_ms``: the same chain as one
   GEMM call per link, the route the plan compiler takes for a chain it
   does not fuse.
3. ``kernel:flash_attention_fwd`` — the attention kernels against their
   plain version (out and lse) in bf16 (the tensor-core kernel) and f32
   (the SIMT one; each record names its kernel), both stepping over the
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
7a. ``kernel:matmul`` / ``kernel:chain_n`` on the ``phase_paths=False``
   path (``pp_off_fwd``: the FP plans' GEMMs and chains at the train
   batch; ``pp_off_bwd``: the GEMMs their autograd backward runs, ``dx``
   and ``dw`` of each, the chains' link recompute), as phase 2; then
   ``kernel:autograd``: the GEMM and chain kernels' autograd Functions
   at those forward GEMMs and at every chain the FP plans fuse (none at
   the train batch; at the half batch and the serve batches), value and
   gradients against autograd of the plain version, f32 1e-5 and bf16
   2e-2 of the scale.
7b. ``train_phase_paths_off`` — phase 6 with ``phase_paths=False``
   (autodiff through the FP plans, the paper's ablation): every loss
   finite, the last 5 below the first, the GEMM kernel on every step in
   the forward and in the backward (``matmul_bwd``), the chain kernel
   exactly where the FP plans fuse a chain, step 0's loss and grad norm
   within 1e-2 / 5e-2 of phase 6's; ``phase_paths_twin_f32``: one f32
   step's loss and every gradient through ``phase_paths=False`` on
   ``cuda`` within 1e-4 of ``phase_paths=True`` on ``einsum``;
   ``phase_paths_compare``: both arms' step ms, device busy ms, device
   events and launches a step (``train_profile``), reported, not gated.
7c. ``checkpoint`` — 10 steps saving every 5 through the train entry
   point, then two runs resumed from step 5 alone: steps 5 and 10
   restore bit for bit, the resumed losses within three times the
   resumed runs' own spread of the uninterrupted run's (equal where the
   card repeats itself); the write time and bytes on disk.  ``memory`` —
   the probe measured around phase 6's first step beside the modeled
   stash, and a run with ``tnn_memory_budget`` one byte under the
   one-microbatch stash: >= 2 microbatches, training, a lower measured
   peak.
8. ``kernel:quantize`` / ``kernel:dequantize`` / ``kernel:requantize`` /
   ``kernel:matmul_scaled`` / ``kernel:chain_n_scaled`` — every geometry
   of the fp8 training step's FP/BP/WG plans (the fp8 policy reprices
   CSSE, so they differ from bf16's): the quantize kernel at every input
   node, the dequantize kernel at every plan output (both with the
   per-tensor scalar scale the training path passes, timed, and with
   per-row scales), the requantize kernel at every op-result size the
   plans requantize (laid out as the op leaves it, permute included;
   ``launches_per_call`` 1 or 2, ``torch_ops_ms`` the torch ops that ran
   before it), the scaled GEMM and chain at every op,
   each checked in fp8_e4m3, fp8_e5m2 and int8 against its plain version
   (quantize/dequantize/requantize bit for bit, also on
   ``ref.tie_probe``; the requantize's scale also bit for bit the one
   the torch ops derive, ``policy.compute_scale``) and
   timed in fp8_e4m3 beside the plain version, the bound at the fp8
   peak, and for the GEMM ``torch._scaled_mm`` where its shape rules
   admit the geometry (the reason where they do not) and its
   configuration, as in phase 2; for the chain its kernel, configuration
   and ``unfused_ms`` (one scaled GEMM per link, each intermediate
   requantized per tensor between them, as the plan compiler's quantized
   ops run an unfused chain).
9. ``train_fp8`` — the ``train`` phase with ``--tnn-precision fp8`` and
   loss scale 128: every loss finite, the mean of the last 5 below the
   first and within 0.05 of the bf16 phase's, the five kernels of the
   precision path launched, no quantized degrade, every amax history
   slot filled, and one requantize launch for every quantized plan op
   run (no op's result requantized in torch ops).
10. ``train_fp8_parity`` — ``cuda`` against ``einsum`` under fp8 (f32
   compute) for 3 steps: the amaxes recorded before anything quantized
   within 1e-6, a loss scale of 1 bit-identical to 128 but for row 1 of
   the histories (exactly 128 times smaller), and every step's loss,
   grad norm and amaxes within three times the envelope that weights
   scaled by ``1 ± 2**-22`` open on either backend (fp8 training is
   chaotic at roundoff from the first step: a flipped fp8 rounding
   spreads).

11. ``kernel:linear_scan`` — the scan kernel (B8) against its plain
   twin, output and final state, in bf16 and f32: at every scan shape of
   the ``rwkv6_7b`` training path (BH 512, T 128, chunk 128, dk = dv =
   64, ``rwkv6`` mode), at ``zamba2_7b``'s ``ssd`` shape (BH 512, T 128,
   dk 64, dv 112) with the reference test's log-decay, and chunk 64
   against chunk 128 (chunk boundaries invisible); timed in bf16 beside
   the plain twin and the bound.  Then the overflow check: zamba2's
   shape with the ``ssd`` log-decay one scalar per token, broadcast over
   dk (Mamba-2's form), at -0.7 a token, where the reference's
   factorization overflows f32: kernel and twin finite, the kernel within
   the f32 and bf16 gates of the twin and of the sequential oracle, and
   its time.  Then the GEMM and chain kernels at
   every geometry of ``rwkv6_7b``'s FP/BP/WG plans (``cm_k``/``cm_v``,
   TT rank 64), as in phase 2.
12. ``train_rwkv6`` — ``rwkv6_7b`` at full width (4 of its 32 layers:
   ``RWKV_TRAIN_LAYERS``; d 4096, vocab 65,536) through the
   train entry point,
   ``cuda`` backend, bf16, batch 8, seq 128, 12 steps at lr 1e-3 (see
   ``RWKV_LR``): every loss
   finite, the mean of the last 5 below the first, the GEMM kernel and
   the scan kernel launched on every step (the scan twice per layer:
   forward and the checkpoint re-run), no ``EinsumOp`` in the plans and
   no runtime degrade; its step time, tok/s and peak device memory,
   beside the activation probe (measured around the first step) and
   ``stash_report``'s modeled stash (so do phases 16 and 21).
13. ``rwkv6_state`` — full width, 2 layers, bf16: ``prefill`` over 127
   tokens (the scan kernel, whose final states become the decode
   state), then ``decode_step`` on token 128 (the plain recurrence),
   within 5% of the logit scale of the last row of ``forward`` over the
   128 tokens.
14. ``rwkv6_parity`` — ``rwkv6_7b`` at full width, 2 layers, f32, on
   the ``cuda`` and ``einsum`` backends for 3 steps from the same
   weights and batches (the GEMM kernel at every rank-64 FP/BP/WG
   geometry): every step's loss and grad norm within three times the
   envelope that weights scaled by ``1 ± 2**-22`` open on either
   backend, or within 1e-4 where that envelope is narrower.
15. ``kernel:zamba2`` — ``zamba2_7b`` with its one-card TNN config (TT
   rank 64 on the Mamba-2 ``in``/``out``, the shared attention's ``o``
   and the shared MLP): the GEMM (and chain, where a plan fuses one) at
   every geometry of its training FP/BP/WG plans and its serve FP plans
   at the decode batch, as in phase 2; the attention kernel at the
   shared block's training shape (B 8, T 128, H = KV = 32, D 112,
   causal, one kv chunk of 128), as in phase 3; the scan kernel at the
   Mamba-2 training shape (BH 512, T 128, dk 64, dv 112, chunk 128)
   with the log-decay one scalar per token broadcast over dk, at the
   init's ``-softplus(N(0, 1))``, against the twin and the sequential
   oracle, timed beside the twin and the bound.
16. ``train_zamba2`` — ``zamba2_7b`` at full width, 27 of its 81
   layers (``ZAMBA_TRAIN_LAYERS``: one shared-block period;
   d 3584, vocab 32,000; 374,829,056 parameters at full depth)
   through the train entry point with ``tnn_cfg`` the one-card config,
   ``cuda`` backend, bf16, remat, batch 8, seq 128, 12 steps at lr 3e-4
   (see ``ZAMBA_LR``): every loss finite, the mean of the last 5 below the
   first, on every step the GEMM kernel, the scan kernel twice a layer
   and the attention kernel once a shared-block application, no
   ``EinsumOp`` in the plans, no runtime degrade; its step time, tok/s
   and peak device memory.
17. ``zamba2_state`` — as ``rwkv6_state`` for ``zamba2_7b`` at full
   width, 2 layers with the shared block after both: ``prefill`` (the
   scan kernel twice, the attention kernel once) then ``decode_step``
   (neither) within 5% of the logit scale of ``forward``.
18. ``zamba2_parity`` — as ``rwkv6_parity`` for that 2-layer
   ``zamba2_7b`` (the GEMM at its rank-64 geometries against
   ``einsum``).
19. ``serve_zamba2`` — ``zamba2_7b`` at full width, 27 of its 81 layers
   since PR 25 (``ZAMBA_SERVE_LAYERS``: one shared-block period), through
   ``ServeEngine`` (the sequential ``decode_step`` fallback) at the
   serve CLI's defaults, as phase 4: every request completes, the first
   wave's greedy tokens equal a hand-rolled ``decode_step`` loop at the
   same batch, no runtime degrade; tok/s and tick times, and how many of
   request 0's tokens the ``prefill`` route gives too.

20. ``kernel:qwen2`` — ``qwen2_7b`` (the dense GQA family) with
   ``--tnn``'s default (TT rank 64 on the SwiGLU): the GEMM (and chain,
   where a plan fuses one) at every geometry of its training FP/BP/WG
   plans, of the engine's FP plans (prefill chunk and decode batches)
   and of ``LM.prefill``'s at the first wave's 4 x 16 prompt tokens, as
   in phase 2; the attention kernel at the training shape (B 8, T 128,
   H 28, KV 4, D 128, causal, one kv chunk of 128) and at
   ``LM.prefill``'s (B 4, T 16, chunks of 16), and at the other dense
   configs' training shapes (``tinyllama_1_1b``, ``internlm2_1_8b``,
   ``phi4_mini_3_8b``: rows off the main path), as in phase 3.
21. ``train_qwen2`` — ``qwen2_7b`` at full width, 4 of its 28 layers
   (``QWEN_TRAIN_LAYERS``; d 3584, vocab 152,064; at full
   depth 1,980,923,392 parameters) through
   the train entry point, ``cuda`` backend, bf16, remat, batch 8, seq
   128, 12 steps at the CLI's lr 3e-3: every loss finite, the mean of
   the last 5 below the first, on every step the GEMM kernel and the
   attention kernel twice a layer (forward and the checkpoint re-run),
   no ``EinsumOp`` in the plans, no runtime degrade; its step time,
   tok/s and peak device memory.
22. ``qwen2_parity`` — phase 7 for ``qwen2_7b`` at full width, 2 layers:
   ``cuda`` against ``einsum`` for 3 steps, f32 and bf16, to the ATIS
   gates; first, in f32, the serve requests through the engine (its
   native ``extend``), whose first wave's greedy tokens must equal
   ``LM.prefill`` over the wave's prompts (the attention kernel once a
   layer) followed by ``decode_step``.
23. ``serve_qwen2`` — ``qwen2_7b`` at full width, 4 of its 28 layers
   (``QWEN_SERVE_LAYERS``), through
   ``ServeEngine`` at the serve CLI's defaults with a bf16 and with an
   fp8 (e4m3) KV cache, on the same requests: every request completes
   in both, first tokens equal, the fp8 cache (one new token a request)
   within 0.08 of the bf16 cache's amax, its requantize under an
   unchanged amax bit-stable on the card; tok/s and tick times of both,
   and the first wave through ``LM.prefill`` (how many of request 0's
   tokens it shares with the engine, reported).

24. ``olmoe_kernels`` — ``olmoe_1b_7b`` (the MoE family, ``--tnn``'s
   default: each expert's FFN as TT rank 64 cores stacked over the 64
   experts): the batched GEMM (``kernel:matmul_batched``, all experts
   in one launch, bf16 and f32, split-K where ``gemm_config`` splits) at
   every geometry of the expert layers' training FP/BP/WG plans (an
   expert's batch: 8 groups x capacity 24) and serving FP plans (4 x
   8), each expert held to the tolerance at its own scale, timed in
   bf16 beside the plain version, ``torch.bmm`` and the bound; the
   batched chain (``kernel:chain_n_batched``) at the chains the expert
   plans fuse at TT rank 8 (none does at 64); the attention kernel at
   the training shape (B 8, T 128, H = KV = 16, D 128, causal).
25. ``train_olmoe`` — full width and depth (16 layers, d 2048, vocab
   50,304; 1,565,067,264 parameters), ``cuda`` backend, bf16, remat,
   batch 8, seq 128, 12 steps at lr 1e-3 (``OLMOE_LR``): every loss
   finite, the last 5 below the first, the router's ``lb_loss`` /
   ``z_loss`` finite and reported, the attention kernel twice a layer,
   and on every step the batched launches (GEMM, its reduce, chain)
   exactly what the compiled expert plans predict (no launch per
   expert, no 2-D GEMM); ``train_olmoe_rank8``: the same at TT rank 8
   and 2 layers, where the plans fuse chains (the batched chain on the
   path).
26. ``olmoe_parity`` — ``cuda`` against ``einsum`` at 2 layers, f32 and
   bf16, to the ATIS gates, after the share of the first batch's (token,
   k) top-k picks that both backends make (>= 99%; the share equal rank
   for rank is reported); first, in f32, the engine's
   greedy tokens (``extend``, padded columns routed too) equal
   ``LM.prefill`` followed by ``decode_step``.
27. ``serve_olmoe`` — full width, 8 of its 16 layers
   (``OLMOE_SERVE_LAYERS``), through ``ServeEngine`` at the serve
   CLI's defaults: every request completes, the batched GEMM
   launched, no 2-D GEMM, no runtime degrade; tok/s and tick times.
   Then ``olmoe_profile``: ``train_profile`` on that model (device busy
   and idle share of a training step, by kernel and by phase, the
   ``moe.*`` ranges among them).
27a. ``olmoe_fp8_kernels`` — the quantized experts' kernels at every
   geometry of ``olmoe_1b_7b``'s fp8 training plans (``--tnn``'s TT
   rank 64 under ``--tnn-precision fp8``: each (expert, group) instance
   runs the plans at one group's 24 slots, 8 groups x 64 experts = 512
   instances a launch, an expert's cores broadcast over its groups with
   stride 0), in fp8_e4m3, fp8_e5m2 and int8, against the plain
   versions (a loop of the unbatched forms): the batched scaled GEMM
   (``kernel:matmul_scaled_batched``) each instance within 1e-5 of its
   own scale, the batched scaled chain (``kernel:chain_n_scaled_batched``,
   at the rank-8 plans: none fuses at 64) each instance by
   ``ref.chain_readback_agreement`` (the chain rule's 0.5% counted at
   the link-0 intermediates the kernel rounds, which an instance's
   32-row output cannot resolve), no element beyond two bf16 ulps of
   its scale, and three instances launched alone through the unbatched
   kernel equal to the batched output bit for bit, the quantize and
   dequantize kernels in their per-row form (an instance a row of
   ``[I, -1]``) and the
   batched requantize (``kernel:requantize_batched``, one amax and scale
   an instance in one launch) bit for bit, scales included; timed in
   fp8_e4m3 beside the plain loop and the bound (bytes at 3.35 TB/s,
   operations at 1,979 TFLOP/s); no PyTorch call computes a batched
   scaled GEMM with per-instance scales, so no library time.
27b. ``train_olmoe_fp8`` — full width, 8 of its 16 layers
   (``OLMOE_FP8_LAYERS``), fp8 at loss scale 128, batch 8, seq 128, 12
   steps at ``OLMOE_FP8_LR`` (3e-4) through the train entry point: the
   ``train_olmoe`` gates (losses
   finite, the last 5 below the first, the attention kernel twice a
   layer), and on every step the batched quantized launches (scaled
   GEMM, its reduce, chain, requantize and its amax pass, quantize,
   dequantize) exactly what the compiled plans predict, one requantize
   launch for every quantized plan op run (none in torch ops), every
   history finite, the experts live at step 0 (every fed slot's output
   row and the core gradients non-zero; each step's share is reported:
   under the reference's summed histories they fall silent after a few
   steps); step ms, tok/s, peak memory; then
   ``train_olmoe_fp8_profile``, ``train_profile`` on the trained model
   (device busy and idle share of a step); ``train_olmoe_fp8_rank8``,
   the same at TT rank 8 and 2 layers, where the plans fuse chains.
27c. ``olmoe_fp8_parity`` — phase 10's rule at full width, 2 layers:
   ``cuda`` against its ``einsum`` twin under fp8 (f32 compute), every
   step's loss, grad norm and history slots (relative to each leaf's
   largest written slot: the sum over groups leaves differences of
   close amaxes in the older slots) within three times the envelope of
   ``1 ± 2**-22`` weight nudges; the cores' step-0 amaxes and layer 0's
   expert inputs within 1e-6; loss scale 1 bit-identical to 128 but for
   the dY rows.

28. ``kernel:seamless`` — ``seamless_m4t_medium`` (the encoder-decoder
   family, ``--tnn``'s default: TT rank 64 on both stacks' SwiGLU): the
   GEMM (and chain, where a plan fuses one) at every geometry of its
   training FP/BP/WG plans (both stacks at 8 x 128 tokens) and of its
   serving FP plans (the encoder at 4 x 1024 frames, the decoder's
   prefill at 4 x 16 and decode at 4), as in phase 2; the attention
   kernel, as in phase 3, at each of its main-path shapes (H = KV = 16,
   D 64): training's encoder (non-causal), decoder (causal) and
   cross-attention (non-causal), B 8, T 128; serving's encoder (B 4, T
   1024, non-causal, q chunk 512, kv chunk 1024), decoder prefill (B 4,
   T 16, causal), cross prefill (16 queries against 1,024 keys) and
   cross decode (1 query against 1,024 keys); and off the main path at
   ``llava_next_34b``'s training shape (B 8, T 128, H 56, KV 8, D 128,
   causal).
29. ``train_seamless`` — full width and depth (12 + 12 layers, d 1024,
   vocab 256,256; 704,624,640 parameters, asserted on the card) through
   ``steps.make_train_step``, ``cuda`` backend, bf16, remat, batch 8 of
   128 encoder frames (``modality.frame_embeddings``, a generator seeded
   per step) and 128 decoder tokens (the synthetic data, seed 0), 12
   steps at ``SEAMLESS_LR`` (``tools/seamless_lr_sweep.py``): every loss
   finite, the mean of the last 5 below the first, on every step the
   GEMM kernel and the attention kernel exactly 72 times (12 encoder, 12
   decoder and 12 cross-attentions, forward and the checkpoint re-run),
   no ``EinsumOp`` in the plans, no runtime degrade; its step time,
   decoder tok/s, peak device memory and step 0's measured activation
   peak.
30. ``serve_seamless`` — the trained model (its weights drawn once for
   the three phases) served through ``make_prefill_step`` /
   ``make_decode_step``: two waves of 4 requests, each 1,024 encoder
   frames and a 16-token prompt, then 16 greedy tokens: every request
   completes, the attention kernel launched per wave as the layers
   predict (12 encoder, 12 decoder-prefill, 12 cross-prefill, 15 x 12
   cross-decode), no runtime degrade; tok/s and the median decode step.
   Then ``seamless_profile``: ``train_profile`` on that model (device
   busy and idle share of a training step, by kernel and by phase).
31. ``seamless_parity`` — phase 7 for ``seamless_m4t_medium`` at full
   width, 2 + 2 layers: ``cuda`` against ``einsum`` for 3 steps, f32 and
   bf16, to the ATIS gates; first, in f32, the first serve wave through
   ``prefill`` and 15 ``decode_step`` calls, whose greedy tokens must
   equal teacher-forced ``forward``'s argmax over the same tokens, and
   whose last logits must lie within 1e-4 of ``forward``'s last row.

Every record carries ``elapsed_s`` (seconds since the script started);
``phase_seconds`` then sums the seconds each phase name took (the time
since the record before each of its records).  It then prints the
``{"kernels": [...]}`` line (every ported kernel with
its launches in the serve, train, train_fp8, train_rwkv6, train_zamba2,
serve_zamba2, train_qwen2, serve_qwen2 (bf16 and fp8 KV),
prefill_qwen2, train_phase_paths_off, train_olmoe, train_olmoe_rank8,
serve_olmoe, train_olmoe_fp8, train_olmoe_fp8_rank8, train_seamless and
serve_seamless runs, the batched GEMM and chain and the
instance-batched scaled GEMM, chain and requantize as rows of their own,
for the GEMM also its
backward launches under autodiff and its split-K reduce launches, the
``phase_paths=False`` path's timed sums apart, for the requantize its
partial-amax launches, and its timings at the main paths' shapes), the
card's ``nvidia-smi`` name and power limit, and,
last, ``{"ok": true, ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# The least time the card could take: device-memory rate and dense peaks
# of one H100 SXM at its 700 W limit (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "fp8": 1979e12}

# Serve-phase shape: the reference serve CLI's defaults, all greedy.
ARCH, BATCH, PROMPT, MAX_NEW, CHUNK, REQUESTS = ("paper_atis_tt", 4, 16, 16,
                                                 32, 8)
# Train-phase shape: the reference train CLI's defaults (batch, seq, lr).
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 128, 20, 3e-3
PARITY_STEPS = 3
# The precision path: its policy and static loss scale, and the dtypes
# its kernels are checked in (timed in the first).
FP8_POLICY, FP8_LOSS_SCALE = "fp8", 128.0
QUANT_DTYPES = ("fp8_e4m3", "fp8_e5m2", "int8")
FP8_LOSS_TOL = 0.05          # the reference's fp8 tolerance
FP8_PARITY_FACTOR = 3.0
# Attention shapes (B, T, H, KV, D, causal, kv_chunk): the training
# path's first; kv_chunk None is the model config's (the main path's).
FLASH_SHAPES = [(8, 128, 12, 12, 64, True, None),
                (2, 1024, 12, 12, 64, True, 256),
                (2, 1024, 12, 12, 64, False, None),
                (2, 256, 16, 4, 128, True, 64)]
# RWKV-6 training at full width and depth, the train CLI's shape.  Its
# learning rate is 1e-3, not the CLI's 3e-3 (set for the small models):
# rwkv6_7b's gradient norm at init is ~5e5 (bf16 and f32 alike, a
# property of the reference model: ROADMAP.md C), so clipping leaves
# most gradients under AdamW's eps, and warm-up to 3e-3 sends the loss
# back up after step 7 (PERF.md, Findings).
RWKV_ARCH, RWKV_STEPS, RWKV_LR = "rwkv6_7b", 12, 1e-3
# train_rwkv6's depth: see the depth cuts below.
RWKV_TRAIN_LAYERS = 4
# zamba2_7b's ssd scan: (BH = batch 8 x 64 heads, T, dk, dv, chunk).
SSD_SHAPE = (8 * 64, 128, 64, 112, 128)
# zamba2_7b training at full width and depth, the train CLI's shape, with
# the arch's one-card TNN config (its tnn_default leaves 6.59 B
# parameters, ~105 GB of training state: PERF.md §4).  Its learning rate
# is 3e-4, below the CLI's 3e-3 and rwkv6's 1e-3: at both of those the
# loss falls until the learning rates summed over the steps reach about
# 3e-3, then rises (the grad norm stays 2.5-38), so the last five end
# above the first.  Adam moves every TT core element by about lr a step,
# and a rank-64 core's elements are ~0.07 (PERF.md, Findings; ROADMAP.md
# C).  At 3e-4 the twelve warm-up steps sum to 1.95e-3.
ZAMBA_ARCH, ZAMBA_STEPS, ZAMBA_LR = "zamba2_7b", 12, 3e-4
# qwen2_7b (the dense GQA family: 28 heads over 4 kv heads of 128) at
# full width and depth under --tnn's default (TT rank 64, 2 factors, on
# the SwiGLU; q/k/v/o, the QKV bias and lm_head dense f32): 1,980,923,392
# parameters, ~31.7 GB of f32 weights, gradients and two moments.  The
# train CLI's shape, steps as rwkv6's and zamba2's, and zamba2's lr: at
# the CLI's 3e-3 the loss climbs from step 2 (grad norm 10.7 -> 125,
# loss 12.43 -> 18.60 at step 7) and at 1e-3 it ends at 13.16 (PERF.md,
# Findings).  Adam moves every weight by about lr a step, and a logit
# sums 3584 such moves of the lm_head's column: d_model sets the lr.
QWEN_ARCH, QWEN_STEPS, QWEN_LR = "qwen2_7b", 12, 3e-4
# serve_qwen2's quantized KV cache (the serve CLI's --serve-kv-dtype).
QWEN_KV_POLICY = "fp8"
# The other dense configs, whose attention shapes are checked and timed
# as rows off the main path (their full-width runs are not made here).
DENSE_OTHERS = ("tinyllama_1_1b", "internlm2_1_8b", "phi4_mini_3_8b")
# rwkv6_state / zamba2_state: layers kept (the hybrid's shared block
# after both), batch and tokens (prefill T - 1, decode 1); qwen2_parity's
# depth.
STATE_LAYERS, STATE_BATCH, STATE_T = 2, 2, 128
STATE_TOL_REL = 0.05
# olmoe_1b_7b (the MoE family: 64 experts top-8, d_ff_expert 1024) at
# full width and depth under --tnn's default (each expert's gate/up/down
# as TT rank 64 cores stacked over the experts; attention, the f32
# router, embedding and lm_head dense): 1,565,067,264 parameters.  The
# train CLI's shape and steps as the other models'; its lr is the first
# of 3e-3, 1e-3, 3e-4 whose run passes the loss-descent gate
# (tools/olmoe_lr_sweep.py): at 3e-3 the grad norm reaches 137-149 and
# the last five end at 12.36 over a first 11.44 (PERF.md, Findings).
OLMOE_ARCH, OLMOE_STEPS, OLMOE_LR = "olmoe_1b_7b", 12, 1e-3
# The TT rank at which the experts' plans fuse chains (none does at rank
# 64): the batched chain's check and its 2-layer training run.
OLMOE_CHAIN_RANK, OLMOE_CHAIN_STEPS = 8, 8
# olmoe_parity's routing agreement: share of (token, k) picks both make.
ROUTING_AGREEMENT = 0.99
# olmoe_profile's warm-up and profiled steps: fewer than train_profile's
# own (5, 3), whose event count at olmoe's ~20,000 device events a step
# made the phase take ~49 s of this script's 600.
OLMOE_PROFILE_STEPS = (2, 1)
# train_olmoe_fp8: olmoe_1b_7b under the precision path (FP8_POLICY, loss
# scale FP8_LOSS_SCALE) at full width, its quantized experts run per
# (expert, group) instance: 8 groups x 64 experts = 512 instances of 24
# slots, every plan op one batched launch; the train CLI's shape and
# steps as train_olmoe's, at OLMOE_FP8_LR: at 16 layers the loss-descent
# gate passes at 3e-4 and misses at OLMOE_LR (1e-3: last five 11.462 over
# a first 11.439, grad norm up to 79.7), tools/olmoe_lr_sweep.py
# --precision fp8 (PERF.md, Findings).
OLMOE_FP8_LAYERS, OLMOE_FP8_LR = 8, 3e-4
# Depth cuts, full width throughout, for this script's 600 s (PERF.md,
# Findings: on an H100 80GB HBM3 at 700 W a whole run at the deeper
# settings reached 624 s before its last 72 s of seamless phases):
# train_rwkv6 4 of 32 layers, train_zamba2 and serve_zamba2 27 of 81
# (one shared-block period), train_qwen2 and serve_qwen2 4 of 28,
# serve_olmoe 8 of 16 (olmoe_profile profiles that model) and
# train_olmoe_fp8 8 of 16 (at 16: 81.4 s and 49.7 s for its profile,
# where 8 take about half).  train_olmoe keeps full depth.
ZAMBA_SERVE_LAYERS, QWEN_TRAIN_LAYERS = 27, 4
QWEN_SERVE_LAYERS, ZAMBA_TRAIN_LAYERS, OLMOE_SERVE_LAYERS = 4, 27, 8
# seamless_m4t_medium (the encoder-decoder family: 12 + 12 layers, d 1024,
# 16 heads of 64, vocab 256,256) at full width and depth under --tnn's
# default (TT rank 64 on both stacks' SwiGLU; attention, embed and
# lm_head dense): 704,624,640 parameters, ~11.3 GB of training state.
# Trained through the step builders (its batches carry encoder frames,
# which the train loop's data does not make) on 8 x 128 frames and 8 x
# 128 decoder tokens, 12 steps; its lr is the first of 3e-3, 1e-3, 3e-4
# whose run passes the loss-descent gate (tools/seamless_lr_sweep.py): at
# 3e-3 the grad norm spikes to 23.7 and 32.1 and the last five end at
# 13.08 over a first 12.95 (PERF.md, Findings, PR 25).
SEAMLESS_ARCH, SEAMLESS_STEPS, SEAMLESS_LR = "seamless_m4t_medium", 12, 1e-3
SEAMLESS_PARAMS = 704_624_640
# serve_seamless: waves of BATCH requests, each ENC_FRAMES encoder frames
# (the reference's enc-dec decode stub length, steps.ENC_FRAMES_DECODE)
# and a PROMPT-token decoder prompt, then MAX_NEW greedy tokens.
SEAMLESS_WAVES, ENC_FRAMES = 2, 1024
# The attention shapes of seamless's main paths (path, B, Tq, Tk, causal,
# q_chunk, kv_chunk; H = KV = 16, D 64), and llava_next_34b's training
# shape, a row off the main path.
SEAMLESS_FLASH = [
    ("train_seamless", "encoder", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, False,
     TRAIN_SEQ, TRAIN_SEQ),
    ("train_seamless", "decoder", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, True,
     TRAIN_SEQ, TRAIN_SEQ),
    ("train_seamless", "cross", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, False,
     TRAIN_SEQ, TRAIN_SEQ),
    ("serve_seamless", "encoder", BATCH, ENC_FRAMES, ENC_FRAMES, False, 512,
     1024),
    ("serve_seamless", "decoder prefill", BATCH, PROMPT, PROMPT, True,
     PROMPT, PROMPT),
    ("serve_seamless", "cross prefill", BATCH, PROMPT, ENC_FRAMES, False,
     PROMPT, 1024),
    ("serve_seamless", "cross decode", BATCH, 1, ENC_FRAMES, False, 1, 1024),
]
LLAVA_ARCH = "llava_next_34b"

DEVICE = "cuda"

REPLACES = {
    "matmul": "src/repro/kernels/fused_contraction.py:186",
    "chain_n": "src/repro/kernels/fused_contraction.py:317",
    "flash_attention_fwd": "src/repro/kernels/flash_attention.py:77",
    "matmul_scaled": "src/repro/kernels/fused_contraction.py:160",
    "chain_n_scaled": "src/repro/kernels/fused_contraction.py:287",
    "quantize": "src/repro/kernels/quantized.py:47",
    "dequantize": "src/repro/kernels/quantized.py:78",
    # B5's per-tensor form, the scale found on the card (the reference
    # requantizes in jnp: src/repro/core/plan_compiler.py:886)
    "requantize": "src/repro/kernels/quantized.py:47",
    "linear_scan": "src/repro/kernels/ssm_scan.py:86",
    # the reference vmaps these over a MoE's experts
    # (src/repro/models/blocks.py:696): a batched pallas_call
    "matmul_batched": "src/repro/kernels/fused_contraction.py:186",
    "chain_n_batched": "src/repro/kernels/fused_contraction.py:317",
    # ... and its quantized layer over the groups and the experts: the
    # scaled kernels and the requantize batched over (expert, group)
    "matmul_scaled_batched": "src/repro/kernels/fused_contraction.py:160",
    "chain_n_scaled_batched": "src/repro/kernels/fused_contraction.py:287",
    "requantize_batched": "src/repro/kernels/quantized.py:47",
}
SOURCES = {
    "matmul": "src/repro_torch/kernels/csrc/fused_contraction.cu",
    "chain_n": "src/repro_torch/kernels/csrc/fused_contraction.cu",
    "flash_attention_fwd": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "matmul_scaled": "src/repro_torch/kernels/csrc/fused_contraction.cu",
    "chain_n_scaled": "src/repro_torch/kernels/csrc/fused_contraction.cu",
    "quantize": "src/repro_torch/kernels/csrc/quantized.cu",
    "dequantize": "src/repro_torch/kernels/csrc/quantized.cu",
    "requantize": "src/repro_torch/kernels/csrc/quantized.cu",
    "linear_scan": "src/repro_torch/kernels/csrc/ssm_scan.cu",
    "matmul_batched": "src/repro_torch/kernels/csrc/fused_contraction.cu",
    "chain_n_batched": "src/repro_torch/kernels/csrc/fused_contraction.cu",
    "matmul_scaled_batched":
        "src/repro_torch/kernels/csrc/fused_contraction.cu",
    "chain_n_scaled_batched":
        "src/repro_torch/kernels/csrc/fused_contraction.cu",
    "requantize_batched": "src/repro_torch/kernels/csrc/quantized.cu",
}
KERNELS = ("matmul", "chain_n", "flash_attention_fwd")
QUANT_KERNELS = ("matmul_scaled", "chain_n_scaled", "quantize", "dequantize",
                 "requantize")
BATCHED_KERNELS = ("matmul_batched", "chain_n_batched",
                   "matmul_scaled_batched", "chain_n_scaled_batched",
                   "requantize_batched")
ALL_KERNELS = KERNELS + QUANT_KERNELS + ("linear_scan",) + BATCHED_KERNELS
#: the main-path runs whose launches the kernel line counts (and whose
#: timed shapes it sums)
RUNS = ("serve", "train", "train_fp8", "train_rwkv6", "train_zamba2",
        "serve_zamba2", "train_qwen2", "serve_qwen2", "serve_qwen2_fp8",
        "prefill_qwen2", "train_phase_paths_off", "train_olmoe",
        "train_olmoe_rank8", "serve_olmoe", "train_olmoe_fp8",
        "train_olmoe_fp8_rank8", "train_seamless", "serve_seamless")
#: the phase_paths=False path's timed shapes: its FP plans' GEMMs and
#: chains, and the GEMMs their autograd backward runs (reported apart;
#: the FP shapes are timed in the ``train`` path's sums too)
PP_OFF_PATHS = ("pp_off_fwd", "pp_off_bwd")


#: the script's start, the last record's time, and the seconds between
#: records summed by phase name (each record closes the time since the
#: one before it)
_CLOCK = {"start": time.perf_counter(), "last": None}
PHASE_SECONDS: dict[str, float] = {}


def emit(phase: str, **fields) -> None:
    now = time.perf_counter()
    PHASE_SECONDS[phase] = (PHASE_SECONDS.get(phase, 0.0) + now
                            - (_CLOCK["last"] or _CLOCK["start"]))
    _CLOCK["last"] = now
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": now - _CLOCK["start"]}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, inner: int = 20, reps: int = 25,
              warmups: int = 3) -> float:
    """Median device time of one ``fn()`` call: ``inner`` calls captured
    in a CUDA graph (no host launch cost between them), replayed ``reps``
    times between CUDA events after one call and ``warmups`` more on a
    side stream."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmups):
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


def ptxas_report(log: str, demangler: str | None = None) -> list[dict]:
    """Registers, stack and spills of every kernel in ``nvcc -Xptxas -v``
    output, the names demangled by ``demangler`` (``cu++filt``) if given."""
    rows = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            rows.append({"kernel": m.group(1)})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and rows:
            rows[-1].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1]["registers"] = int(m.group(1))
    if demangler:
        for r in rows:
            r["kernel"] = subprocess.run(
                [demangler, r["kernel"]], capture_output=True, text=True,
                check=True, timeout=60).stdout.strip()
    return rows


def bound_ms(nbytes: int, flops: int, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def gemm_config_rec(fc, x, w, trans: bool) -> dict:
    """The configuration ``matmul_cuda`` launches these operands with."""
    c = fc.gemm_config_for(x, w, trans)
    return {"tile": [c.bm, c.bn], "splits": c.splits,
            "copy_bytes": c.copy_bytes, "tensor_cores": c.tensor_cores}


def chain_config_rec(fc, x, ws) -> dict:
    """The kernel ``chain_n_cuda`` launches on these operands and its
    configuration."""
    c = fc.chain_config_for(x, ws)
    return {"kernel": ("chain_tc_kernel" if c.kernel == "tensor_cores"
                       else "chain_kernel"),
            "config": {"band": c.band, "warps": c.warps, "warp_k": c.warp_k,
                       "stage_k": c.stage_k, "stages": c.stages,
                       "copy_bytes": c.copy_bytes,
                       "smem_bytes": c.smem_bytes}}


def unfused_chain(fc, x, ws):
    """The chain as one GEMM kernel per link (``plan_compiler.run``'s
    route for a chain it does not fuse): the intermediate rounded to X's
    type in device memory, the regroup a reshape (batched operands: one
    batched GEMM a link)."""
    h = x
    for w in ws:
        h = fc.matmul_cuda(h.reshape(*x.shape[:-2], -1, w.shape[-2]), w)
    return h


def unfused_scaled_chain(fc, quant, pol, qx, qws):
    """The scaled chain as plan_compiler's quantized ops run it unfused:
    one scaled GEMM per link, each f32 result requantized per tensor to
    the policy's type (plain torch ops) before the next link."""
    inter = dataclasses.replace(pol, granularity="tensor")
    t = qx
    for i, qw in enumerate(qws):
        k, n = qw.q.shape
        x2 = t.q.reshape(-1, k)
        res = fc.matmul_cuda(
            x2, qw.q, scales=(quant.expand_row_scales(t.scale, x2.shape[0]),
                              quant.expand_row_scales(qw.scale, n)
                              .reshape(1, n)))
        if i < len(qws) - 1:
            t = quant.quantize(res, inter)
    return res


def bf16_ulp(scale: float) -> float:
    """One bf16 ulp at magnitude ``scale`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)


def main_path_geometries(cfg, plan_compiler, profiles, tensorized,
                         token_batches=(BATCH * CHUNK, BATCH)):
    """Every distinct GEMM ``(m, n, k, transpose_rhs)`` and chain
    ``(m0, link_shapes)`` the serve path launches: the compiled FP plans
    of each tensorized projection at the prefill and decode batches (a
    model served through ``decode_step`` alone runs the decode batch
    only)."""
    gemms, chains = set(), set()
    for tokens in token_batches:
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


def fp8_train_geometries(cfg, plan_compiler, profiles, tensorized,
                         QuantPolicy):
    """Every geometry of the fp8 training step's FP/BP/WG plans, each
    ``{geometry: phases}``: scaled GEMMs ``(m, n, k, transpose_rhs)``,
    scaled chains ``(m0, link_shapes)``, quantized input nodes and
    dequantized plan outputs as ``(rows, cols)`` (the ``[rows, -1]`` view
    the kernels see), and the op results the plans requantize per tensor
    by element count, each ``{"phases", "ops": plan ops of that size,
    "shape": the result as its kernel writes it, "perm": the permute
    applied to it or None}``; and the count of ``EinsumOp`` steps."""
    tnn = dataclasses.replace(cfg.tnn,
                              precision=QuantPolicy.parse(FP8_POLICY))
    geo = {"gemm": {}, "chain": {}, "quantize": {}, "dequantize": {},
           "requantize": {}}
    einsum_ops = 0
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def rows_cols(shape):
        return (shape[0], math.prod(shape[1:]))

    for _, d_in, d_out in profiles.tensorized_projections(cfg):
        layer = tensorized.make_tensorized_linear(
            d_out, d_in, tnn, compute_dtype=cfg.compute_dtype,
            device="meta")
        for phase, results in tensorized.phase_plans(
                layer.fact, tokens, layer.opts).items():
            for r in results:
                net = r.plan.network
                for i in range(net.num_nodes):
                    geo["quantize"].setdefault(
                        rows_cols(net.node_shape(i)), set()).add(phase)
                out = tuple(net.sizes[a] for a in net.output)
                geo["dequantize"].setdefault(rows_cols(out),
                                             set()).add(phase)
                compiled = plan_compiler.compile_cached(
                    r.plan, fuse=layer.opts.fused_chain,
                    max_chain_len=layer.opts.max_chain_len,
                    policy=layer.precision)
                for op in compiled.ops:
                    if isinstance(op, plan_compiler.GemmOp):
                        m = op.mat
                        geo["gemm"].setdefault(
                            (m.m, m.n, m.k, m.transpose_rhs),
                            set()).add(phase)
                        axes, perm = m.m_axes + m.n_axes, m.out_perm
                    elif isinstance(op, plan_compiler.ChainOp):
                        geo["chain"].setdefault((op.m0, op.link_shapes),
                                                set()).add(phase)
                        axes, perm = op.m_axes + op.n_axes, op.out_perm
                    else:
                        einsum_ops += 1
                        axes, perm = op.step.out_axes, None
                    shape = tuple(net.sizes[a] for a in axes)
                    rq = geo["requantize"].setdefault(math.prod(shape), {
                        "phases": set(), "ops": 0, "shape": shape,
                        "perm": perm})
                    rq["phases"].add(phase)
                    rq["ops"] += 1
    return geo, einsum_ops


def scaled_mm_ms(torch, qx, qw, trans: bool, sl, sr):
    """``torch._scaled_mm`` on the same fp8 inputs with per-tensor scales
    (the training path's scales are per tensor): ``(ms, None)``, or
    ``(None, reason)`` where its shape rules refuse the geometry."""
    m, k = qx.shape
    n = qw.shape[0] if trans else qw.shape[1]
    if k % 16 or n % 16:
        return None, f"_scaled_mm needs K and N divisible by 16 (K {k}, N {n})"
    if qx.dtype != torch.float8_e4m3fn:
        return None, f"not timed in {qx.dtype}"
    b = qw.t() if trans else qw.t().contiguous().t()   # column-major [K, N]
    sa, sb = sl[0, 0].reshape(()), sr[0, 0].reshape(())
    try:
        torch._scaled_mm(qx, b, sa, sb, out_dtype=torch.float32)
    except RuntimeError as err:       # the library's refusal, recorded
        return None, f"_scaled_mm refused: {str(err).splitlines()[0]}"
    return device_ms(torch, lambda: torch._scaled_mm(
        qx, b, sa, sb, out_dtype=torch.float32)), None


def quant_kernel_phase(torch, fc, qk, ref, quant, QuantPolicy, geo, totals
                       ) -> None:
    """Hold the precision path's kernels against their plain versions at
    every fp8 training geometry, in every quantized dtype; time each in
    fp8_e4m3 (``totals[kernel]["train_fp8"]``)."""
    gen = torch.Generator(device=DEVICE).manual_seed(2)

    def rand(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=DEVICE) * scale

    def bits(t):
        return t.contiguous().reshape(-1).view(torch.uint8)

    def account(name, err, timed):
        t = totals[name]
        t["max_abs_err"] = max(t["max_abs_err"], err)
        if timed is not None:
            add_total(t.setdefault("train_fp8", new_totals()), *timed)

    def fail(name, rec):
        emit(f"kernel:{name}", ok=False, **rec)
        raise AssertionError(f"{name} kernel disagrees: {rec}")

    for dname in QUANT_DTYPES:
        pol = QuantPolicy.parse(dname)
        timing = dname == QUANT_DTYPES[0]
        # The tie probe: every rounding a close call.
        x, sc = ref.tie_probe(pol, device=DEVICE)
        for xin in (x, x.bfloat16()):
            q = qk.quantize_cuda(xin, sc, pol)
            ok = torch.equal(bits(q), bits(ref.quantize(xin, sc, pol)))
            for out in (torch.float32, torch.bfloat16):
                ok = ok and torch.equal(
                    bits(qk.dequantize_cuda(q, sc, out)),
                    bits(ref.dequantize(q, sc, out)))
            rec = {"check": "tie_probe", "dtype": dname,
                   "in_dtype": str(xin.dtype).split(".")[-1],
                   "shape": list(xin.shape), "bit_exact": ok}
            if not ok:
                fail("quantize", rec)
            emit("kernel:quantize", ok=True, **rec)
        for (rows, cols), phases in sorted(geo["quantize"].items()):
            # The training path's scale is per tensor (one device scalar);
            # tile scales reach the kernel expanded per row.  Both forms
            # are held bit for bit; the main path's is timed.
            xin = rand((rows, cols), 3.0).bfloat16()     # the compute dtype
            st = quant.quantize(xin, pol).scale
            s_ = quant.expand_row_scales(st, rows) * torch.linspace(
                0.5, 2.0, rows, device=DEVICE)[:, None]
            q = qk.quantize_cuda(xin, st, pol)
            rec = {"path": "train_fp8", "rows": rows, "cols": cols,
                   "phases": sorted(phases), "dtype": dname,
                   "bit_exact": torch.equal(bits(q), bits(
                       ref.quantize(xin, st, pol))),
                   "bit_exact_per_row": torch.equal(bits(
                       qk.quantize_cuda(xin, s_, pol)), bits(
                           ref.quantize(xin, s_, pol)))}
            if not (rec["bit_exact"] and rec["bit_exact_per_row"]):
                fail("quantize", rec)
            timed = None
            if timing:
                ms = device_ms(torch, lambda: qk.quantize_cuda(xin, st, pol))
                plain = device_ms(torch, lambda: ref.quantize(xin, st, pol))
                b, by = bound_ms(rows * cols * 3 + 4, 3 * rows * cols,
                                 "float32")
                timed = (ms, plain, None, b, by)
                rec.update(ms=ms, plain_ms=plain, library_ms=None,
                           bound_ms=b, bound_by=by, per_row_ms=device_ms(
                               torch, lambda: qk.quantize_cuda(xin, s_, pol)))
            emit("kernel:quantize", ok=True, **rec)
            account("quantize", 0.0, timed)
        for (rows, cols), phases in sorted(geo["dequantize"].items()):
            t = quant.quantize(rand((rows, cols), 3.0), pol)
            st = t.scale
            s_ = t.row_scales() * torch.linspace(0.5, 2.0, rows,
                                                 device=DEVICE)[:, None]
            got = qk.dequantize_cuda(t.q, st)
            rec = {"path": "train_fp8", "rows": rows, "cols": cols,
                   "phases": sorted(phases), "dtype": dname,
                   "bit_exact": torch.equal(bits(got), bits(
                       ref.dequantize(t.q, st))),
                   "bit_exact_per_row": all(torch.equal(bits(
                       qk.dequantize_cuda(t.q, s_, out)), bits(
                           ref.dequantize(t.q, s_, out)))
                       for out in (torch.float32, torch.bfloat16))}
            if not (rec["bit_exact"] and rec["bit_exact_per_row"]):
                fail("dequantize", rec)
            timed = None
            if timing:
                ms = device_ms(torch, lambda: qk.dequantize_cuda(t.q, st))
                plain = device_ms(torch, lambda: ref.dequantize(t.q, st))
                b, by = bound_ms(rows * cols * 5 + 4, rows * cols,
                                 "float32")
                timed = (ms, plain, None, b, by)
                rec.update(ms=ms, plain_ms=plain, library_ms=None,
                           bound_ms=b, bound_by=by, per_row_ms=device_ms(
                               torch, lambda: qk.dequantize_cuda(t.q, s_)))
            emit("kernel:dequantize", ok=True, **rec)
            account("dequantize", 0.0, timed)
        for n, g in sorted(geo["requantize"].items()):
            # An op's f32 result as its kernel writes it, then permuted
            # as the plan compiler permutes it (a strided view).
            x = rand(g["shape"], 3.0)
            if g["perm"] is not None:
                x = x.permute(g["perm"])
            gq, gs = qk.requantize_cuda(x, pol)
            wq, ws = ref.requantize(x, pol)
            inter = dataclasses.replace(pol, granularity="tensor")
            rec = {"path": "train_fp8", "numel": n, "shape": list(x.shape),
                   "permuted": g["perm"] is not None,
                   "phases": sorted(g["phases"]), "ops_in_plans": g["ops"],
                   "dtype": dname,
                   "launches_per_call": qk.requantize_launches(n),
                   "bit_exact": (torch.equal(bits(gq), bits(wq))
                                 and torch.equal(bits(gs), bits(ws))),
                   "strides_match": gq.stride() == wq.stride(),
                   # the torch ops' scale (policy.compute_scale, which
                   # divides by qmax as a device f32 tensor: the
                   # reference's true divide) against the kernel's
                   "torch_ops_scale_bit_equal": torch.equal(
                       bits(gs), bits(quant.quantize(x, inter).scale))}
            if not (rec["bit_exact"] and rec["strides_match"]
                    and rec["torch_ops_scale_bit_equal"]):
                fail("requantize", rec)
            timed = None
            if timing:
                ms = device_ms(torch, lambda: qk.requantize_cuda(x, pol))
                plain = device_ms(torch, lambda: ref.requantize(x, pol))
                # the torch ops the kernel replaces on the card
                rec["torch_ops_ms"] = device_ms(
                    torch, lambda: quant.quantize(x, inter))
                b, by = bound_ms(5 * n + 4, 4 * n, "float32")
                timed = (ms, plain, None, b, by)
                rec.update(ms=ms, plain_ms=plain, library_ms=None,
                           bound_ms=b, bound_by=by)
            emit("kernel:requantize", ok=True, **rec)
            account("requantize", 0.0, timed)
        for (m, n, k, trans), phases in sorted(geo["gemm"].items()):
            qx = quant.quantize(rand((m, k)), pol)
            qw = quant.quantize(rand((n, k) if trans else (k, n)), pol)
            sl = qx.row_scales()
            sr = qw.row_scales()[:1].expand(1, n).contiguous()
            got = fc.matmul_cuda(qx.q, qw.q, transpose_rhs=trans,
                                 scales=(sl, sr))
            want = ref.matmul_scaled(qx.q, qw.q, sl, sr, transpose_rhs=trans)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            # exact f32 products summed in another order
            rec = {"path": "train_fp8", "m": m, "n": n, "k": k,
                   "transpose_rhs": trans, "phases": sorted(phases),
                   "dtype": dname, "max_abs_err": err,
                   "max_rel_err": err / max(scale, 1e-30), "scale": scale,
                   "tol": 1e-5 * scale,
                   "config": gemm_config_rec(fc, qx.q, qw.q, trans)}
            if not err <= 1e-5 * scale:
                fail("matmul_scaled", rec)
            timed = None
            if timing:
                ms = device_ms(torch, lambda: fc.matmul_cuda(
                    qx.q, qw.q, transpose_rhs=trans, scales=(sl, sr)))
                plain = device_ms(torch, lambda: ref.matmul_scaled(
                    qx.q, qw.q, sl, sr, transpose_rhs=trans))
                lib, why = scaled_mm_ms(torch, qx.q, qw.q, trans, sl, sr)
                b, by = bound_ms(m * k + k * n + 4 * (m + n) + 4 * m * n,
                                 2 * m * n * k, "fp8")
                timed = (ms, plain, lib, b, by)
                rec.update(ms=ms, plain_ms=plain, library_ms=lib,
                           library_note=why, bound_ms=b, bound_by=by)
            emit("kernel:matmul_scaled", ok=True, **rec)
            account("matmul_scaled", err, timed)
        for (m0, shapes), phases in sorted(geo["chain"].items()):
            qx = quant.quantize(rand((m0, shapes[0][0])), pol)
            qws = [quant.quantize(rand(s_), pol) for s_ in shapes]
            scales = (qx.row_scales() * qws[0].scale,
                      *[w.scale.reshape(1, 1) for w in qws[1:-1]],
                      qws[-1].row_scales()[:1].expand(
                          1, shapes[-1][1]).contiguous())
            ws = [w.q for w in qws]
            got = fc.chain_n_cuda(qx.q, ws, scales=scales)
            want = ref.chain_n_scaled(qx.q, ws, scales)
            torch.cuda.synchronize()
            # bf16 intermediates: a sum in another order now and then
            # moves one rounding by an ulp; a chain that skips or changes
            # that rounding moves nearly every element (ref's docstring).
            good, nums = ref.chain_scaled_agreement(got, want)
            err = nums["max_abs_err"]
            rows, _ = fc.chain_plan(m0, shapes)
            rec = {"path": "train_fp8", "m0": m0,
                   "links": [list(s_) for s_ in shapes],
                   "phases": sorted(phases), "dtype": dname,
                   **chain_config_rec(fc, qx.q, ws),
                   "max_rel_err": err / max(nums["scale"], 1e-30), **nums}
            if not good:
                fail("chain_n_scaled", rec)
            timed = None
            if timing:
                ms = device_ms(torch, lambda: fc.chain_n_cuda(
                    qx.q, ws, scales=scales))
                plain = device_ms(torch, lambda: ref.chain_n_scaled(
                    qx.q, ws, scales))
                rec["unfused_ms"] = device_ms(torch, lambda: (
                    unfused_scaled_chain(fc, quant, pol, qx, qws)))
                nbytes = (m0 * shapes[0][0] + sum(a * c for a, c in shapes)
                          + 4 * (m0 + len(shapes) + shapes[-1][1])
                          + 4 * rows[-1] * shapes[-1][1])
                flops = sum(2 * r * a * c for r, (a, c) in zip(rows, shapes))
                b, by = bound_ms(nbytes, flops, "fp8")
                timed = (ms, plain, None, b, by, rec["unfused_ms"])
                rec.update(ms=ms, plain_ms=plain, library_ms=None,
                           bound_ms=b, bound_by=by)
            emit("kernel:chain_n_scaled", ok=True, **rec)
            account("chain_n_scaled", err, timed)


def new_totals() -> dict:
    return {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None,
            "library_shapes": 0, "ms_on_library_shapes": 0.0,
            "unfused_ms": None, "max_abs_err": 0.0, "bound_by": set(),
            "shapes": 0}


def add_total(t: dict, ms, plain, lib, b, by, unfused=None) -> None:
    """Add one timed shape; the library sum covers the shapes where a
    library call computes the same function (``lib`` not None), the
    unfused sum the chains' per-link route."""
    t["ms"] += ms
    if unfused is not None:
        t["unfused_ms"] = (t["unfused_ms"] or 0.0) + unfused
    t["plain_ms"] += plain
    if lib is not None:
        t["library_ms"] = (t["library_ms"] or 0.0) + lib
        t["library_shapes"] += 1
        t["ms_on_library_shapes"] += ms
    t["bound_ms"] += b
    t["bound_by"].add(by)
    t["shapes"] += 1


def kernel_phase(torch, fc, ref, gemms, chains, totals, *, path: str,
                 phases=None, time_dtypes=("bfloat16", "float32"),
                 batch=None) -> None:
    """Hold each kernel against its plain version at every geometry
    (bf16 and f32); time both (in ``time_dtypes``), and torch.matmul for
    the GEMM.  bf16 times add to ``totals[kernel][path]`` and, for WG
    geometries, to ``totals[kernel]["wg"]``.  With ``batch`` (the
    experts) every operand gets that leading axis: the batched kernels
    (``matmul_batched``, ``chain_n_batched``), each expert held to the
    tolerance at its own scale, ``torch.bmm`` the GEMM's library call."""
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    phases = phases or {}
    lead = () if batch is None else (batch,)
    sfx = "" if batch is None else "_batched"
    nb = batch or 1

    def rand(shape, dtype):
        return torch.randn(lead + tuple(shape), generator=gen,
                           device=DEVICE).to(dtype)

    def errs(got, want):
        """Max abs error and scale: the worst expert's, each expert
        against its own scale."""
        g, w = got.float().reshape(nb, -1), want.float().reshape(nb, -1)
        err = (g - w).abs().amax(dim=1)
        scale = w.abs().amax(dim=1)
        worst = int(torch.argmax(err / scale.clamp_min(1e-30)))
        return err[worst].item(), scale[worst].item()

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
            err, scale = errs(got, want)
            tol = (1e-5 * scale if dtype == torch.float32
                   else bf16_ulp(scale))
            geo = (m, n, k, trans)
            rec = {"path": path, "m": m, "n": n, "k": k,
                   "transpose_rhs": trans, "phases": sorted(phases.get(
                       geo, ())), "dtype": dname, "max_abs_err": err,
                   "max_rel_err": err / max(scale, 1e-30), "scale": scale,
                   "tol": tol, "config": gemm_config_rec(fc, x, w, trans),
                   **({} if batch is None else {"batch": batch})}
            if not err <= tol:
                emit("kernel:matmul" + sfx, ok=False, **rec)
                raise AssertionError(f"matmul kernel disagrees: {rec}")
            timed = None
            if timing:
                ms = device_ms(torch, lambda: fc.matmul_cuda(
                    x, w, transpose_rhs=trans))
                plain = device_ms(torch, lambda: ref.matmul(
                    x, w, transpose_rhs=trans))
                wt = w.transpose(-1, -2) if trans else w
                lib = device_ms(torch, (lambda: torch.matmul(x, wt))
                                if batch is None
                                else (lambda: torch.bmm(x, wt)))
                b, by = bound_ms(nb * (m * k + k * n + m * n) * size,
                                 2 * nb * m * n * k, dname)
                timed = (ms, plain, lib, b, by)
                rec.update(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=b, bound_by=by)
            emit("kernel:matmul" + sfx, ok=True, **rec)
            account("matmul" + sfx, geo, dname, err, timed)
        for m0, shapes in chains:
            x = rand((m0, shapes[0][0]), dtype)
            ws = [rand(s, dtype) for s in shapes]
            got = fc.chain_n_cuda(x, ws)
            want = ref.chain_n(x, ws)
            torch.cuda.synchronize()
            err, scale = errs(got, want)
            # f32: sums in another order.  bf16: the same, and a rounding
            # of an intermediate to bf16 can land one ulp apart, which the
            # next link carries into the output: two ulps of its scale.
            tol = (1e-5 * scale if dtype == torch.float32
                   else 2 * bf16_ulp(scale))
            rows, _ = fc.chain_plan(m0, shapes)
            geo = (m0, shapes)
            rec = {"path": path, "m0": m0, "links": [list(s) for s in shapes],
                   "phases": sorted(phases.get(geo, ())), "dtype": dname,
                   **chain_config_rec(fc, x, ws),
                   "max_abs_err": err, "max_rel_err": err / max(scale, 1e-30),
                   "scale": scale, "tol": tol,
                   **({} if batch is None else {"batch": batch})}
            if not err <= tol:
                emit("kernel:chain_n" + sfx, ok=False, **rec)
                raise AssertionError(f"chain kernel disagrees: {rec}")
            timed = None
            if timing:
                ms = device_ms(torch, lambda: fc.chain_n_cuda(x, ws))
                plain = device_ms(torch, lambda: ref.chain_n(x, ws))
                rec["unfused_ms"] = device_ms(torch, lambda: unfused_chain(
                    fc, x, ws))
                nbytes = nb * (m0 * shapes[0][0]
                               + sum(a * c for a, c in shapes)
                               + rows[-1] * shapes[-1][1]) * size
                flops = nb * sum(2 * r * a * c
                                 for r, (a, c) in zip(rows, shapes))
                b, by = bound_ms(nbytes, flops, dname)
                timed = (ms, plain, None, b, by, rec["unfused_ms"])
                rec.update(ms=ms, plain_ms=plain, library_ms=None,
                           bound_ms=b, bound_by=by)
            emit("kernel:chain_n" + sfx, ok=True, **rec)
            account("chain_n" + sfx, geo, dname, err, timed)


def flash_case(torch, fa, ref, gen, shape, chunks, totals, *, path=None,
               tk=None, role=None) -> None:
    """The attention kernel against its plain version (out and lse) at
    ``shape = (B, T, H, KV, D, causal)`` and ``chunks`` in bf16 and f32,
    timed beside the plain version, scaled_dot_product_attention and the
    bound; ``tk`` keys from another sequence (``T`` queries against
    ``tk`` keys: a cross-attention), ``role`` a label for the record; with
    ``path`` the bf16 time adds to ``totals["flash_attention_fwd"][path]``."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, T, H, KV, D, causal = shape
    tk = tk or T
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        q, k, v = (torch.randn(s, generator=gen, device=DEVICE).to(dtype)
                   for s in ((B, T, H, D), (B, tk, KV, D), (B, tk, KV, D)))
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal, **chunks)

        def plain():
            return ref.flash_attention_fwd(q, k, v, causal=causal, **chunks)

        want, want_lse = plain()
        torch.cuda.synchronize()
        scale = want.float().abs().max().item()
        err = (out.float() - want.float()).abs().max().item()
        lse_scale = want_lse.abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        # f32: sums in another order.  bf16: out is rounded to bf16 once,
        # and p's rounding can land one ulp apart where the two sum the
        # score in another order: one ulp of the scale.
        tol = 1e-5 * scale if dtype == torch.float32 else bf16_ulp(scale)
        ok = err <= tol and lse_err <= 1e-5 * lse_scale
        rec = {"path": path, "role": role, "B": B, "T": T, "Tk": tk,
               "H": H, "KV": KV, "D": D, "causal": causal, **chunks,
               "dtype": dname,
               "kernel": fa.kernel_for(q, k, v), "max_abs_err": err,
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
        flops = 4 * B * H * T * tk * D // (2 if causal else 1)
        b, by = bound_ms(nbytes, flops, dname)
        emit("kernel:flash_attention_fwd", ok=True, ms=ms, plain_ms=plain_ms,
             library_ms=lib, bound_ms=b, bound_by=by, **rec)
        t = totals["flash_attention_fwd"]
        t["max_abs_err"] = max(t["max_abs_err"], err)
        if path and dtype == torch.bfloat16:
            add_total(t.setdefault(path, new_totals()), ms, plain_ms, lib,
                      b, by)


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
    for i, (B, T, H, KV, D, causal, kv_chunk) in enumerate(FLASH_SHAPES):
        chunks = dict(q_chunk=min(cfg.q_chunk, T),
                      kv_chunk=min(kv_chunk or cfg.kv_chunk, T))
        flash_case(torch, fa, ref, gen, (B, T, H, KV, D, causal), chunks,
                   totals, path="train" if i == 0 else None)

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
           "kernel": fa.kernel_for(q, k, v),
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


def scan_cases(cfg, ssm) -> list[tuple]:
    """``(path, mode, BH, T, dk, dv, chunk)`` of every scan the checks
    run: each distinct scan of the rwkv6 train path (one: every layer's
    time mix at batch x seq tokens, in the chunk the model picks), then
    zamba2's ssd shape."""
    train = {("train_rwkv6", "rwkv6", TRAIN_BATCH * cfg.num_heads,
              TRAIN_SEQ, cfg.hd, cfg.hd, ssm.scan_chunk(TRAIN_SEQ))}
    return sorted(train) + [("zamba2_ssd", "ssd", *SSD_SHAPE)]


def scan_bound(bh, t, dk, dv, chunk, mode, dtype, *,
               scalar_decay=False) -> tuple[float, str]:
    """Bytes: q, k, v, log-decay (one f32 per channel, or per token for a
    decay broadcast over dk) and u in, o and the final state out, once
    each.  Operations: per chunk the two causal C x C products (att and
    att v) and the two C x dk x dv products (q_t S and the state update),
    at the operand type's peak, which for bf16 is the tensor cores'
    rate.  So the bound assumes tensor cores: the products are f32 (q_t =
    q * exp(ex) is no bf16 value), and at the f32 FMA rate alone (67
    TFLOP/s) rwkv6's 2.156 GFLOP would take 32 us, above its bytes'
    17.6 us."""
    size = dtype.itemsize
    nbytes = (bh * t * (2 * dk + 2 * dv) * size
              + bh * t * (1 if scalar_decay else dk) * 4
              + (bh * dk * 4 if mode == "rwkv6" else 0) + bh * dk * dv * 4)
    tri = chunk * (chunk + 1) // 2
    flops = bh * (t // chunk) * 2 * (tri * (dk + dv) + 2 * chunk * dk * dv)
    return bound_ms(nbytes, flops, str(dtype).split(".")[-1])


def scan_phase(torch, sk, ref, ssm, cfg, totals) -> None:
    """Hold the scan kernel against its plain twin (output and final
    state) at every :func:`scan_cases` shape in bf16 and f32, time it in
    bf16 (the rwkv6 shape's time adds to ``totals["linear_scan"]
    ["train_rwkv6"]``), then check chunk 64 against chunk 128."""
    gen = torch.Generator(device=DEVICE).manual_seed(3)

    def rand(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=DEVICE) * scale

    t_tot = totals["linear_scan"]
    for path, mode, bh, t, dk, dv, chunk in scan_cases(cfg, ssm):
        # rwkv6: the model's decay at init, -exp(w0 + tanh(xA)B) with w0
        # = -2; ssd: the reference kernel test's -exp(N(0, 1)) * 0.1.
        ld = (-torch.exp(-2.0 + rand((bh, t, dk), 0.3)) if mode == "rwkv6"
              else -torch.exp(rand((bh, t, dk))) * 0.1)
        u = rand((bh, dk), 0.1)
        base = [rand((bh, t, dk)), rand((bh, t, dk)), rand((bh, t, dv))]
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            q, k, v = (x.to(dtype) for x in base)

            def kernel():
                return sk.linear_scan_cuda(q, k, v, ld, u, mode=mode,
                                           chunk=chunk)

            def plain():
                return ref.chunked_linear_scan(q, k, v, ld, u, mode=mode,
                                               chunk=chunk)

            (o, st), (wo, wst) = kernel(), plain()
            torch.cuda.synchronize()
            scale = wo.float().abs().max().item()
            err = (o.float() - wo.float()).abs().max().item()
            st_scale = wst.abs().max().item()
            st_err = (st - wst).abs().max().item()
            # f32: sums in another order.  bf16 v: o is rounded to bf16
            # once, which can land one ulp apart.  The state is f32.
            tol = (1e-5 * scale if dtype == torch.float32
                   else bf16_ulp(scale))
            ok = err <= tol and st_err <= 1e-5 * st_scale
            rec = {"path": path, "mode": mode, "BH": bh, "T": t, "dk": dk,
                   "dv": dv, "chunk": chunk, "dtype": dname,
                   "smem_bytes": sk.scan_smem_bytes(chunk, dk, dv,
                                                    dtype.itemsize),
                   "blocks_per_sm": sk.blocks_per_sm(chunk, dk, dv, dtype,
                                                     mode),
                   "max_abs_err": err, "max_rel_err": err / max(scale, 1e-30),
                   "scale": scale, "tol": tol,
                   "state_max_rel_err": st_err / max(st_scale, 1e-30),
                   "state_tol_rel": 1e-5}
            if not ok:
                emit("kernel:linear_scan", ok=False, **rec)
                raise AssertionError(f"scan kernel disagrees: {rec}")
            if dtype == torch.bfloat16:
                ms = device_ms(torch, kernel, inner=10, reps=15)
                plain_ms = device_ms(torch, plain, inner=5, reps=9)
                b, by = scan_bound(bh, t, dk, dv, chunk, mode, dtype)
                rec.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                           library_note="no PyTorch call computes this "
                           "recurrence", bound_ms=b, bound_by=by)
                add_total(t_tot.setdefault(path, new_totals()), ms,
                          plain_ms, None, b, by)
            t_tot["max_abs_err"] = max(t_tot["max_abs_err"], err)
            emit("kernel:linear_scan", ok=True, **rec)
    # Chunk boundaries are invisible: chunk 64 against 128 (f32, rwkv6
    # shape), each also against its plain twin.
    _, mode, bh, t, dk, dv, chunk = scan_cases(cfg, ssm)[0]
    q, k, v = rand((bh, t, dk)), rand((bh, t, dk)), rand((bh, t, dv))
    ld = -torch.exp(-2.0 + rand((bh, t, dk), 0.3))
    u = rand((bh, dk), 0.1)
    outs = {c: sk.linear_scan_cuda(q, k, v, ld, u, mode=mode, chunk=c)
            for c in (64, 128)}
    plain64 = ref.chunked_linear_scan(q, k, v, ld, u, mode=mode, chunk=64)
    torch.cuda.synchronize()
    scale = outs[128][0].abs().max().item()
    st_scale = outs[128][1].abs().max().item()
    rec = {"check": "chunk_continuity", "mode": mode, "BH": bh, "T": t,
           "dk": dk, "dv": dv, "chunks": [64, 128], "dtype": "float32",
           "o_64_vs_128_rel": (outs[64][0] - outs[128][0]).abs().max()
           .item() / scale,
           "state_64_vs_128_rel": (outs[64][1] - outs[128][1]).abs().max()
           .item() / st_scale,
           "o_64_vs_plain_rel": (outs[64][0] - plain64[0]).abs().max()
           .item() / scale,
           "state_64_vs_plain_rel": (outs[64][1] - plain64[1]).abs().max()
           .item() / st_scale,
           "tol_64_vs_128_rel": 1e-4, "tol_vs_plain_rel": 1e-5}
    ok = (rec["o_64_vs_128_rel"] <= 1e-4 and rec["state_64_vs_128_rel"] <= 1e-4
          and rec["o_64_vs_plain_rel"] <= 1e-5
          and rec["state_64_vs_plain_rel"] <= 1e-5)
    emit("kernel:linear_scan", ok=ok, **rec)
    if not ok:
        raise AssertionError(f"scan kernel fails chunk continuity: {rec}")
    bh, t = SSD_SHAPE[:2]
    broadcast_scan_check(torch, sk, ref, gen,
                         torch.full((bh, t, 1), -0.7, device=DEVICE),
                         check="ssd_broadcast_overflow")


def broadcast_scan_check(torch, sk, ref, gen, ld_tok, *, check: str,
                         path: str | None = None, totals=None) -> None:
    """zamba2's ssd shape with the log-decay ``ld_tok [BH, T, 1]`` one
    scalar per token, broadcast over dk (an expanded view, Mamba-2's
    form).  ``ssd_broadcast_overflow``: -0.7 a token, so a chunk's lc
    reaches -89.6, where the factored form's exp(-lc) overflows f32 (as
    the reference does on this input), which the check requires.  The
    kernel takes the exp(lc_i - lc_j) form: it and the twin must be
    finite, and the kernel within the f32 / bf16 gates of the twin and
    of the sequential oracle, output and final state; timed in bf16
    (with ``path``, beside the twin and the bound, adding to
    ``totals["linear_scan"][path]``)."""
    bh, t, dk, dv, chunk = SSD_SHAPE
    ld = ld_tok.expand(bh, t, dk)
    base = [torch.randn(s, generator=gen, device=DEVICE)
            for s in ((bh, t, dk), (bh, t, dk), (bh, t, dv))]
    factored, _ = ref.chunked_linear_scan(*base, ld.contiguous(),
                                          mode="ssd", chunk=chunk)
    must_overflow = check == "ssd_broadcast_overflow"
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        q, k, v = (x.to(dtype) for x in base)

        def kernel():
            return sk.linear_scan_cuda(q, k, v, ld, mode="ssd", chunk=chunk)

        o, st = kernel()
        wo, wst = ref.chunked_linear_scan(q, k, v, ld, mode="ssd",
                                          chunk=chunk)
        oo, ost = ref.linear_scan_batched(q, k, v, ld, mode="ssd",
                                          out_dtype=torch.float32)
        torch.cuda.synchronize()
        rec = {"check": check, "path": path, "mode": "ssd",
               "log_decay_per_token_min": ld_tok.min().item(),
               "log_decay_per_token_max": ld_tok.max().item(),
               "BH": bh, "T": t, "dk": dk,
               "dv": dv, "chunk": chunk, "dtype": dname,
               "factored_form_finite": bool(torch.isfinite(factored).all()),
               "kernel_finite": bool(torch.isfinite(o).all()
                                     and torch.isfinite(st).all()),
               "twin_finite": bool(torch.isfinite(wo).all()
                                   and torch.isfinite(wst).all())}
        # The overflow check's input must reach the overflow the form
        # repairs.
        ok = (rec["kernel_finite"] and rec["twin_finite"]
              and not (must_overflow and rec["factored_form_finite"]))
        for name, want, want_st in (("twin", wo, wst), ("oracle", oo, ost)):
            scale = want.float().abs().max().item()
            err = (o.float() - want.float()).abs().max().item()
            st_scale = want_st.abs().max().item()
            st_err = (st - want_st).abs().max().item()
            tol = (1e-5 * scale if dtype == torch.float32
                   else bf16_ulp(scale))
            rec.update({f"max_abs_err_vs_{name}": err, f"scale_{name}": scale,
                        f"tol_vs_{name}": tol,
                        f"state_max_rel_err_vs_{name}":
                            st_err / max(st_scale, 1e-30)})
            ok = ok and err <= tol and st_err <= 1e-5 * st_scale
        rec["state_tol_rel"] = 1e-5
        if not ok:
            emit("kernel:linear_scan", ok=False, **rec)
            raise AssertionError(f"scan kernel fails {check}: {rec}")
        if dtype == torch.bfloat16:
            b, by = scan_bound(bh, t, dk, dv, chunk, "ssd", dtype,
                               scalar_decay=True)
            ms = device_ms(torch, kernel, inner=10, reps=15)
            rec.update(ms=ms, bound_ms=b, bound_by=by)
            if path:
                plain_ms = device_ms(torch, lambda: ref.chunked_linear_scan(
                    q, k, v, ld, mode="ssd", chunk=chunk), inner=5, reps=9)
                rec.update(plain_ms=plain_ms, library_ms=None,
                           library_note="no PyTorch call computes this "
                           "recurrence")
                add_total(totals["linear_scan"].setdefault(
                    path, new_totals()), ms, plain_ms, None, b, by)
        if totals is not None:
            totals["linear_scan"]["max_abs_err"] = max(
                totals["linear_scan"]["max_abs_err"],
                rec["max_abs_err_vs_twin"])
        emit("kernel:linear_scan", ok=True, **rec)


def train_model_phase(torch, fc, plan_compiler, train_cli, einsum_ops, *,
                      name: str, arch_id: str, steps: int, lr: float,
                      tnn_cfg=None, batched_per_step=None,
                      num_layers=None, precision=None, loss_scale=1.0,
                      keep_model=False):
    """``arch_id`` (``rwkv6_7b``, ``zamba2_7b``, ``qwen2_7b``,
    ``olmoe_1b_7b``) at full width and depth (``num_layers`` cuts the
    depth) through the train entry point (``tnn_cfg`` in place of the
    arch's ``tnn_default`` when given); returns the run's kernel
    launches.  Each step must launch the GEMM kernel (a MoE model: the
    batched kernels exactly ``batched_per_step`` times a step, by
    launch key, what its compiled expert plans predict) and, under remat,
    the scan kernel twice per recurrent layer (forward and the
    checkpoint re-run), the attention kernel twice per attention layer,
    and for the hybrid once per shared-block application (not
    checkpointed).  Beside the peak device memory it reports the
    activation probe (measured around the first step) and the planner's
    modeled stash.  With ``precision`` (``--tnn-precision``, at
    ``loss_scale``) the quantized plans must requantize every op's result
    through the requantize kernels (their launches equal the quantized
    plan ops run, no scale derived in torch ops on the card) and leave
    every history finite; a MoE's quantized experts report how much of
    them is live a step (:class:`ExpertActivity`) and must be live at
    step 0 (every fed slot's output row non-zero, core gradients
    non-zero).  ``keep_model`` returns ``(launches, model)``,
    the trained model for a profile."""
    import numpy as np

    from repro_torch import memory
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fc.reset_launches()
    plan_compiler.reset_degrade_counts()
    seen = [dict(fc.LAUNCHES)]
    watch, activity = ExpertActivity(train_cli.steps_lib), []

    def on_step(step, metrics):
        seen.append(dict(fc.LAUNCHES))
        activity.append(watch.step())

    t0 = time.perf_counter()
    with CountQuantized(plan_compiler) as counts, watch:
        out = train_cli.train(arch_id, smoke=False, tnn=True, steps=steps,
                              global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                              lr=lr, tnn_backend="cuda", device=DEVICE,
                              log_every=4, on_step=on_step, tnn_cfg=tnn_cfg,
                              num_layers=num_layers, tnn_precision=precision,
                              loss_scale=loss_scale)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fc.LAUNCHES)
    degrades = dict(plan_compiler.DEGRADE_COUNTS)
    peak = torch.cuda.max_memory_allocated()
    per_step = [{k: b[k] - a[k] for k in (
                    "matmul", "matmul_reduce", "chain_n", "linear_scan",
                    "flash_attention_fwd", "matmul_batched",
                    "matmul_batched_reduce", "chain_n_batched",
                    "matmul_scaled", "chain_n_scaled", "requantize",
                    "matmul_scaled_batched", "matmul_scaled_batched_reduce",
                    "chain_n_scaled_batched", "requantize_batched",
                    "requantize_batched_amax", "quantize", "dequantize")}
                for a, b in zip(seen, seen[1:])]
    losses = out["losses"]
    rcfg = out["cfg"]
    per_layer = 2 if rcfg.remat else 1
    if rcfg.block == "attn":
        scans_per_step, attn_per_step = 0, per_layer * rcfg.num_layers
    else:
        scans_per_step = per_layer * rcfg.num_layers
        attn_per_step = (rcfg.num_layers // rcfg.hybrid.shared_every
                         if rcfg.hybrid else 0)
    step_ms = statistics.median(out["step_s"][3:]) * 1e3
    last5 = statistics.mean(losses[-5:])
    n_params = sum(p.numel() for p in out["state"]["params"].values())
    first_step_s = out["step_s"][0]
    out_gnorms = out["grad_norms"]
    if batched_per_step is None:
        def gemm_ok(s):
            return s["matmul"] > 0
    else:
        def gemm_ok(s):
            return all(s[k] == v for k, v in batched_per_step.items())
    router = {"lb_losses": out["lb_losses"], "z_losses": out["z_losses"]}
    ok = (all(np.isfinite(losses)) and len(losses) == steps
          and last5 < losses[0] and len(per_step) == steps
          and all(gemm_ok(s) and s["linear_scan"] == scans_per_step
                  and s["flash_attention_fwd"] == attn_per_step
                  for s in per_step)
          and all(np.isfinite(router["lb_losses"] + router["z_losses"]))
          and einsum_ops == 0 and degrades["runtime"] == 0)
    quant = {}
    if precision:
        hists = [p.detach() for n, p in out["state"]["params"].items()
                 if n.endswith("quant_amax")]
        requant_ok = (
            launches["requantize"] + launches["requantize_batched"]
            == counts["quantized_plan_ops"]
            and counts["torch_op_requantizes"] == 0)
        # Quantized experts do work at step 0 (just-in-time scales): every
        # fed slot's output row and some of every core's gradient non-zero.
        a0 = activity[0] if watch.layers and activity else None
        experts_ok = a0 is None or (
            a0["rows_fed"] > 0 and a0["rows_live"] == a0["rows_fed"]
            and a0["dcore_nonzero"] > 0)
        ok = (ok and bool(hists) and requant_ok and experts_ok
              and all(bool(torch.isfinite(h).all()) for h in hists)
              and degrades["runtime_quantized"] == 0)
        quant = dict(precision=precision, loss_scale=loss_scale,
                     every_op_requantized_by_kernel=requant_ok, **counts,
                     expert_activity=activity if watch.layers else None,
                     experts_live_at_step_0=experts_ok,
                     amax_histories=len(hists),
                     amax_history_shape=list(hists[0].shape) if hists
                     else None)
    stash = memory.stash_report(rcfg, TRAIN_BATCH, TRAIN_SEQ, 1,
                                rcfg.tnn.stash_policy())
    probe = {"peak_activation_bytes": out["peak_activation_bytes"],
             "peak_source": out["peak_source"],
             "modeled_stash_bytes": stash.peak_bytes,
             "modeled_stash_layer_bytes": stash.layer_bytes,
             "stash_policy": stash.stash.tag()}
    model = out["model"] if keep_model else None
    del out
    emit(name, ok=bool(ok), arch=arch_id, d_model=rcfg.d_model,
         layers=rcfg.num_layers, heads=rcfg.num_heads,
         kv_heads=rcfg.num_kv_heads, head_dim=rcfg.hd, d_ff=rcfg.d_ff,
         vocab=rcfg.vocab, params=n_params, remat=rcfg.remat,
         tnn_targets=list(rcfg.tnn.targets), tnn_rank=rcfg.tnn.rank,
         shared_every=rcfg.hybrid.shared_every if rcfg.hybrid else None,
         dtype=str(rcfg.compute_dtype).split(".")[-1], batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, steps=steps, lr=lr, losses=losses,
         grad_norms=out_gnorms, first_loss=losses[0], last5_mean_loss=last5,
         step_ms_median_after_3=step_ms,
         tok_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
         first_step_s=first_step_s, wall_s=wall,
         launches=launches, launches_per_step=per_step,
         batched_per_step_expected=batched_per_step,
         moe=(dataclasses.asdict(rcfg.moe) if rcfg.moe else None),
         **(router if rcfg.moe else {}),
         scans_per_step_expected=scans_per_step,
         attention_per_step_expected=attn_per_step, degrades=degrades,
         einsum_ops_in_plans=einsum_ops, max_memory_allocated=peak,
         **probe, **quant)
    if not ok:
        raise AssertionError(f"{name} phase failed")
    return (launches, model) if keep_model else launches


def state_phase(torch, fc, lm_mod, cfgbase, *, name: str, arch_id: str
                ) -> None:
    """The scan kernel's final state at the model level: ``arch_id`` at
    full width (its one-card TNN config where it has one), STATE_LAYERS
    layers (the hybrid's shared block after both), bf16, ``cuda``
    backend.  ``prefill`` over the first STATE_T - 1 tokens (the scan
    kernel; the shared attention through the attention kernel, its K/V
    kept) then ``decode_step`` on the last (the plain recurrences on the
    kernel's states, the shared attention over the prefilled K/V)
    against the last row of ``forward`` over all STATE_T tokens."""
    import numpy as np
    arch = cfgbase.get(arch_id)
    tnn = dataclasses.replace(arch.tnn_one_card or arch.tnn_default,
                              backend="cuda")
    cfg = dataclasses.replace(arch.model(tnn), num_layers=STATE_LAYERS)
    if cfg.hybrid:
        cfg = dataclasses.replace(cfg, hybrid=dataclasses.replace(
            cfg.hybrid, shared_every=STATE_LAYERS))
    groups = cfg.num_layers // cfg.hybrid.shared_every if cfg.hybrid else 0
    torch.cuda.empty_cache()
    model = lm_mod.LM(cfg, device=DEVICE, seed=0)
    rng = np.random.default_rng(4)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (STATE_BATCH, STATE_T)),
                           device=DEVICE)
    with torch.inference_mode():
        full = model(toks)[:, -1].float()
        fc.reset_launches()
        lp, cache = model.prefill(toks[:, :-1], max_len=STATE_T)
        prefill_scans = fc.LAUNCHES["linear_scan"]
        prefill_attn = fc.LAUNCHES["flash_attention_fwd"]
        ld, cache = model.decode_step(toks[:, -1], cache)
        decode_scans = fc.LAUNCHES["linear_scan"] - prefill_scans
        decode_attn = fc.LAUNCHES["flash_attention_fwd"] - prefill_attn
        prev = model(toks[:, :-1])[:, -1].float()
    torch.cuda.synchronize()
    scale = full.abs().max().item()
    diff = (ld.float() - full).abs().max().item()
    pre_diff = (lp.float() - prev).abs().max().item()
    ok = (diff <= STATE_TOL_REL * scale
          and pre_diff <= STATE_TOL_REL * prev.abs().max().item()
          and prefill_scans == STATE_LAYERS and decode_scans == 0
          and prefill_attn == groups and decode_attn == 0
          and int(cache.length) == STATE_T and bool(torch.isfinite(ld).all()))
    emit(name, ok=bool(ok), arch=arch_id, layers=STATE_LAYERS,
         shared_every=cfg.hybrid.shared_every if cfg.hybrid else None,
         d_model=cfg.d_model, batch=STATE_BATCH, prefill_tokens=STATE_T - 1,
         dtype=str(cfg.compute_dtype).split(".")[-1],
         decode_vs_forward_max_abs=diff, logit_scale=scale,
         decode_vs_forward_rel=diff / scale,
         prefill_vs_forward_rel=pre_diff / prev.abs().max().item(),
         tol_rel=STATE_TOL_REL, prefill_scan_launches=prefill_scans,
         decode_scan_launches=decode_scans,
         prefill_attention_launches=prefill_attn,
         decode_attention_launches=decode_attn,
         cache_length=int(cache.length))
    del model
    if not ok:
        raise AssertionError(f"{name} phase failed")


def ssm_parity_phase(torch, fc, arch, steps_lib, *, name: str) -> None:
    """``arch`` (``rwkv6_7b``, ``zamba2_7b`` with its one-card TNN config
    and the shared block after both layers) at full width, STATE_LAYERS
    layers, f32, on the cuda and einsum backends for PARITY_STEPS steps
    from the same weights and batches: the GEMM kernel at every rank-64
    FP/BP/WG geometry against ``torch.einsum``.  The model magnifies f32 roundoff (gradients at the
    noise floor, then AdamW's sign-like step on them), so, as in
    ``train_fp8_parity``, each backend is also run from its weights
    scaled by ``1 ± 2**-22``: at every step the backends' loss and grad
    norm differ by at most FP8_PARITY_FACTOR times that envelope, or by
    ``train_parity``'s f32 tolerance (1e-4) where the envelope is
    narrower.  The cuda runs must launch the GEMM kernel, the einsum runs
    must not."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim.adamw import AdamW

    hybrid = arch.model().hybrid is not None
    # Drawn on the host once; every run trains a copy on the card.
    base, cfg = steps_lib.build_model(
        arch, arch.tnn_one_card or arch.tnn_default, device=DEVICE, seed=0,
        backend="cuda", compute_dtype=torch.float32,
        num_layers=STATE_LAYERS,
        shared_every=STATE_LAYERS if hybrid else None)
    base_sd = {k: v.clone() for k, v in base.state_dict().items()}

    def train(backend, nudge=0.0):
        model = backend_twin(base, backend)
        model.load_state_dict({k: v * (1 + nudge) if v.is_floating_point()
                               else v for k, v in base_sd.items()})
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH))
        opt = AdamW(lr=TRAIN_LR, total_steps=TRAIN_STEPS,
                    warmup_steps=TRAIN_STEPS)
        params = dict(model.named_parameters())
        state = {"params": params, "opt": opt.init(params)}
        step = steps_lib.make_train_step(model, opt)
        before, metrics = fc.LAUNCHES["matmul"], []
        for s_ in range(PARITY_STEPS):
            batch = {k: torch.as_tensor(v).to(DEVICE)
                     for k, v in data.batch(s_).items()}
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        return metrics, fc.LAUNCHES["matmul"] - before

    def rel(a, b):
        return [[abs(x - y) / abs(y) for x, y in zip(sa, sb)]
                for sa, sb in zip(a, b)]

    runs = {b: train(b) for b in ("cuda", "einsum")}
    launches = {b: [r[1]] for b, r in runs.items()}
    spreads = []
    for b in runs:
        for n in (2.0 ** -22, -2.0 ** -22):
            metrics, count = train(b, n)
            spreads.append(rel(metrics, runs[b][0]))
            launches[b].append(count)
    gap = rel(runs["cuda"][0], runs["einsum"][0])
    ok = min(launches["cuda"]) > 0 and max(launches["einsum"]) == 0
    report = {}
    for i, metric in enumerate(("loss", "grad_norm")):
        env = [max(sp[s_][i] for sp in spreads) for s_ in range(PARITY_STEPS)]
        tol = [max(1e-4, FP8_PARITY_FACTOR * e) for e in env]
        good = all(g[i] <= t for g, t in zip(gap, tol))
        report[metric] = {"ok": good,
                          "cuda_vs_einsum_rel": [g[i] for g in gap],
                          "envelope_rel": env, "tol_rel": tol}
        ok = ok and good
    emit(name, ok=ok, arch=arch.id, layers=STATE_LAYERS,
         dtype="float32", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         steps=PARITY_STEPS, runs={b: r[0] for b, r in runs.items()},
         gemm_launches=launches, **report)
    if not ok:
        raise AssertionError(f"{name} failed")


def zamba2_kernel_phase(torch, fc, fa, sk, ref, plan_compiler, profiles,
                        tensorized, cfg, totals) -> int:
    """``kernel:zamba2``: the kernels at ``zamba2_7b``'s main-path shapes
    (its one-card TNN config).  The GEMM (and the chain, where the plans
    fuse one) at every geometry of the training step's FP/BP/WG plans
    and of the serve path's FP plans at the decode batch (the engine
    serves the hybrid through ``decode_step``), as in phase 2; the
    attention kernel at the shared block's training shape; the scan
    kernel at the Mamba-2 training shape with the log-decay at the
    model's init form (``-softplus(N(0, 1))`` a token, broadcast over
    dk).  Returns the training plans' ``EinsumOp`` count."""
    gemms, chains, einsum_ops = train_path_geometries(
        cfg, plan_compiler, profiles, tensorized)
    kernel_phase(torch, fc, ref, sorted(gemms), sorted(chains), totals,
                 path="train_zamba2", phases={**gemms, **chains},
                 time_dtypes=("bfloat16",))
    s_gemms, s_chains = main_path_geometries(
        cfg, plan_compiler, profiles, tensorized, token_batches=(BATCH,))
    kernel_phase(torch, fc, ref, s_gemms, s_chains, totals,
                 path="serve_zamba2", time_dtypes=("bfloat16",))
    T = TRAIN_SEQ
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    flash_case(torch, fa, ref, gen,
               (TRAIN_BATCH, T, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                True), dict(q_chunk=min(cfg.q_chunk, T),
                            kv_chunk=min(cfg.kv_chunk, T)),
               totals, path="train_zamba2")
    bh, t = SSD_SHAPE[:2]
    ld = -torch.nn.functional.softplus(
        torch.randn((bh, t, 1), generator=gen, device=DEVICE))
    broadcast_scan_check(torch, sk, ref, gen, ld, check="zamba2_train_scan",
                         path="train_zamba2", totals=totals)
    emit("kernel:zamba2", ok=True, arch=ZAMBA_ARCH,
         tnn_targets=list(cfg.tnn.targets),
         train_geometries={"gemm": len(gemms), "chain": len(chains),
                           "einsum_ops": einsum_ops},
         serve_geometries={"gemm": len(s_gemms), "chain": len(s_chains)},
         sums={name: {path: {k: (sorted(v) if isinstance(v, set) else v)
                             for k, v in totals[name][path].items()}
                      for path in ("train_zamba2", "serve_zamba2")
                      if path in totals[name]}
               for name in ALL_KERNELS})
    return einsum_ops


def serve_zamba2_phase(torch, fc, plan_compiler, tm, steps_lib, profiles,
                       arch, ServeEngine, Request, *, name="serve_zamba2",
                       compute_dtype=None) -> dict:
    """``zamba2_7b`` at full width and ZAMBA_SERVE_LAYERS of its 81
    layers (one shared-block period; one-card TNN config, ``cuda``
    backend, bf16 or ``compute_dtype``) through ``ServeEngine``
    at the serve CLI's defaults; the engine serves it through the
    reference's sequential fallback (each prompt token through
    ``decode_step``).  Every request must complete; the first wave's tokens (requests 0 to BATCH - 1,
    admitted together) must equal a hand-rolled loop of ``decode_step``
    over the prompts, then over the greedy tokens, at the same batch; no
    runtime degrade.  Also reported, not gated: how many of request 0's
    tokens the full-sequence route gives (``prefill`` over the prompt,
    then ``decode_step``).  Returns the run's kernel launches."""
    import numpy as np
    torch.cuda.empty_cache()
    tnn = dataclasses.replace(arch.tnn_one_card, backend="cuda")
    model, cfg = steps_lib.build_model(arch, tnn, device=DEVICE, seed=0,
                                       compute_dtype=compute_dtype,
                                       num_layers=ZAMBA_SERVE_LAYERS)
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
    got = {r.rid: r.out_tokens for r in done}
    wave = serve_requests(cfg.vocab, Request)[:BATCH]
    prompts = torch.as_tensor(np.stack([r.prompt for r in wave]),
                              device=DEVICE)
    # The engine's cache length (its max_len plus a chunk of slack): the
    # shared attention reduces over the whole K/V buffer, so another
    # length may sum in another order.
    max_len = engine.cache_len
    with torch.inference_mode():
        cache = model.init_cache(BATCH, max_len)._replace(
            length=torch.zeros(BATCH, dtype=torch.int32))
        for i in range(PROMPT):
            logits, cache = model.decode_step(prompts[:, i], cache)
        hand = [logits.float().argmax(-1)]
        while len(hand) < MAX_NEW:
            logits, cache = model.decode_step(hand[-1], cache)
            hand.append(logits.float().argmax(-1))
        hand = torch.stack(hand, dim=1).cpu().tolist()
        lp, pcache = model.prefill(prompts[:1], max_len=max_len)
        seq = [lp.float().argmax(-1)]
        while len(seq) < MAX_NEW:
            logits, pcache = model.decode_step(seq[-1], pcache)
            seq.append(logits.float().argmax(-1))
        seq = torch.cat(seq).cpu().tolist()
    first_wave_equal = all(got[r.rid] == hand[i] for i, r in enumerate(wave))
    prefill_agree = next((i for i, (a, b) in enumerate(zip(seq, got[0]))
                          if a != b), MAX_NEW)
    ok = (len(done) == REQUESTS
          and all(len(r.out_tokens) == MAX_NEW for r in done)
          and first_wave_equal and launches["matmul"] > 0
          and degrades["runtime"] == 0
          and tick_ms["prefill"] and tick_ms["decode"])
    emit(name, ok=bool(ok), arch=ZAMBA_ARCH, d_model=cfg.d_model,
         layers=cfg.num_layers, tnn_targets=list(cfg.tnn.targets),
         dtype=str(cfg.compute_dtype).split(".")[-1],
         requests=len(done), tokens=tokens, seconds=secs,
         tok_per_s=tokens / secs, ticks=engine.tick,
         prefill_tick_ms=tick_ms["prefill"],
         decode_tick_ms_median=statistics.median(tick_ms["decode"] or [0]),
         decode_ticks=len(tick_ms["decode"]),
         first_wave_equals_hand_rolled_decode=first_wave_equal,
         tokens_req0=got[0], hand_rolled_tokens_req0=hand[0],
         prefill_route_tokens_req0=seq,
         prefill_route_leading_tokens_equal=prefill_agree,
         slot_bytes=engine.slot_cost["total"],
         launches=launches, degrades=degrades,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del model, engine
    if not ok:
        raise AssertionError(f"{name} phase failed")
    return launches


def qwen2_kernel_phase(torch, fc, fa, ref, plan_compiler, profiles,
                       tensorized, cfgbase, cfg, totals) -> int:
    """``kernel:qwen2``: the kernels at ``qwen2_7b``'s main-path shapes
    (``--tnn``'s default: TT rank 64 on the SwiGLU).  The GEMM (and the
    chain, where a plan fuses one) at every geometry of the training
    step's FP/BP/WG plans, of the engine's FP plans at the prefill-chunk
    and decode batches, and of ``LM.prefill``'s at the first wave's
    prompt tokens, as in phase 2; the attention kernel at the training
    shape (B 8, T 128, H 28, KV 4, D 128, one kv chunk of 128) and at
    ``LM.prefill``'s (B 4, T 16, chunks of 16), as in phase 3, and off
    the main path at the other dense configs' training shapes.  Returns
    the training plans' ``EinsumOp`` count."""
    gemms, chains, einsum_ops = train_path_geometries(
        cfg, plan_compiler, profiles, tensorized)
    kernel_phase(torch, fc, ref, sorted(gemms), sorted(chains), totals,
                 path="train_qwen2", phases={**gemms, **chains},
                 time_dtypes=("bfloat16",))
    s_gemms, s_chains = main_path_geometries(cfg, plan_compiler, profiles,
                                             tensorized)
    kernel_phase(torch, fc, ref, s_gemms, s_chains, totals,
                 path="serve_qwen2", time_dtypes=("bfloat16",))
    p_gemms, p_chains = main_path_geometries(
        cfg, plan_compiler, profiles, tensorized,
        token_batches=(BATCH * PROMPT,))
    kernel_phase(torch, fc, ref, [g for g in p_gemms if g not in s_gemms],
                 [c for c in p_chains if c not in s_chains], totals,
                 path="prefill_qwen2", time_dtypes=("bfloat16",))
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.hd)
    for path, (b, t) in (("train_qwen2", (TRAIN_BATCH, TRAIN_SEQ)),
                         ("prefill_qwen2", (BATCH, PROMPT))):
        flash_case(torch, fa, ref, gen, (b, t, *heads, True),
                   dict(q_chunk=min(cfg.q_chunk, t),
                        kv_chunk=min(cfg.kv_chunk, t)), totals, path=path)
    for arch_id in DENSE_OTHERS:
        c = cfgbase.get(arch_id).model()
        t = TRAIN_SEQ
        flash_case(torch, fa, ref, gen,
                   (TRAIN_BATCH, t, c.num_heads, c.num_kv_heads, c.hd, True),
                   dict(q_chunk=min(c.q_chunk, t),
                        kv_chunk=min(c.kv_chunk, t)), totals)
    paths = ("train_qwen2", "serve_qwen2", "prefill_qwen2")
    emit("kernel:qwen2", ok=True, arch=QWEN_ARCH,
         tnn_targets=list(cfg.tnn.targets), tnn_rank=cfg.tnn.rank,
         train_geometries={"gemm": len(gemms), "chain": len(chains),
                           "einsum_ops": einsum_ops},
         serve_geometries={"gemm": len(s_gemms), "chain": len(s_chains)},
         prefill_geometries={"gemm": len(p_gemms), "chain": len(p_chains)},
         sums={name: {path: {k: (sorted(v) if isinstance(v, set) else v)
                             for k, v in totals[name][path].items()}
                      for path in paths if path in totals[name]}
               for name in ALL_KERNELS})
    return einsum_ops


def serve_qwen2_phase(torch, fc, plan_compiler, tm, steps_lib, profiles,
                      kv_cache, QuantPolicy, arch, ServeEngine, Request
                      ) -> dict:
    """``qwen2_7b`` at full width and depth (``--tnn``'s default,
    ``cuda`` backend, bf16) through ``ServeEngine`` at the serve CLI's
    defaults, once with a bf16 KV cache and once with an fp8 one
    (``QWEN_KV_POLICY``), on the same requests.  Every request must
    complete in both, with the GEMM kernel launched and no runtime
    degrade, and each request's first token must be the same in both
    (a single-chunk prompt's first token reads only its own tick's K/V).
    With one new token a request (so the caches hold the last wave's
    prompts and nothing else), the fp8 cache dequantized must lie within
    0.08 of the bf16 cache's amax, and dequantizing it to the compute
    dtype and requantizing it must give it back bit for bit on the card,
    amax unchanged (in f32, the bits).  Then the first wave through
    :func:`prefill_route` (counted as the ``prefill_qwen2`` run): the
    attention kernel once a layer; how many of request 0's bf16 tokens
    it shares with the engine is reported, not gated.  Returns the runs'
    kernel launches."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tnn = dataclasses.replace(arch.tnn_default, backend="cuda")
    model, cfg = steps_lib.build_model(arch, tnn, device=DEVICE, seed=0,
                                       num_layers=QWEN_SERVE_LAYERS)
    profiles.build_profiles(cfg, batch_size=BATCH, prefill_chunk=CHUNK)
    launches, runs, ok = {}, {}, True
    for kv, run in ((None, "serve_qwen2"), (QWEN_KV_POLICY,
                                            "serve_qwen2_fp8")):
        fc.reset_launches()
        plan_compiler.reset_degrade_counts()
        done, secs, engine = run_engine(torch, model, cfg.vocab, ServeEngine,
                                        Request, kv)
        launches[run] = dict(fc.LAUNCHES)
        degrades = dict(plan_compiler.DEGRADE_COUNTS)
        tick_ms = tick_spans_ms(torch, tm, model, cfg.vocab, ServeEngine,
                                Request, kv)
        tokens = sum(len(r.out_tokens) for r in done)
        runs[run] = {
            "kv": kv or "bf16", "requests": len(done), "tokens": tokens,
            "seconds": secs, "tok_per_s": tokens / secs, "ticks": engine.tick,
            "prefill_tick_ms": tick_ms["prefill"],
            "decode_tick_ms_median": statistics.median(
                tick_ms["decode"] or [0]),
            "slot_bytes": engine.slot_cost["total"],
            "out_tokens": {r.rid: r.out_tokens for r in done},
            "launches": launches[run], "degrades": degrades}
        ok = (ok and len(done) == REQUESTS
              and all(len(r.out_tokens) == MAX_NEW for r in done)
              and launches[run]["matmul"] > 0 and degrades["runtime"] == 0
              and bool(tick_ms["decode"]))
    bf16, fp8 = (runs[r]["out_tokens"] for r in ("serve_qwen2",
                                                 "serve_qwen2_fp8"))
    first_equal = all(bf16[rid][0] == fp8[rid][0] for rid in bf16)
    equal_tokens = sum(a == b for rid in bf16
                       for a, b in zip(bf16[rid], fp8[rid]))

    # The caches after one new token a request.
    _, _, e_bf16 = run_engine(torch, model, cfg.vocab, ServeEngine, Request,
                              max_new=1)
    _, _, e_fp8 = run_engine(torch, model, cfg.vocab, ServeEngine, Request,
                             QWEN_KV_POLICY, max_new=1)
    pol = e_fp8.kv_policy
    deq = kv_cache.dequantize_kv(e_fp8.qkv, pol, torch.float32)
    cache_err = {}
    for name, b, q in (("k", e_bf16.cache.k, deq[0]),
                       ("v", e_bf16.cache.v, deq[1])):
        b, q = b[:, :, :PROMPT].float(), q[:, :, :PROMPT]
        amax = b.abs().max().item()
        cache_err[name] = {"max_abs_err": (q - b).abs().max().item(),
                           "amax": amax, "tol": 0.08 * amax}
    # Requantize the dequantized cache, as every tick does (to the compute
    # dtype), and in f32: there ``qmax * scale`` may land an ulp above the
    # amax it came from, which then grows by that ulp (the bits hold).
    stable = {}
    for dname, dtype in (("compute", cfg.compute_dtype),
                         ("float32", torch.float32)):
        q0 = e_fp8.qkv
        again = kv_cache.quantize_kv(
            *kv_cache.dequantize_kv(q0, pol, dtype), pol, prev=q0)
        stable[dname] = {
            "bits_equal": all(
                torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                for a, b in ((again.qk, q0.qk), (again.qv, q0.qv))),
            "amax_equal": bool(torch.equal(again.k_amax, q0.k_amax)
                               and torch.equal(again.v_amax, q0.v_amax)),
            "amax_max_rel_change": max(
                ((a - b) / b).abs().max().item() for a, b in (
                    (again.k_amax, q0.k_amax), (again.v_amax, q0.v_amax)))}
    stable_ok = (stable["compute"]["bits_equal"]
                 and stable["compute"]["amax_equal"]
                 and stable["float32"]["bits_equal"])
    cache_ok = all(e["max_abs_err"] <= e["tol"] for e in cache_err.values())

    fc.reset_launches()
    route = prefill_route(torch, fc, model, cfg.vocab, Request, bf16,
                          e_bf16.cache_len)
    launches["prefill_qwen2"] = dict(fc.LAUNCHES)
    ok = (ok and first_equal and cache_ok and stable_ok
          and route["prefill_attention_launches"] == cfg.num_layers)
    emit("serve_qwen2", ok=bool(ok), arch=QWEN_ARCH, d_model=cfg.d_model,
         layers=cfg.num_layers, heads=cfg.num_heads,
         kv_heads=cfg.num_kv_heads, head_dim=cfg.hd,
         tnn_targets=list(cfg.tnn.targets), runs=runs,
         first_tokens_equal=first_equal,
         tokens_equal_bf16_fp8=equal_tokens,
         tokens=sum(len(t) for t in bf16.values()),
         fp8_cache_vs_bf16=cache_err, fp8_cache_ok=cache_ok,
         requantize_bit_stable=stable, prefill_route=route,
         prefill_launches=launches["prefill_qwen2"],
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del model, e_bf16, e_fp8
    if not ok:
        raise AssertionError("serve_qwen2 phase failed")
    return launches


def serve_requests(vocab: int, Request):
    import numpy as np
    rng = np.random.default_rng(0)
    return [Request(rid=rid, prompt=rng.integers(0, vocab, size=PROMPT,
                                                 dtype=np.int32),
                    max_new_tokens=MAX_NEW, temperature=0.0)
            for rid in range(REQUESTS)]


def run_engine(torch, model, vocab, ServeEngine, Request, kv_policy=None,
               max_new=MAX_NEW):
    """Serve the phase's requests (``max_new`` tokens each, a KV cache
    stored as ``kv_policy``); returns (completed, wall seconds of
    ``engine.run()``, engine).  Nothing times the ticks inside the run."""
    engine = ServeEngine(model, batch_size=BATCH,
                         max_len=PROMPT + MAX_NEW + 8, prefill_chunk=CHUNK,
                         kv_policy=kv_policy)
    for req in serve_requests(vocab, Request):
        engine.submit(dataclasses.replace(req, max_new_tokens=max_new))
    engine.warmup()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    return done, time.perf_counter() - t0, engine


def tick_spans_ms(torch, tm, model, vocab, ServeEngine, Request,
                  kv_policy=None) -> dict:
    """Tick times from the engine's own ``serve.prefill_chunk`` /
    ``serve.decode_step`` spans, over one traced run of the phase's
    requests (with tracing on, each span closes when the card is done)."""
    tm.reset()
    tm.configure()
    try:
        run_engine(torch, model, vocab, ServeEngine, Request, kv_policy)
        spans = [e for e in tm.snapshot() if e.get("type") == "span"]
    finally:
        tm.reset()
    return {name: [e["dur"] / 1e3 for e in spans
                   if e["name"] == f"serve.{span}"]
            for name, span in (("prefill", "prefill_chunk"),
                               ("decode", "decode_step"))}


class CountQuantized:
    """Counts, while active, the quantized plan ops the plans run (around
    ``plan_compiler._run_quantized``) and the scales ``quant.quantize``
    derives from a tensor on the card (a requantize in torch ops, which
    the requantize kernels replace there)."""

    def __init__(self, plan_compiler):
        self.pc = plan_compiler
        self.counts = {"quantized_plan_ops": 0, "torch_op_requantizes": 0}

    def __enter__(self):
        run, quantize = self.pc._run_quantized, self.pc.q.quantize
        self.saved = (run, quantize)

        def counted_run(compiled, tensors, **kw):
            self.counts["quantized_plan_ops"] += len(compiled.ops)
            return run(compiled, tensors, **kw)

        def counted_quantize(x, policy, scale=None, lead=0):
            if scale is None and x.is_cuda:
                self.counts["torch_op_requantizes"] += 1
            return quantize(x, policy, scale=scale, lead=lead)

        self.pc._run_quantized = counted_run
        self.pc.q.quantize = counted_quantize
        return self.counts

    def __exit__(self, *exc):
        self.pc._run_quantized, self.pc.q.quantize = self.saved
        return False


class ExpertActivity:
    """How much of a MoE model's quantized experts is live, step by step,
    while active: every model ``steps_lib.build_model`` builds gets
    forward hooks on its quantized expert layers and gradient hooks on
    their cores.  :meth:`step` (call it once a step) returns and resets
    the step's counts, summed over layers, matrices and forward runs: of
    the slots fed a non-zero input row, those whose output row is
    non-zero (``rows_live`` of ``rows_fed``); the core gradients'
    non-zero elements (``dcore_nonzero`` of ``dcore_elements``); and the
    largest slot of any expert history (``hist_max``), which the
    reference's sum over the token groups grows a step."""

    def __init__(self, steps_lib):
        self.lib = steps_lib
        self.layers, self.out, self.grad = [], [], []

    def __enter__(self):
        import torch

        from repro_torch.core.tensorized import TensorizedLinear
        build = self.saved = self.lib.build_model

        def count(*ts):
            return torch.stack([t.sum() for t in ts])

        def fwd(mod, inp, out):
            fed = inp[0].detach().abs().amax(-1) > 0      # [E, G, C]
            live = out.detach().abs().amax(-1) > 0
            self.out.append(count(fed & live, fed))

        def bwd(g):
            self.grad.append(count(g.detach() != 0, torch.ones_like(
                g, dtype=torch.bool)))

        def built(*a, **k):
            model, cfg = build(*a, **k)
            for mod in model.modules():
                if (isinstance(mod, TensorizedLinear) and mod.num_experts
                        and mod.precision.quantized):
                    self.layers.append(mod)
                    mod.register_forward_hook(fwd)
                    for c in mod.cores:
                        c.register_hook(bwd)
            return model, cfg

        self.lib.build_model = built
        return self

    def __exit__(self, *exc):
        self.lib.build_model = self.saved
        return False

    def step(self) -> dict:
        import torch
        if not self.layers:
            return {}
        o = torch.stack(self.out).sum(0).tolist() if self.out else [0, 0]
        g = torch.stack(self.grad).sum(0).tolist() if self.grad else [0, 0]
        hist = max(float(m.quant_amax.detach().max()) for m in self.layers)
        self.out, self.grad = [], []
        return {"rows_live": o[0], "rows_fed": o[1], "dcore_nonzero": g[0],
                "dcore_elements": g[1], "hist_max": hist}


def train_phase(torch, fc, plan_compiler, train_cli, einsum_ops, *,
                name="train", precision=None, loss_scale=1.0,
                bf16_last5=None) -> tuple[dict, float, dict]:
    """Full-width training through the port's train entry point; returns
    the kernel launches of the run, the mean of its last 5 losses and a
    summary (step ms, step 0's loss and grad norm, launches a step, the
    activation probe).
    With ``precision`` every tensorized plan runs quantized (``train_fp8``),
    which must launch the precision path's kernels, leave no quantized
    degrade, fill every amax history slot, end within ``FP8_LOSS_TOL`` of
    ``bf16_last5``, and requantize every quantized plan op's result
    through the requantize kernel: its launches equal the ops the plans
    ran (counted around ``plan_compiler._run_quantized``), and
    ``quant.quantize`` derived no scale from a tensor on the card."""
    import numpy as np
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fc.reset_launches()
    plan_compiler.reset_degrade_counts()
    t0 = time.perf_counter()
    with CountQuantized(plan_compiler) as counts:
        out = train_cli.train(ARCH, smoke=False, tnn=True, steps=TRAIN_STEPS,
                              global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                              lr=TRAIN_LR, tnn_backend="cuda", device=DEVICE,
                              log_every=5, tnn_precision=precision,
                              loss_scale=loss_scale)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fc.LAUNCHES)
    degrades = dict(plan_compiler.DEGRADE_COUNTS)
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    step_ms = statistics.median(out["step_s"][3:]) * 1e3
    last5 = statistics.mean(losses[-5:])
    kernels = (("flash_attention_fwd",) + QUANT_KERNELS if precision
               else KERNELS)
    ok = (all(np.isfinite(losses)) and len(losses) == TRAIN_STEPS
          and last5 < losses[0]
          and all(launches[k] > 0 for k in kernels)
          and degrades["runtime"] == 0
          and degrades["runtime_quantized"] == 0)
    extra = {}
    if precision:
        hists = {n: p.detach() for n, p in out["state"]["params"].items()
                 if n.endswith("quant_amax")}
        filled = all(bool(torch.isfinite(h).all() and (h > 0).all())
                     for h in hists.values())
        requant_ok = (launches["requantize"] == counts["quantized_plan_ops"]
                      and counts["torch_op_requantizes"] == 0)
        ok = ok and bool(hists) and filled and requant_ok and (
            abs(last5 - bf16_last5) <= FP8_LOSS_TOL)
        extra = dict(precision=precision, loss_scale=loss_scale,
                     requantize_launches=launches["requantize"],
                     requantize_amax_launches=launches["requantize_amax"],
                     every_op_requantized_by_kernel=requant_ok, **counts,
                     amax_histories=len(hists), amax_slots_filled=filled,
                     bf16_last5_mean_loss=bf16_last5,
                     last5_minus_bf16=last5 - bf16_last5,
                     tol_last5_vs_bf16=FP8_LOSS_TOL)
    cfg = out["cfg"]
    emit(name, ok=bool(ok), arch=ARCH, d_model=cfg.d_model,
         layers=cfg.num_layers, remat=cfg.remat,
         dtype=str(cfg.compute_dtype).split(".")[-1], batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, steps=TRAIN_STEPS, losses=losses,
         grad_norms=out["grad_norms"], first_loss=losses[0],
         last5_mean_loss=last5, step_ms_median_after_3=step_ms,
         tok_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
         first_step_s=out["step_s"][0], wall_s=wall,
         launches=launches,
         launches_per_step={k: launches[k] / TRAIN_STEPS for k in kernels},
         degrades=degrades, einsum_ops_in_plans=einsum_ops,
         max_memory_allocated=peak,
         peak_activation_bytes=out["peak_activation_bytes"],
         peak_source=out["peak_source"],
         modeled_activation_bytes=out["modeled_activation_bytes"], **extra)
    if not ok:
        raise AssertionError(f"{name} phase failed")
    summary = {"step_ms": step_ms, "loss0": losses[0],
               "grad_norm0": out["grad_norms"][0],
               "launches_per_step": {k: launches[k] / TRAIN_STEPS
                                     for k in launches},
               "peak_activation_bytes": out["peak_activation_bytes"],
               "peak_source": out["peak_source"]}
    return launches, last5, summary


def train_parity_phase(torch, arch, steps_lib, *, name="train_parity",
                       tnn=None, num_layers=None, routes=None,
                       routing=False, make_batch=None,
                       route_check=None) -> None:
    """The same initial parameters trained on the cuda and einsum
    backends for PARITY_STEPS steps on the same batches (``arch`` with
    ``tnn`` for its TNN config and ``num_layers`` its depth when given).
    With ``routes`` (``(ServeEngine, Request, fc)``) the f32 cuda model,
    before it trains, also serves the serve phase's requests through the
    engine, whose first wave's greedy tokens must equal
    :func:`prefill_route`'s.  With ``routing`` (a MoE model) the first
    batch's top-k picks on both backends, before training, must agree on
    at least ``ROUTING_AGREEMENT`` of the (token, k) picks in each
    dtype (:func:`routing_agreement`).  ``make_batch(cfg, step)``, when
    given, makes each step's batch (an encoder-decoder's); the train
    CLI's synthetic data otherwise.  ``route_check(model, cfg)``, when
    given, runs on the f32 cuda model before it trains and must return
    ``{"equal": True, ...}``."""
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
        model, cfg = steps_lib.build_model(arch, tnn, device=DEVICE, seed=0,
                                           backend="cuda",
                                           compute_dtype=dtype,
                                           num_layers=num_layers)
        models = {"cuda": model, "einsum": backend_twin(model, "einsum")}
        if routing:
            first = SyntheticLM(DataConfig(
                vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                global_batch=TRAIN_BATCH)).batch(0)
            agree = routing_agreement(torch, models, first)
            agree["tol"] = ROUTING_AGREEMENT
            report[f"{dname}_routing"] = agree
            ok = ok and agree["share"] >= ROUTING_AGREEMENT
        if routes and dtype == torch.float32:
            ServeEngine, Request, fc = routes
            done, _, engine = run_engine(torch, model, cfg.vocab,
                                         ServeEngine, Request)
            report["routes_f32"] = prefill_route(
                torch, fc, model, cfg.vocab, Request,
                {r.rid: r.out_tokens for r in done}, engine.cache_len)
            ok = ok and report["routes_f32"]["equal"]
        if route_check and dtype == torch.float32:
            report["routes_f32"] = route_check(model, cfg)
            ok = ok and report["routes_f32"]["equal"]
        del model
        if make_batch is None:
            data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                          global_batch=TRAIN_BATCH))

            def make_batch(cfg, s):
                return {k: torch.as_tensor(v).to(DEVICE)
                        for k, v in data.batch(s).items()}
        for backend in ("cuda", "einsum"):
            model = models.pop(backend)
            opt = AdamW(lr=TRAIN_LR, total_steps=TRAIN_STEPS,
                        warmup_steps=TRAIN_STEPS)
            params = dict(model.named_parameters())
            state = {"params": params, "opt": opt.init(params)}
            step = steps_lib.make_train_step(model, opt)
            hist = []
            for s in range(PARITY_STEPS):
                state, m = step(state, make_batch(cfg, s))
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
    emit(name, ok=ok, arch=arch.id, layers=getattr(
        cfg, "num_layers", None) or [cfg.num_enc_layers, cfg.num_dec_layers],
        steps=PARITY_STEPS, **report)
    if not ok:
        raise AssertionError(f"{name} failed")


def backend_twin(model, backend: str, phase_paths=None):
    """A copy of ``model`` (same weights, on its device) whose tensorized
    layers run ``backend`` (and, when given, ``phase_paths``): what
    ``build_model`` gives from the same seed with that TNN config,
    without drawing the weights on the host again."""
    import copy

    from repro_torch.core import contraction
    from repro_torch.core.tensorized import TensorizedLinear
    twin = copy.deepcopy(model)
    if phase_paths is None:
        phase_paths = twin.cfg.tnn.phase_paths
    for m in twin.modules():
        if isinstance(m, TensorizedLinear):
            m.backend = contraction.canonical_backend(backend)
            m.phase_paths = phase_paths
    twin.cfg = dataclasses.replace(twin.cfg, tnn=dataclasses.replace(
        twin.cfg.tnn, backend=backend, phase_paths=phase_paths))
    return twin


def prefill_route(torch, fc, model, vocab, Request, got: dict, cache_len
                  ) -> dict:
    """The first wave's prompts (requests 0 to BATCH - 1, which the
    engine admitted together) through the full-sequence route:
    ``LM.prefill`` over all of them (the attention kernel at each layer),
    its cache ``cache_len`` long as the engine's, then ``decode_step``
    greedily.  Returns its tokens beside the engine's (``got``, by
    request id), whether they are equal, and the attention launches of
    the prefill."""
    import numpy as np
    wave = serve_requests(vocab, Request)[:BATCH]
    prompts = torch.as_tensor(np.stack([r.prompt for r in wave]),
                              device=DEVICE)
    with torch.inference_mode():
        before = fc.LAUNCHES["flash_attention_fwd"]
        logits, cache = model.prefill(prompts, max_len=cache_len)
        flash = fc.LAUNCHES["flash_attention_fwd"] - before
        toks = [logits.float().argmax(-1)]
        while len(toks) < MAX_NEW:
            logits, cache = model.decode_step(toks[-1], cache)
            toks.append(logits.float().argmax(-1))
    seq = torch.stack(toks, dim=1).cpu().tolist()
    engine_wave = [got[r.rid] for r in wave]
    return {"equal": seq == engine_wave,
            "leading_tokens_equal": [
                next((i for i, (a, b) in enumerate(zip(x, y)) if a != b),
                     MAX_NEW) for x, y in zip(seq, engine_wave)],
            "prefill_tokens": seq[0], "engine_tokens": engine_wave[0],
            "prefill_attention_launches": flash}


def train_fp8_parity_phase(torch, arch, steps_lib, QuantPolicy, *,
                           name="train_fp8_parity", tnn=None,
                           num_layers=None, exact_inputs=None,
                           amax_metric="element") -> None:
    """``cuda`` against ``einsum`` under fp8 (loss scale 128, f32 compute)
    for PARITY_STEPS steps from the same weights and batches (``arch``
    with ``tnn`` for its TNN config and ``num_layers`` its depth when
    given; both backends share one weight draw: the einsum model is the
    cuda model's :func:`backend_twin`).

    * Exact: after the first step, the amaxes recorded before anything
      quantized (every core's; the input rows of ``exact_inputs``, by
      default the first layer's q/k/v) agree within 1e-6, and the cuda
      run at loss scale 1 is bit-identical to the one at 128 except row
      1 of each history (``amax(dy)``), which is exactly 128 times
      smaller.
    * fp8 training is chaotic at roundoff from the first step
      (per-tensor requantization after every contraction turns a one-ulp
      difference into a flipped fp8 rounding, which spreads: on an H100
      the nudge below moves the first step's grad norm by 0.15), so each
      backend is also run from its weights scaled by ``1 ± 2**-22`` (f32
      roundoff): at every step the backends' loss, grad norm and largest
      amax difference stay within FP8_PARITY_FACTOR times that
      envelope.  ``amax_metric`` ``"element"`` takes an amax's difference
      relative to itself; ``"leaf"`` relative to its history leaf's
      largest written slot (a MoE's expert histories, whose older slots
      hold differences of close amaxes under the sum over groups)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim.adamw import AdamW
    tnn = dataclasses.replace(tnn or arch.tnn_default,
                              precision=QuantPolicy.parse(FP8_POLICY))
    models, base = {}, {}

    def model_for(backend):
        if "cuda" not in models:
            models["cuda"], base["cfg"] = steps_lib.build_model(
                arch, tnn, device=DEVICE, seed=0, backend="cuda",
                compute_dtype=torch.float32, num_layers=num_layers)
            base["sd"] = {k: v.clone()
                          for k, v in models["cuda"].state_dict().items()}
        if backend not in models:
            models[backend] = backend_twin(models["cuda"], backend)
        return models[backend]

    def train(backend, nudge=0.0, loss_scale=FP8_LOSS_SCALE):
        model = model_for(backend)
        cfg = base["cfg"]
        model.load_state_dict({
            k: (v * (1 + nudge) if v.is_floating_point()
                and not k.endswith("quant_amax") else v)
            for k, v in base["sd"].items()})
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH))
        opt = AdamW(lr=TRAIN_LR, total_steps=TRAIN_STEPS,
                    warmup_steps=TRAIN_STEPS, loss_scale=loss_scale)
        params = dict(model.named_parameters())
        state = {"params": params, "opt": opt.init(params)}
        step = steps_lib.make_train_step(model, opt)
        metrics, hists = [], []
        for s_ in range(PARITY_STEPS):
            batch = {k: torch.as_tensor(v).to(DEVICE)
                     for k, v in data.batch(s_).items()}
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            hists.append({n: p.detach().clone() for n, p in params.items()
                          if n.endswith("quant_amax")})
        return metrics, hists, {n: p.detach().clone()
                                for n, p in params.items()}

    def amax_gap(a, b):
        if amax_metric == "leaf":
            return float((a - b).abs().max() / b.abs().max())
        return float(((a - b).abs() / b).max())

    def per_step(a, b):
        """Per step: relative loss, grad norm and largest difference of a
        written amax."""
        out = []
        for s_, ((la, ga), (lb, gb)) in enumerate(zip(a[0], b[0])):
            h = max(amax_gap(a[1][s_][n][..., :s_ + 1], h_[..., :s_ + 1])
                    for n, h_ in b[1][s_].items())
            out.append((abs(la - lb) / abs(lb), abs(ga - gb) / abs(gb), h))
        return out

    runs = {b: train(b) for b in ("cuda", "einsum")}
    spreads = [per_step(train(b, n), runs[b]) for b in runs
               for n in (2.0 ** -22, -2.0 ** -22)]
    envelope = [[max(sp[s_][i] for sp in spreads) for i in range(3)]
                for s_ in range(PARITY_STEPS)]
    gap = per_step(runs["cuda"], runs["einsum"])
    report, ok = {}, True
    for i, metric in enumerate(("loss", "grad_norm", "amax")):
        tol = [FP8_PARITY_FACTOR * e[i] + 1e-6 for e in envelope]
        good = all(g[i] <= t for g, t in zip(gap, tol))
        report[metric] = {"ok": good, "cuda_vs_einsum_rel": [g[i] for g in gap],
                          "envelope_rel": [e[i] for e in envelope],
                          "tol_rel": tol}
        ok = ok and good
    # Exact rows: what the first step recorded before anything quantized.
    h_c, h_e = runs["cuda"][1][0], runs["einsum"][1][0]
    inputs = exact_inputs or [f"layers.0.attn.{p}.quant_amax"
                              for p in "qkv"]
    exact = max([float(((h_c[n][..., 2:, 0] - h_e[n][..., 2:, 0]).abs()
                        / h_e[n][..., 2:, 0]).max()) for n in h_e]
                + [float(((h_c[n][..., 0, 0] - h_e[n][..., 0, 0]).abs()
                          / h_e[n][..., 0, 0]).max()) for n in inputs])
    report["exact_rows_rel"] = exact
    ok = ok and exact <= 1e-6
    # Loss scale: a power of two scales dy and its delayed scale alike.
    m1, _, p1 = train("cuda", loss_scale=1.0)
    m128, p128 = runs["cuda"][0], runs["cuda"][2]
    ls_exact = m1 == m128
    for n, t in p1.items():
        want = p128[n]
        if n.endswith("quant_amax"):
            ls_exact = ls_exact and torch.equal(want[..., 1, :],
                                                t[..., 1, :] * FP8_LOSS_SCALE)
            want = torch.cat([want[..., :1, :], want[..., 2:, :]], dim=-2)
            t = torch.cat([t[..., :1, :], t[..., 2:, :]], dim=-2)
        ls_exact = ls_exact and torch.equal(want, t)
    report["loss_scale_exact"] = bool(ls_exact)
    ok = ok and ls_exact
    emit(name, ok=ok, arch=arch.id, layers=base["cfg"].num_layers,
         steps=PARITY_STEPS, policy=FP8_POLICY, loss_scale=FP8_LOSS_SCALE,
         compute_dtype="float32", amax_metric=amax_metric,
         runs={b: r[0] for b, r in runs.items()}, **report)
    if not ok:
        raise AssertionError(f"{name} failed")


def pp_off_geometries(cfg, fc, plan_compiler, profiles, tensorized):
    """The GEMMs and chains of the ``phase_paths=False`` training path:
    its FP plans at the train token batch (``fwd``: the forward, run
    through the autograd Functions) and the GEMMs their backward runs
    (``bwd``, ``{geometry: roles}``: ``dx``/``dw`` of each forward GEMM;
    for each chain the link-input recompute, each link's ``dw`` and
    ``dx``), and the chains the FP plans fuse at the memory phase's
    microbatch and the serve batches (where the chain Function is
    checked, the train batch fusing none)."""
    tokens = TRAIN_BATCH * TRAIN_SEQ
    gemms, chains = main_path_geometries(cfg, plan_compiler, profiles,
                                         tensorized, token_batches=(tokens,))
    bwd: dict = {}
    for m, n, k, trans in gemms:
        bwd.setdefault((m, k, n, not trans), set()).add("dx")
        bwd.setdefault((n, k, m, False) if trans else (k, n, m, False),
                       set()).add("dw")
    for m0, shapes in chains:
        rows, _ = fc.chain_plan(m0, shapes)
        for i, ((k, n), r) in enumerate(zip(shapes, rows)):
            if i < len(shapes) - 1:
                bwd.setdefault((r, n, k, False), set()).add("recompute")
            bwd.setdefault((k, n, r, False), set()).add("dw")
            bwd.setdefault((r, k, n, True), set()).add("dx")
    _, other_chains = main_path_geometries(
        cfg, plan_compiler, profiles, tensorized,
        token_batches=(tokens // 2, BATCH * CHUNK, BATCH))
    return gemms, chains, bwd, other_chains


def autograd_phase(torch, fc, ops, ref, gemms, chains) -> None:
    """The GEMM and chain kernels' autograd Functions (``kernels.ops``) at
    the ``phase_paths=False`` path's forward GEMMs and at the FP plans'
    chains: value and every input's gradient against torch autograd of
    the plain version on the same card inputs, f32 within 1e-5 and bf16
    within 2e-2 of each one's scale (the card tests' GEMM rule: one bf16
    rounding carried through a link); the backward's GEMMs count under
    ``matmul_bwd``."""
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    worst, n_cases = {}, 0
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        rel = 1e-5 if dtype == torch.float32 else 2e-2
        cases = ([("matmul", (m, k), (n, k) if t else (k, n), t)
                  for m, n, k, t in gemms]
                 + [("chain_n", (m0, shapes[0][0]), *shapes)
                    for m0, shapes in chains])
        for case in cases:
            kind = case[0]
            if kind == "matmul":
                shapes, trans = case[1:3], case[3]
                fn = lambda t: ops.matmul(t[0], t[1],  # noqa: E731
                                          transpose_rhs=trans)
                plain = lambda t: ref.matmul(t[0], t[1],  # noqa: E731
                                             transpose_rhs=trans)
            else:
                shapes = case[1:]
                fn = lambda t: ops.chain_n(t[0], t[1:])  # noqa: E731
                plain = lambda t: ref.chain_n(t[0], t[1:])  # noqa: E731
            host = [torch.randn(s, generator=gen, device=DEVICE).to(dtype)
                    for s in shapes]
            outs = []
            before = fc.LAUNCHES["matmul_bwd"]
            for f in (fn, plain):
                ins = [t.clone().requires_grad_() for t in host]
                y = f(ins)
                y.backward(torch.ones_like(y))
                outs.append([y.detach()] + [t.grad for t in ins])
            torch.cuda.synchronize()
            errs = [float((a.float() - b.float()).abs().max())
                    / max(float(b.float().abs().max()), 1e-30)
                    for a, b in zip(*outs)]
            ok = (max(errs) <= rel
                  and fc.LAUNCHES["matmul_bwd"] > before)
            rec = {"kernel": kind, "dtype": dname,
                   "shapes": [list(s) for s in shapes],
                   "rel_err_value_and_grads": errs, "tol_rel": rel,
                   "backward_launches": fc.LAUNCHES["matmul_bwd"] - before}
            if not ok:
                emit("kernel:autograd", ok=False, **rec)
                raise AssertionError(f"autograd Function disagrees: {rec}")
            key = (kind, dname)
            worst[key] = max(worst.get(key, 0.0), max(errs))
            n_cases += 1
    emit("kernel:autograd", ok=True, cases=n_cases,
         forward_gemms=len(gemms), chains=len(chains),
         worst_rel_err={f"{k}/{d}": v for (k, d), v in worst.items()})


def train_phase_paths_off_phase(torch, fc, plan_compiler, train_cli, arch,
                                fp_chains, per_phase) -> tuple[dict, dict]:
    """``paper_atis_tt`` at full width through the train entry point with
    ``phase_paths=False`` (autodiff through the FP plans, the paper's
    ablation), ``cuda``, bf16, the ``train`` phase's shape, seed and data:
    every loss finite, the last 5 below the first, on every step the GEMM
    kernel in the forward and in the backward (``matmul_bwd``), the chain
    kernel where the FP plans fuse a chain and only there, no runtime
    degrade; step 0's loss and grad norm within the bf16 ``cuda``-vs-
    ``einsum`` tolerance (1e-2 / 5e-2 relative) of the per-phase run from
    the same parameters (``per_phase``, the ``train`` phase).  Returns
    the run's launches and its summary."""
    import numpy as np
    torch.cuda.synchronize()
    fc.reset_launches()
    plan_compiler.reset_degrade_counts()
    seen = [dict(fc.LAUNCHES)]
    tnn = dataclasses.replace(arch.tnn_default, phase_paths=False)
    t0 = time.perf_counter()
    out = train_cli.train(ARCH, smoke=False, tnn=True, steps=TRAIN_STEPS,
                          global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                          lr=TRAIN_LR, tnn_backend="cuda", device=DEVICE,
                          log_every=5, tnn_cfg=tnn,
                          on_step=lambda s, m: seen.append(dict(fc.LAUNCHES)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fc.LAUNCHES)
    degrades = dict(plan_compiler.DEGRADE_COUNTS)
    keys = ("matmul", "matmul_reduce", "matmul_bwd", "matmul_bwd_reduce",
            "chain_n", "flash_attention_fwd")
    per_step = [{k: b[k] - a[k] for k in keys}
                for a, b in zip(seen, seen[1:])]
    losses, gnorms = out["losses"], out["grad_norms"]
    last5 = statistics.mean(losses[-5:])
    step_ms = statistics.median(out["step_s"][3:]) * 1e3
    loss0_rel = abs(losses[0] - per_phase["loss0"]) / abs(per_phase["loss0"])
    gn0_rel = (abs(gnorms[0] - per_phase["grad_norm0"])
               / abs(per_phase["grad_norm0"]))
    ok = (all(np.isfinite(losses)) and len(losses) == TRAIN_STEPS
          and last5 < losses[0] and len(per_step) == TRAIN_STEPS
          and all(s["matmul"] > 0 and s["matmul_bwd"] > 0
                  and (s["chain_n"] > 0) == bool(fp_chains)
                  for s in per_step)
          and not out["cfg"].tnn.phase_paths
          and degrades["runtime"] == 0
          and loss0_rel <= 1e-2 and gn0_rel <= 5e-2)
    summary = {"step_ms": step_ms, "loss0": losses[0],
               "grad_norm0": gnorms[0], "last5": last5,
               "launches_per_step": {k: launches[k] / TRAIN_STEPS
                                     for k in keys}}
    emit("train_phase_paths_off", ok=bool(ok), arch=ARCH,
         phase_paths=False, dtype="bfloat16", batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, steps=TRAIN_STEPS, lr=TRAIN_LR, losses=losses,
         grad_norms=gnorms, first_loss=losses[0], last5_mean_loss=last5,
         step_ms_median_after_3=step_ms,
         tok_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
         first_step_s=out["step_s"][0], wall_s=wall, launches=launches,
         launches_per_step=per_step, fp_plan_chains_at_train_batch=fp_chains,
         step0_vs_per_phase={"loss_rel": loss0_rel,
                             "grad_norm_rel": gn0_rel,
                             "tol_loss_rel": 1e-2,
                             "tol_grad_norm_rel": 5e-2,
                             "per_phase": [per_phase["loss0"],
                                           per_phase["grad_norm0"]]},
         degrades=degrades,
         peak_activation_bytes=out["peak_activation_bytes"],
         peak_source=out["peak_source"])
    if not ok:
        raise AssertionError("train_phase_paths_off phase failed")
    return launches, summary


def phase_paths_twin_phase(torch, fc, arch, steps_lib) -> None:
    """f32: the same weights and batch through ``phase_paths=False`` on
    ``cuda`` (the GEMM and chain kernels' autograd Functions) and
    ``phase_paths=True`` on ``einsum`` (the per-phase plans in torch
    ops): the loss and every parameter's gradient within 1e-4 of its
    scale (sums in other orders), and the backward's GEMMs launched."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    tnn = dataclasses.replace(arch.tnn_default, phase_paths=False)
    model, cfg = steps_lib.build_model(arch, tnn, device=DEVICE, seed=0,
                                       backend="cuda",
                                       compute_dtype=torch.float32)
    twin = backend_twin(model, "einsum", phase_paths=True)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH))
    batch = {k: torch.as_tensor(v).to(DEVICE)
             for k, v in data.batch(0).items()}
    runs = []
    for m in (model, twin):
        before = fc.LAUNCHES["matmul_bwd"]
        loss, _ = m.loss(batch)
        loss.backward()
        torch.cuda.synchronize()
        runs.append((float(loss.detach()),
                     {n: p.grad for n, p in m.named_parameters()},
                     fc.LAUNCHES["matmul_bwd"] - before))
    (la, ga, bwd), (lb, gb, bwd_einsum) = runs
    rel = {n: float((ga[n] - g).abs().max())
           / max(float(g.abs().max()), 1e-30) for n, g in gb.items()}
    loss_rel = abs(la - lb) / abs(lb)
    ok = (max(rel.values()) <= 1e-4 and loss_rel <= 1e-4 and bwd > 0
          and bwd_einsum == 0)
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    emit("phase_paths_twin_f32", ok=ok, arch=ARCH,
         off_cuda_vs_on_einsum={"loss_rel": loss_rel,
                                "max_grad_rel": max(rel.values()),
                                "worst_leaves": worst, "tol_rel": 1e-4},
         params=len(rel), backward_gemm_launches=bwd)
    if not ok:
        raise AssertionError("phase_paths twin failed")


def phase_paths_profile_phase(torch, train_profile, per_phase, pp_off
                              ) -> None:
    """The paper's comparison, reported and not gated: the ATIS bf16
    training step with the per-phase BP/WG plans against autodiff through
    the FP plans, each arm's step ms (the train entry point's runs),
    device busy ms and device events a step (``train_profile``), and the
    port's kernel launches a step."""
    arms = {}
    for name, pp, run in (("per_phase", True, per_phase),
                          ("fp_reuse", False, pp_off)):
        prof = train_profile.profile("bf16", 1.0, ARCH, phase_paths=pp)
        arms[name] = {
            "step_ms": run["step_ms"],
            "profile_wall_ms": prof["wall_ms_per_step"],
            "device_busy_ms": prof["device_busy_ms_per_step"],
            "device_idle_share": prof["device_idle_share"],
            "device_events_per_step": prof["device_events_per_step"],
            "device_ms_by_group": prof["device_ms_per_step_by_group"],
            "device_ms_by_phase": prof["device_ms_per_step_by_phase"],
            "launches_per_step": run["launches_per_step"]}
    emit("phase_paths_compare", ok=True, arch=ARCH, dtype="bfloat16",
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, **arms)


def checkpoint_phase(torch, train_cli, store, host_copy) -> dict:
    """Checkpoints through the train entry point (``paper_atis_tt`` at
    full width, bf16): 10 steps saving every 5, then two fresh runs
    resumed from step 5 alone.  Gates: step 5 and step 10 restore into a
    zeroed template bit for bit equal to what was saved (params, both
    moments, the step); each resumed run starts at 5 and runs 5 steps;
    the resumed losses sit within the run-to-run envelope, measured
    here: the two resumed runs start from the same bits, so their gap is
    the card's own spread (three times it, as the fp8 parity's envelope;
    exact equality where the card repeats itself bit for bit).  Reports
    the host snapshot and the write time and the bytes on disk."""
    import shutil
    import tempfile
    saved = {}
    save = store.save

    def keep(root, step, state, **kw):
        saved[step] = state
        return save(root, step, state, **kw)

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    kw = dict(smoke=False, tnn=True, steps=10, global_batch=TRAIN_BATCH,
              seq_len=TRAIN_SEQ, lr=TRAIN_LR, tnn_backend="cuda",
              device=DEVICE, log_every=5, ckpt_every=5)
    try:
        store.save = keep
        try:
            whole = train_cli.train(ARCH, ckpt_dir=os.path.join(root, "a"),
                                    **kw)
        finally:
            store.save = save
        exact = {}
        for s_ in (5, 10):
            template = host_copy(whole["state"])
            for slot in store.leaf_slots(template):
                for t in slot:
                    t.zero_()
            step, got = store.restore(os.path.join(root, "a"), template,
                                      step=s_)
            pairs = [(a, b) for sa, sb in zip(store.leaf_slots(got),
                                              store.leaf_slots(saved[s_]))
                     for a, b in zip(sa, sb)]
            exact[s_] = step == s_ and all(
                a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs)
        resumed = []
        for run in ("b", "c"):
            d = os.path.join(root, run, "step_00000005")
            shutil.copytree(os.path.join(root, "a", "step_00000005"), d)
            resumed.append(train_cli.train(
                ARCH, ckpt_dir=os.path.join(root, run), **kw))
        # the write on its own: a host snapshot, then store.save
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = host_copy(whole["state"])
        snapshot_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        path = store.save(os.path.join(root, "t"), 10, snap)
        write_s = time.perf_counter() - t0
        disk = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    b, c = (r["losses"] for r in resumed)
    ref_losses = whole["losses"][5:]
    envelope = max(abs(x - y) for x, y in zip(b, c))
    gap = max(abs(x - y) for x, y in zip(b, ref_losses))
    tol = FP8_PARITY_FACTOR * envelope
    within = gap <= tol if envelope > 0 else gap == 0
    ok = (all(exact.values()) and within
          and all(r["start_step"] == 5 and len(r["losses"]) == 5
                  for r in resumed))
    emit("checkpoint", ok=ok, arch=ARCH, steps=10, ckpt_every=5,
         restored_bit_equal={str(k): v for k, v in exact.items()},
         uninterrupted_losses_5_to_9=ref_losses, resumed_losses=[b, c],
         run_to_run_envelope=envelope, resumed_vs_uninterrupted=gap,
         tol=tol, leaves=len(store.leaf_slots(snap)), bytes_on_disk=disk,
         snapshot_s=snapshot_s, write_s=write_s)
    if not ok:
        raise AssertionError("checkpoint phase failed")
    return {"write_s": write_s, "bytes": disk}


def memory_phase(torch, train_cli, memory, arch, per_phase) -> None:
    """The probe and ``--tnn-memory-budget`` on ``paper_atis_tt`` (full
    width, bf16): the ``train`` phase's probe, measured around its first
    step on the card, beside the modeled stash; then the train entry
    point with a budget one byte below the one-microbatch modeled stash:
    the planner must pick >= 2 microbatches, the run must train (finite,
    the last 5 below the first) and its measured peak must be below the
    one-microbatch run's."""
    import numpy as np
    cfg = arch.model(arch.tnn_default)
    one = memory.stash_report(cfg, TRAIN_BATCH, TRAIN_SEQ)
    budget = one.peak_bytes - 1
    out = train_cli.train(ARCH, smoke=False, tnn=True, steps=TRAIN_STEPS,
                          global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                          lr=TRAIN_LR, tnn_backend="cuda", device=DEVICE,
                          log_every=5, tnn_memory_budget=budget)
    losses = out["losses"]
    last5 = statistics.mean(losses[-5:])
    measured_one = per_phase["peak_activation_bytes"]
    ok = (per_phase["peak_source"].startswith("measured:")
          and out["peak_source"].startswith("measured:")
          and out["microbatches"] >= 2
          and all(np.isfinite(losses)) and last5 < losses[0]
          and out["peak_activation_bytes"] < measured_one)
    emit("memory", ok=bool(ok), arch=ARCH,
         one_microbatch={"measured_peak_bytes": measured_one,
                         "source": per_phase["peak_source"],
                         "modeled_stash_bytes": one.peak_bytes,
                         "measured_over_modeled":
                             measured_one / one.peak_bytes},
         budget_bytes=budget, planned_microbatches=out["microbatches"],
         budget_run={"measured_peak_bytes": out["peak_activation_bytes"],
                     "source": out["peak_source"],
                     "modeled_stash_bytes": out["modeled_activation_bytes"],
                     "losses": losses, "first_loss": losses[0],
                     "last5_mean_loss": last5,
                     "step_ms_median_after_3":
                         statistics.median(out["step_s"][3:]) * 1e3})
    if not ok:
        raise AssertionError("memory phase failed")


def expert_plan_ops(cfg, plan_compiler, profiles, tensorized, tokens,
                    phases=("fp", "bp", "wg")):
    """The compiled plan ops a MoE model's expert layers run at an
    expert's token batch ``tokens`` (its slots over every group), as
    ``(runs a layer, phase, op)``: the ``d_model -> d_ff_expert`` plans
    run twice a layer (gate and up), the ``d_ff_expert -> d_model`` ones
    once (down)."""
    m = cfg.moe
    runs = {}
    for d_in, d_out in ((cfg.d_model, m.d_ff_expert),
                        (cfg.d_model, m.d_ff_expert),
                        (m.d_ff_expert, cfg.d_model)):
        runs[(d_in, d_out)] = runs.get((d_in, d_out), 0) + 1
    out = []
    for _, d_in, d_out in profiles.tensorized_projections(cfg):
        layer = tensorized.make_tensorized_linear(
            d_out, d_in, cfg.tnn, compute_dtype=cfg.compute_dtype,
            device="meta", num_experts=m.num_experts)
        for phase, results in tensorized.phase_plans(
                layer.fact, tokens, layer.opts).items():
            if phase not in phases:
                continue
            for r in results:
                compiled = plan_compiler.compile_cached(
                    r.plan, fuse=layer.opts.fused_chain,
                    max_chain_len=layer.opts.max_chain_len)
                out.extend((runs[(d_in, d_out)], phase, op)
                           for op in compiled.ops)
    return out


def expert_geometries(plan_compiler, ops):
    """GEMM ``(m, n, k, transpose_rhs)`` and chain ``(m0, link_shapes)``
    geometries (``{geometry: phases}``) of :func:`expert_plan_ops`' ops,
    and how many lower to ``EinsumOp``."""
    gemms, chains, einsum_ops = {}, {}, 0
    for _, phase, op in ops:
        if isinstance(op, plan_compiler.GemmOp):
            m = op.mat
            gemms.setdefault((m.m, m.n, m.k, m.transpose_rhs),
                             set()).add(phase)
        elif isinstance(op, plan_compiler.ChainOp):
            chains.setdefault((op.m0, op.link_shapes), set()).add(phase)
        else:
            einsum_ops += 1
    return gemms, chains, einsum_ops


def expert_launches_per_step(fc, plan_compiler, ops, cfg) -> dict:
    """The batched launches one training step of the expert layers makes,
    by launch key, as the compiled plans predict: each layer's FP plans
    twice under remat (forward and the checkpoint re-run), BP and WG
    once; a GEMM whose ``gemm_config`` splits K also launches its
    reduce."""
    n = {"matmul_batched": 0, "matmul_batched_reduce": 0,
         "chain_n_batched": 0}
    for runs, phase, op in ops:
        times = runs * (2 if phase == "fp" and cfg.remat else 1)
        if isinstance(op, plan_compiler.GemmOp):
            m = op.mat
            n["matmul_batched"] += times
            if fc.gemm_config(m.m, m.n, m.k, cfg.compute_dtype,
                              m.transpose_rhs).splits > 1:
                n["matmul_batched_reduce"] += times
        elif isinstance(op, plan_compiler.ChainOp):
            n["chain_n_batched"] += times
    return {k: v * cfg.num_layers for k, v in n.items()}


def olmoe_kernel_phase(torch, fc, fa, ref, plan_compiler, profiles,
                       tensorized, cfg, totals) -> dict:
    """``olmoe_kernels``: the batched GEMM (bf16, f32; split-K where
    ``gemm_config`` splits) at every geometry of the expert layers'
    training FP/BP/WG plans (an expert's batch: 8 groups x capacity 24)
    and of their serving FP plans (decode and prefill chunk alike: 4
    groups x capacity 8), all 64 experts in one launch, each expert held
    to the tolerance at its own scale; the batched chain at the rank-8
    expert plans, where chains fuse (none does at rank 64); the
    attention kernel at the training shape (B 8, T 128, H = KV = 16, D
    128, causal, one kv chunk of 128).  Returns the training plans'
    ``EinsumOp`` count and the per-step launches they predict."""
    E = cfg.moe.num_experts
    cap = profiles.expert_tokens
    t_tok = cap(cfg, TRAIN_BATCH, TRAIN_SEQ)
    s_tok = {cap(cfg, BATCH, 1), cap(cfg, BATCH, CHUNK),
             cap(cfg, BATCH, PROMPT)}
    t_ops = expert_plan_ops(cfg, plan_compiler, profiles, tensorized, t_tok)
    t_gemms, t_chains, einsum_ops = expert_geometries(plan_compiler,
                                                      t_ops)
    kernel_phase(torch, fc, ref, sorted(t_gemms), sorted(t_chains), totals,
                 path="train_olmoe", phases={**t_gemms, **t_chains},
                 batch=E, time_dtypes=("bfloat16",))
    s_gemms, s_chains = {}, {}
    for tok in sorted(s_tok):
        g, c, _ = expert_geometries(plan_compiler, expert_plan_ops(
            cfg, plan_compiler, profiles, tensorized, tok, ("fp",)))
        s_gemms.update(g)
        s_chains.update(c)
    kernel_phase(torch, fc, ref,
                 sorted(g for g in s_gemms if g not in t_gemms),
                 sorted(c for c in s_chains if c not in t_chains), totals,
                 path="serve_olmoe", batch=E, time_dtypes=("bfloat16",))
    r_cfg = dataclasses.replace(cfg, tnn=dataclasses.replace(
        cfg.tnn, rank=OLMOE_CHAIN_RANK))
    r_ops = expert_plan_ops(r_cfg, plan_compiler, profiles, tensorized,
                            t_tok)
    _, r_chains, _ = expert_geometries(plan_compiler, r_ops)
    kernel_phase(torch, fc, ref, [], sorted(r_chains), totals,
                 path="train_olmoe_rank8", phases=r_chains, batch=E,
                 time_dtypes=("bfloat16",))
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    flash_case(torch, fa, ref, gen,
               (TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads, cfg.num_kv_heads,
                cfg.hd, True),
               dict(q_chunk=min(cfg.q_chunk, TRAIN_SEQ),
                    kv_chunk=min(cfg.kv_chunk, TRAIN_SEQ)), totals,
               path="train_olmoe")
    per_step = expert_launches_per_step(fc, plan_compiler, t_ops, cfg)
    r_per_step = expert_launches_per_step(
        fc, plan_compiler, r_ops,
        dataclasses.replace(r_cfg, num_layers=STATE_LAYERS))
    splits = sorted({fc.gemm_config(m, n, k, torch.bfloat16, t).splits
                     for m, n, k, t in t_gemms})
    paths = ("train_olmoe", "serve_olmoe", "train_olmoe_rank8")
    emit("olmoe_kernels", ok=True, arch=OLMOE_ARCH, experts=E,
         expert_tokens={"train": t_tok, "serve": sorted(s_tok)},
         tnn_rank=cfg.tnn.rank, chain_rank=OLMOE_CHAIN_RANK,
         train_geometries={"gemm": len(t_gemms), "chain": len(t_chains),
                           "einsum_ops": einsum_ops},
         serve_geometries={"gemm": len(s_gemms), "chain": len(s_chains)},
         rank8_chains=[[m0, [list(x) for x in sh]]
                       for m0, sh in sorted(r_chains)],
         gemm_splits_seen=splits,
         launches_per_train_step_predicted=per_step,
         rank8_launches_per_train_step_predicted=r_per_step,
         sums={name: {path: {k: (sorted(v) if isinstance(v, set) else v)
                             for k, v in totals[name][path].items()}
                      for path in paths if path in totals[name]}
               for name in ALL_KERNELS})
    if not t_gemms or not r_chains or max(splits) < 2:
        raise AssertionError("olmoe_kernels: a batched form went unchecked")
    return {"einsum_ops": einsum_ops, "per_step": per_step,
            "rank8_per_step": r_per_step}


def olmoe_fp8_plan_ops(cfg, plan_compiler, profiles, tensorized,
                      QuantPolicy, tokens):
    """The compiled quantized plans a MoE model's expert layers run under
    ``FP8_POLICY`` at ``tokens``, one group's slots of an expert (the
    reference's vmap runs each (expert, group) instance at that batch):
    ``[(runs a layer, phase, compiled, leads)]`` with ``leads`` each
    plan slot's instance axes, 2 for an instance's tensor (x, dY, dW and
    what they reach) and 1 for an expert's (its cores and their
    products)."""
    tnn = dataclasses.replace(cfg.tnn,
                              precision=QuantPolicy.parse(FP8_POLICY))
    m = cfg.moe
    runs = {(cfg.d_model, m.d_ff_expert): 2, (m.d_ff_expert, cfg.d_model): 1}
    out = []
    for _, d_in, d_out in profiles.tensorized_projections(cfg):
        layer = tensorized.make_tensorized_linear(
            d_out, d_in, tnn, compute_dtype=cfg.compute_dtype,
            device="meta", num_experts=m.num_experts)
        for phase, results in tensorized.phase_plans(
                layer.fact, tokens, layer.opts).items():
            for r in results:
                compiled = plan_compiler.compile_cached(
                    r.plan, fuse=layer.opts.fused_chain,
                    max_chain_len=layer.opts.max_chain_len,
                    policy=layer.precision)
                net = r.plan.network
                leads = {i: 2 if net.node_names[i] in ("X", "dY", "dW")
                         else 1 for i in range(net.num_nodes)}
                for op in compiled.ops:
                    reads = plan_compiler._op_reads(op)
                    out_slot = (op.steps[-1].out
                                if isinstance(op, plan_compiler.ChainOp)
                                else op.step.out)
                    leads[out_slot] = max(leads[s_] for s_ in reads)
                out.append((runs[(d_in, d_out)], phase, compiled, leads))
    return out


def olmoe_fp8_geometries(plan_compiler, plans):
    """Every geometry of :func:`olmoe_fp8_plan_ops`' plans, each
    ``{geometry: phases}``: scaled GEMMs ``(m, n, k, transpose_rhs,
    lhs lead, rhs lead)``, scaled chains ``(m0, link_shapes, leads)``,
    quantized input nodes and dequantized outputs ``(lead, elements an
    instance)``, and the op results requantized per instance ``{(lead,
    shape, perm): phases}`` (the result as its kernel leaves it); and
    the ``EinsumOp`` count."""
    geo = {"gemm": {}, "chain": {}, "quantize": {}, "dequantize": {},
           "requantize": {}}
    einsum_ops = 0
    for _, phase, compiled, leads in plans:
        net = compiled.plan.network
        sizes = net.sizes
        for i in range(net.num_nodes):
            geo["quantize"].setdefault(
                (leads[i], math.prod(net.node_shape(i))), set()).add(phase)
        last = compiled.plan.steps[-1].out
        geo["dequantize"].setdefault(
            (leads[last], math.prod(sizes[a] for a in net.output)),
            set()).add(phase)
        for op in compiled.ops:
            if isinstance(op, plan_compiler.GemmOp):
                mt = op.mat
                geo["gemm"].setdefault(
                    (mt.m, mt.n, mt.k, mt.transpose_rhs,
                     leads[op.step.lhs], leads[op.step.rhs]),
                    set()).add(phase)
                axes, perm, out_slot = (mt.m_axes + mt.n_axes, mt.out_perm,
                                        op.step.out)
            elif isinstance(op, plan_compiler.ChainOp):
                geo["chain"].setdefault(
                    (op.m0, op.link_shapes,
                     tuple(leads[s_] for s_ in plan_compiler._op_reads(op))),
                    set()).add(phase)
                axes, perm, out_slot = (op.m_axes + op.n_axes, op.out_perm,
                                        op.steps[-1].out)
            else:
                einsum_ops += 1
                continue
            geo["requantize"].setdefault(
                (leads[out_slot], tuple(sizes[a] for a in axes), perm),
                set()).add(phase)
    return geo, einsum_ops


def olmoe_fp8_launches_per_step(fc, qk, plan_compiler, plans, cfg,
                                dtype) -> dict:
    """The launches one fp8 training step of the expert layers makes, by
    launch key, as the compiled quantized plans predict (FP twice under
    remat, BP and WG once): per plan op one batched scaled GEMM (and its
    reduce where the instance's ``gemm_config`` splits K) or chain and
    one batched requantize (two launches above
    ``REQUANT_ONE_LAUNCH_MAX`` elements an instance); per plan one
    quantize launch an input node (the per-row form, an instance a row)
    and one dequantize launch."""
    n = {"matmul_scaled_batched": 0, "matmul_scaled_batched_reduce": 0,
         "chain_n_scaled_batched": 0, "requantize_batched": 0,
         "requantize_batched_amax": 0, "quantize": 0, "dequantize": 0,
         "matmul_batched": 0, "chain_n_batched": 0, "matmul_scaled": 0,
         "chain_n_scaled": 0, "requantize": 0}
    for runs, phase, compiled, _ in plans:
        times = runs * (2 if phase == "fp" and cfg.remat else 1)
        n["quantize"] += times * compiled.plan.network.num_nodes
        n["dequantize"] += times
        sizes = compiled.plan.network.sizes
        for op in compiled.ops:
            if isinstance(op, plan_compiler.GemmOp):
                mt = op.mat
                n["matmul_scaled_batched"] += times
                if fc.gemm_config(mt.m, mt.n, mt.k, dtype,
                                  mt.transpose_rhs).splits > 1:
                    n["matmul_scaled_batched_reduce"] += times
                axes = mt.m_axes + mt.n_axes
            else:
                n["chain_n_scaled_batched"] += times
                axes = op.m_axes + op.n_axes
            n["requantize_batched"] += times
            if math.prod(sizes[a] for a in axes) > qk.REQUANT_ONE_LAUNCH_MAX:
                n["requantize_batched_amax"] += times
    return {k: v * cfg.num_layers for k, v in n.items()}


def olmoe_fp8_kernel_phase(torch, fc, qk, ref, quant, QuantPolicy, cfg,
                           plan_compiler, profiles, tensorized, totals
                           ) -> dict:
    """``olmoe_fp8_kernels``: the instance-batched B3-B6 at every
    geometry of ``olmoe_1b_7b``'s fp8 training plans (full width, TT rank
    64: an instance is one group's 24 slots of one expert, 8 groups x 64
    experts = 512 instances; an expert's cores broadcast over its groups
    with stride 0), in fp8_e4m3, fp8_e5m2 and int8, against the plain
    versions (a loop of the unbatched forms): the scaled GEMM each
    instance within 1e-5 of its own scale (exact f32 products summed in
    another order), the scaled chain each instance by
    ``ref.chain_readback_agreement``, two bf16 ulps and three instances
    bit-equal to the unbatched kernel (at the rank-8 plans, where chains
    fuse; none does at rank 64), the per-instance
    quantize (the per-row
    form on ``[I, -1]``), dequantize and batched requantize bit for bit,
    scales included.  Timed in fp8_e4m3 beside the plain loop and the
    bound (bytes at 3.35 TB/s: each input once, an expert's cores once
    for all its groups; operations at the fp8 peak).  Returns the plans'
    ``EinsumOp`` count and the launches a step they predict (full
    rank at OLMOE_FP8_LAYERS, and the rank-8 two-layer run's)."""
    E = cfg.moe.num_experts
    G = TRAIN_BATCH
    C = profiles.expert_tokens(cfg, 1, TRAIN_SEQ)
    plans = olmoe_fp8_plan_ops(cfg, plan_compiler, profiles, tensorized,
                               QuantPolicy, C)
    geo, einsum_ops = olmoe_fp8_geometries(plan_compiler, plans)
    r_cfg = dataclasses.replace(cfg, tnn=dataclasses.replace(
        cfg.tnn, rank=OLMOE_CHAIN_RANK), num_layers=STATE_LAYERS)
    r_plans = olmoe_fp8_plan_ops(r_cfg, plan_compiler, profiles,
                                 tensorized, QuantPolicy, C)
    r_geo, r_einsum = olmoe_fp8_geometries(plan_compiler, r_plans)
    gen = torch.Generator(device=DEVICE).manual_seed(28)
    shape_of = {2: (E, G), 1: (E,)}

    def kernel_ms(fn):
        # 25 calls: the largest geometries move GBs a call
        return device_ms(torch, fn, inner=5, reps=5)

    def plain_ms(fn):
        # the plain GEMM and chain are loops of 512 instances: one warm-up
        # call, then one call captured and replayed twice
        return device_ms(torch, fn, inner=1, reps=2, warmups=1)

    def rand(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=DEVICE) * scale

    def bits(t):
        return t.contiguous().reshape(-1).view(torch.uint8)

    def wide(t, lead, to):
        """An expert's tensor (lead 1) broadcast over the groups."""
        if lead == to:
            return t
        return t.unsqueeze(1).expand((E, G) + tuple(t.shape[1:]))

    def per_instance_ok(got, want, lead, tol_rel):
        err = (got - want).abs().flatten(lead).amax(-1)
        scale = want.abs().flatten(lead).amax(-1)
        return bool((err <= tol_rel * scale).all()), float(err.max()), \
            float(scale.max())

    def account(name, path, err, timed):
        t = totals[name]
        t["max_abs_err"] = max(t["max_abs_err"], err)
        if timed is not None:
            add_total(t.setdefault(path, new_totals()), *timed)

    def fail(name, rec):
        emit(f"kernel:{name}", ok=False, **rec)
        raise AssertionError(f"{name} kernel disagrees: {rec}")

    path = "train_olmoe_fp8"
    for dname in QUANT_DTYPES:
        pol = QuantPolicy.parse(dname)
        timing = dname == QUANT_DTYPES[0]
        for (lead, cols), phases in sorted(geo["quantize"].items()):
            rows = math.prod(shape_of[lead])
            x = rand((rows, cols), 3.0).to(cfg.compute_dtype)
            s_ = quant.compute_scale(x.float().abs().amax(-1, keepdim=True),
                                     pol.qmax, pol.margin)
            q = qk.quantize_cuda(x, s_, pol)
            d = qk.dequantize_cuda(q, s_)
            rec = {"path": path, "instances": rows, "cols": cols,
                   "lead": lead, "phases": sorted(phases), "dtype": dname,
                   "form": "per_row", "bit_exact": torch.equal(
                       bits(q), bits(ref.quantize(x, s_, pol)))}
            if not rec["bit_exact"]:
                fail("quantize", rec)
            timed = None
            if timing:
                ms = kernel_ms(lambda: qk.quantize_cuda(x, s_, pol))
                plain = plain_ms(lambda: ref.quantize(x, s_, pol))
                b, by = bound_ms(rows * cols * 3 + 4 * rows, 3 * rows * cols,
                                 "float32")
                timed = (ms, plain, None, b, by)
                rec.update(ms=ms, plain_ms=plain, library_ms=None,
                           bound_ms=b, bound_by=by)
            emit("kernel:quantize", ok=True, **rec)
            account("quantize", path, 0.0, timed)
        for (lead, cols), phases in sorted(geo["dequantize"].items()):
            rows = math.prod(shape_of[lead])
            t, s_ = ref.requantize(rand((rows, cols), 3.0), pol, 1)
            s_ = s_.reshape(rows, 1)
            got = qk.dequantize_cuda(t, s_)
            rec = {"path": path, "instances": rows, "cols": cols,
                   "lead": lead, "phases": sorted(phases), "dtype": dname,
                   "form": "per_row", "bit_exact": torch.equal(
                       bits(got), bits(ref.dequantize(t, s_)))}
            if not rec["bit_exact"]:
                fail("dequantize", rec)
            timed = None
            if timing:
                ms = kernel_ms(lambda: qk.dequantize_cuda(t, s_))
                plain = plain_ms(lambda: ref.dequantize(t, s_))
                b, by = bound_ms(rows * cols * 5 + 4 * rows, rows * cols,
                                 "float32")
                timed = (ms, plain, None, b, by)
                rec.update(ms=ms, plain_ms=plain, library_ms=None,
                           bound_ms=b, bound_by=by)
            emit("kernel:dequantize", ok=True, **rec)
            account("dequantize", path, 0.0, timed)
        inter = dataclasses.replace(pol, granularity="tensor")
        for (lead, shape, perm), phases in sorted(
                geo["requantize"].items(), key=str):
            x = rand(shape_of[lead] + shape, 3.0)
            if perm is not None:
                x = x.permute(tuple(range(lead))
                              + tuple(p_ + lead for p_ in perm))
            gq, gs = qk.requantize_cuda(x, pol, lead)
            wq, ws = ref.requantize(x, pol, lead)
            n = math.prod(shape)
            rec = {"path": path, "lead": lead, "instances":
                   math.prod(shape_of[lead]), "numel_per_instance": n,
                   "shape": list(x.shape), "permuted": perm is not None,
                   "phases": sorted(phases), "dtype": dname,
                   "launches_per_call": qk.requantize_launches(n),
                   "bit_exact": (torch.equal(bits(gq), bits(wq))
                                 and torch.equal(bits(gs), bits(ws))),
                   "strides_match": gq.stride() == wq.stride(),
                   "torch_ops_scale_bit_equal": torch.equal(
                       bits(gs), bits(quant.quantize(x, inter,
                                                     lead=lead).scale))}
            if not (rec["bit_exact"] and rec["strides_match"]
                    and rec["torch_ops_scale_bit_equal"]):
                fail("requantize_batched", rec)
            timed = None
            if timing:
                ms = kernel_ms(lambda: qk.requantize_cuda(x, pol, lead))
                plain = plain_ms(lambda: ref.requantize(x, pol, lead))
                total = x.numel()
                b, by = bound_ms(5 * total + 4 * total // n, 4 * total,
                                 "float32")
                timed = (ms, plain, None, b, by)
                rec.update(ms=ms, plain_ms=plain, library_ms=None,
                           bound_ms=b, bound_by=by)
            emit("kernel:requantize_batched", ok=True, **rec)
            account("requantize_batched", path, 0.0, timed)
        for (m, n, k, trans, ll, lr), phases in sorted(geo["gemm"].items()):
            lead = max(ll, lr)
            qx = quant.quantize(rand(shape_of[ll] + (m, k)), pol, lead=ll)
            qw = quant.quantize(rand(shape_of[lr] + ((n, k) if trans
                                                     else (k, n))),
                                pol, lead=lr)
            x, w = wide(qx.q, ll, lead), wide(qw.q, lr, lead)
            sl, sr = wide(qx.scale, ll, lead), wide(qw.scale, lr, lead)
            got = fc.matmul_cuda(x, w, transpose_rhs=trans, scales=(sl, sr))
            want = ref.matmul_scaled(x, w, sl, sr, transpose_rhs=trans)
            torch.cuda.synchronize()
            ok, err, scale = per_instance_ok(got, want, lead, 1e-5)
            rec = {"path": path, "m": m, "n": n, "k": k,
                   "transpose_rhs": trans, "leads": [ll, lr],
                   "instances": math.prod(shape_of[lead]),
                   "phases": sorted(phases), "dtype": dname,
                   "max_abs_err": err, "scale": scale,
                   "tol": "1e-5 of each instance's scale",
                   "config": gemm_config_rec(fc, x, w, trans)}
            if not ok:
                fail("matmul_scaled_batched", rec)
            timed = None
            if timing:
                inst = math.prod(shape_of[lead])
                ms = kernel_ms(lambda: fc.matmul_cuda(
                    x, w, transpose_rhs=trans, scales=(sl, sr)))
                plain = plain_ms(lambda: ref.matmul_scaled(
                    x, w, sl, sr, transpose_rhs=trans))
                b, by = bound_ms(
                    qx.q.numel() + qw.q.numel() + 4 * (qx.scale.numel()
                                                       + qw.scale.numel())
                    + 4 * inst * m * n, 2 * inst * m * n * k, "fp8")
                timed = (ms, plain, None, b, by)
                rec.update(ms=ms, plain_ms=plain, library_ms=None,
                           library_note="no PyTorch call computes a "
                           "batched scaled GEMM with per-instance scales",
                           bound_ms=b, bound_by=by)
            emit("kernel:matmul_scaled_batched", ok=True, **rec)
            account("matmul_scaled_batched", path, err, timed)
        for (m0, shapes, leads), phases in sorted(r_geo["chain"].items()):
            lead = max(leads)
            qx = quant.quantize(rand(shape_of[leads[0]]
                                     + (m0, shapes[0][0])), pol,
                                lead=leads[0])
            qws = [quant.quantize(rand(shape_of[li] + s_), pol, lead=li)
                   for li, s_ in zip(leads[1:], shapes)]
            x = wide(qx.q, leads[0], lead)
            ws = [wide(w.q, li, lead) for w, li in zip(qws, leads[1:])]
            sc = [wide(t.scale, li, lead) for t, li in zip([qx, *qws],
                                                          leads)]
            scales = (sc[0] * sc[1], *sc[2:])
            got = fc.chain_n_cuda(x, ws, scales=scales)
            want = ref.chain_n_scaled(x, ws, scales)
            torch.cuda.synchronize()
            gw = got.flatten(0, lead - 1)
            ww = want.flatten(0, lead - 1)
            checks = [ref.chain_scaled_agreement(a, b_)
                      for a, b_ in zip(gw, ww)]
            good, readback = ref.chain_readback_agreement(
                fc.chain_n_cuda, x, ws, scales)
            # The batch indexing changes no sum: three instances launched
            # alone through the unbatched kernel equal the batched output
            # bit for bit.
            alone = []
            for e_, g_ in ((0, 0), (E // 2, 1), (E - 1, G - 1)):
                one = fc.chain_n_cuda(
                    x[e_, g_], [w[e_, g_] for w in ws],
                    scales=(scales[0][e_, g_].expand(m0, 1).contiguous(),
                            scales[1][e_, g_].expand(
                                1, shapes[-1][1]).contiguous()))
                alone.append(torch.equal(one, got[e_, g_]))
            readback["unbatched_bit_equal"] = alone
            good = good and all(alone) and all(
                c_[1]["max_abs_err"] <= c_[1]["tol_abs"] for c_ in checks)
            err = max(c_[1]["max_abs_err"] for c_ in checks)
            rows, _ = fc.chain_plan(m0, shapes)
            rec = {"path": "train_olmoe_fp8_rank8", "m0": m0,
                   "links": [list(s_) for s_ in shapes],
                   "leads": list(leads), "instances": len(checks),
                   "phases": sorted(phases), "dtype": dname,
                   **chain_config_rec(fc, x, ws), "max_abs_err": err,
                   "rule": "chain_readback_agreement per instance, and "
                   "no element beyond two bf16 ulps of its scale",
                   "readback": readback,
                   "elements_rule_passed": sum(c_[0] for c_ in checks),
                   "worst": max((c_[1] for c_ in checks),
                                key=lambda d: d["share_beyond_1e-5"])}
            if not good:
                fail("chain_n_scaled_batched", rec)
            timed = None
            if timing:
                inst = len(checks)
                ms = kernel_ms(lambda: fc.chain_n_cuda(x, ws, scales=scales))
                plain = plain_ms(lambda: ref.chain_n_scaled(x, ws, scales))
                nbytes = (qx.q.numel() + sum(w.q.numel() for w in qws)
                          + 4 * sum(s_.numel() for s_ in sc)
                          + 4 * inst * rows[-1] * shapes[-1][1])
                flops = inst * sum(2 * r * a * c for r, (a, c)
                                   in zip(rows, shapes))
                b, by = bound_ms(nbytes, flops, "fp8")
                timed = (ms, plain, None, b, by)
                rec.update(ms=ms, plain_ms=plain, library_ms=None,
                           bound_ms=b, bound_by=by)
            emit("kernel:chain_n_scaled_batched", ok=True, **rec)
            account("chain_n_scaled_batched", "train_olmoe_fp8_rank8", err,
                    timed)
    dtype = QuantPolicy.parse(FP8_POLICY).operand_dtype
    per_step = olmoe_fp8_launches_per_step(
        fc, qk, plan_compiler, plans,
        dataclasses.replace(cfg, num_layers=OLMOE_FP8_LAYERS), dtype)
    r_per_step = olmoe_fp8_launches_per_step(fc, qk, plan_compiler, r_plans,
                                             r_cfg, dtype)
    emit("olmoe_fp8_kernels", ok=True, arch=OLMOE_ARCH, experts=E,
         groups=G, slots_per_instance=C, instances=E * G,
         tnn_rank=cfg.tnn.rank, chain_rank=OLMOE_CHAIN_RANK,
         geometries={k: len(v) for k, v in geo.items()},
         rank8_chains=len(r_geo["chain"]), einsum_ops=einsum_ops,
         launches_per_train_step_predicted=per_step,
         rank8_launches_per_train_step_predicted=r_per_step,
         sums={name: {p_: {k: (sorted(v) if isinstance(v, set) else v)
                           for k, v in totals[name][p_].items()}
                      for p_ in (path, "train_olmoe_fp8_rank8")
                      if p_ in totals[name]}
               for name in ALL_KERNELS})
    if not geo["gemm"] or not r_geo["chain"] or einsum_ops or r_einsum:
        raise AssertionError("olmoe_fp8_kernels: a batched form went "
                             "unchecked, or a plan lowers to einsum")
    return {"per_step": per_step, "rank8_per_step": r_per_step}


def routing_agreement(torch, models: dict, batch) -> dict:
    """How far the same batch through ``models`` (``{"cuda": ...,
    "einsum": ...}``, same weights) routes alike, each MoE layer's top-k
    picks recorded by a hook on its input: ``share``, the (token, k)
    picks the other backend also made (the expert is among the token's
    k there: the routing a token gets), and ``ordered_share``, those
    naming the same expert at the same rank k (a swap of two near-equal
    picks within the top k counts twice here, though both still reach
    their token)."""
    picks = {}
    for name, model in models.items():
        seen, hooks = [], []
        for layer in model.layers:
            moe = layer.mlp

            def hook(mod, args, seen=seen):
                probs = torch.softmax(mod.router(args[0].float()), -1)
                seen.append(torch.topk(probs, mod.top_k, dim=-1).indices)
            hooks.append(moe.register_forward_pre_hook(hook))
        try:
            with torch.no_grad():
                model(torch.as_tensor(batch["inputs"]).to(DEVICE))
        finally:
            for h in hooks:
                h.remove()
        picks[name] = seen
    a, b = picks["cuda"], picks["einsum"]
    made = [(x[..., :, None] == y[..., None, :]).any(-1) for x, y in zip(a, b)]
    count = sum(x.numel() for x in a)
    return {
        "share": sum(float(m.sum()) for m in made) / count,
        "per_layer": [float(m.float().mean()) for m in made],
        "ordered_share": sum(float((x == y).sum())
                             for x, y in zip(a, b)) / count,
        "ordered_per_layer": [float((x == y).float().mean())
                              for x, y in zip(a, b)]}


def serve_olmoe_phase(torch, fc, plan_compiler, tm, steps_lib, profiles,
                      arch, ServeEngine, Request):
    """``olmoe_1b_7b`` at full width, OLMOE_SERVE_LAYERS of its 16
    layers (``--tnn``'s default, ``cuda`` backend, bf16) through
    ``ServeEngine`` (its native
    ``extend``: each slot one token group) at the serve CLI's defaults:
    every request completes, the batched GEMM launched, no runtime
    degrade; tok/s and tick times.  Returns the run's launches and the
    model (for the training profile)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tnn = dataclasses.replace(arch.tnn_default, backend="cuda")
    model, cfg = steps_lib.build_model(arch, tnn, device=DEVICE, seed=0,
                                       num_layers=OLMOE_SERVE_LAYERS)
    prof = profiles.build_profiles(cfg, batch_size=BATCH,
                                   prefill_chunk=CHUNK)
    fc.reset_launches()
    plan_compiler.reset_degrade_counts()
    done, secs, engine = run_engine(torch, model, cfg.vocab, ServeEngine,
                                    Request)
    launches = dict(fc.LAUNCHES)
    degrades = dict(plan_compiler.DEGRADE_COUNTS)
    tick_ms = tick_spans_ms(torch, tm, model, cfg.vocab, ServeEngine,
                            Request)
    tokens = sum(len(r.out_tokens) for r in done)
    ok = (len(done) == REQUESTS
          and all(len(r.out_tokens) == MAX_NEW for r in done)
          and launches["matmul_batched"] > 0 and launches["matmul"] == 0
          and degrades["runtime"] == 0 and bool(tick_ms["decode"]))
    emit("serve_olmoe", ok=bool(ok), arch=OLMOE_ARCH, d_model=cfg.d_model,
         layers=cfg.num_layers, experts=cfg.moe.num_experts,
         top_k=cfg.moe.top_k, requests=len(done), tokens=tokens,
         seconds=secs, tok_per_s=tokens / secs, ticks=engine.tick,
         expert_tokens={p: v.expert_tokens for p, v in prof.items()},
         prefill_tick_ms=tick_ms["prefill"],
         decode_tick_ms_median=statistics.median(tick_ms["decode"] or [0]),
         decode_ticks=len(tick_ms["decode"]), launches=launches,
         degrades=degrades,
         out_tokens_req0=next(r.out_tokens for r in done if r.rid == 0),
         max_memory_allocated=torch.cuda.max_memory_allocated())
    if not ok:
        raise AssertionError("serve_olmoe phase failed")
    return launches, model


def seamless_kernel_phase(torch, fc, fa, ref, plan_compiler, profiles,
                          tensorized, cfgbase, cfg, totals) -> int:
    """``kernel:seamless``: the kernels at ``seamless_m4t_medium``'s
    main-path shapes (``--tnn``'s default: TT rank 64 on both stacks'
    SwiGLU).  The GEMM (and the chain, where a plan fuses one) at every
    geometry of the training step's FP/BP/WG plans (both stacks at 8 x 128
    tokens) and of the serving FP plans (the encoder at 4 x 1024 frames,
    the decoder's prefill at 4 x 16 tokens and decode at 4), checked in
    bf16 and f32 and timed in bf16, as in phase 2; the attention kernel at
    every ``SEAMLESS_FLASH`` shape (non-causal in the encoder and the
    cross-attention, whose queries and keys come from two sequences, down
    to one query against 1,024 keys a decode step), as in phase 3, and
    off the main path at ``llava_next_34b``'s training shape.  Returns the
    training plans' ``EinsumOp`` count."""
    gemms, chains, einsum_ops = train_path_geometries(
        cfg, plan_compiler, profiles, tensorized)
    kernel_phase(torch, fc, ref, sorted(gemms), sorted(chains), totals,
                 path="train_seamless", phases={**gemms, **chains},
                 time_dtypes=("bfloat16",))
    s_gemms, s_chains = main_path_geometries(
        cfg, plan_compiler, profiles, tensorized,
        token_batches=(BATCH * ENC_FRAMES, BATCH * PROMPT, BATCH))
    kernel_phase(torch, fc, ref, s_gemms, s_chains, totals,
                 path="serve_seamless", time_dtypes=("bfloat16",))
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.hd)
    for path, role, b, tq, tk, causal, qc, kc in SEAMLESS_FLASH:
        flash_case(torch, fa, ref, gen, (b, tq, *heads, causal),
                   dict(q_chunk=qc, kv_chunk=kc), totals, path=path, tk=tk,
                   role=role)
    c = cfgbase.get(LLAVA_ARCH).model()
    t = TRAIN_SEQ
    flash_case(torch, fa, ref, gen,
               (TRAIN_BATCH, t, c.num_heads, c.num_kv_heads, c.hd, True),
               dict(q_chunk=min(c.q_chunk, t), kv_chunk=min(c.kv_chunk, t)),
               totals, role=f"{LLAVA_ARCH} train (off the main path)")
    paths = ("train_seamless", "serve_seamless")
    emit("kernel:seamless", ok=True, arch=SEAMLESS_ARCH,
         tnn_targets=list(cfg.tnn.targets), tnn_rank=cfg.tnn.rank,
         train_geometries={"gemm": len(gemms), "chain": len(chains),
                           "einsum_ops": einsum_ops},
         serve_geometries={"gemm": len(s_gemms), "chain": len(s_chains)},
         sums={name: {path: {k: (sorted(v) if isinstance(v, set) else v)
                             for k, v in totals[name][path].items()}
                      for path in paths if path in totals[name]}
               for name in ALL_KERNELS})
    return einsum_ops


def seamless_batches(torch, modality, vocab: int):
    """``make_batch(cfg, step)`` for the encoder-decoder: decoder inputs
    and targets from the train CLI's synthetic data (seed 0, step n),
    encoder frames (in ``cfg``'s compute dtype) from
    ``modality.frame_embeddings`` with a generator seeded by the step,
    TRAIN_BATCH x TRAIN_SEQ of each, on the card."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(vocab=vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH))

    def make_batch(cfg, step):
        b = data.batch(step)
        gen = torch.Generator().manual_seed(step)
        return {"enc_embeds": modality.frame_embeddings(
                    gen, TRAIN_BATCH, TRAIN_SEQ, cfg.d_model,
                    cfg.compute_dtype, DEVICE),
                "dec_inputs": torch.as_tensor(b["inputs"]).to(DEVICE),
                "dec_targets": torch.as_tensor(b["targets"]).to(DEVICE)}
    return make_batch


def seamless_train_run(torch, fc, memory, modality, steps_lib, model, cfg,
                       lr: float, steps: int) -> dict:
    """``steps`` AdamW steps of the encoder-decoder ``model`` through
    ``steps.make_train_step``; the activation peak of step 0 measured
    around it (``memory.measure``).  Returns the losses, grad norms,
    step seconds, the kernels' launches a step and that peak."""
    from repro_torch.optim.adamw import AdamW
    opt = AdamW(lr=lr, total_steps=max(steps, 2), warmup_steps=min(20, steps))
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params)}
    step_fn = steps_lib.make_train_step(model, opt)
    make_batch = seamless_batches(torch, modality, cfg.vocab)
    losses, gnorms, step_s, per_step, probe = [], [], [], [], None
    for i in range(steps):
        batch = make_batch(cfg, i)
        before = dict(fc.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            ran = []
            probe = memory.measure(lambda: ran.append(step_fn(state, batch)))
            state, metrics = ran[0] if ran else step_fn(state, batch)
        else:
            state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])          # waits for the device
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        gnorms.append(float(metrics["grad_norm"]))
        per_step.append({k: fc.LAUNCHES[k] - before[k]
                         for k in ("matmul", "matmul_reduce", "chain_n",
                                   "flash_attention_fwd")})
    del state, opt
    for p in params.values():
        p.grad = None
    return {"losses": losses, "grad_norms": gnorms, "step_s": step_s,
            "per_step": per_step, "probe": probe}


def train_seamless_phase(torch, fc, plan_compiler, memory, modality,
                         steps_lib, arch, einsum_ops):
    """``seamless_m4t_medium`` at full width and depth (``--tnn``'s
    default, ``cuda`` backend, bf16, remat; SEAMLESS_PARAMS parameters,
    asserted on the card) through ``steps.make_train_step``, SEAMLESS_STEPS
    steps at SEAMLESS_LR on :func:`seamless_batches`: every loss finite,
    the mean of the last 5 below the first, on every step the GEMM kernel
    and the attention kernel twice per attention (12 encoder, 12 decoder
    and 12 cross-attentions, forward and the checkpoint re-run), no
    ``EinsumOp`` in the plans, no runtime degrade; its step time, decoder
    tok/s, peak device memory and step 0's measured activation peak.
    Returns the run's launches and the trained model (served next)."""
    import numpy as np
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tnn = dataclasses.replace(arch.tnn_default, backend="cuda")
    t0 = time.perf_counter()
    model, cfg = steps_lib.build_model(arch, tnn, device=DEVICE, seed=0)
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    fc.reset_launches()
    plan_compiler.reset_degrade_counts()
    run = seamless_train_run(torch, fc, memory, modality, steps_lib, model,
                             cfg, SEAMLESS_LR, SEAMLESS_STEPS)
    torch.cuda.synchronize()
    launches = dict(fc.LAUNCHES)
    degrades = dict(plan_compiler.DEGRADE_COUNTS)
    losses = run["losses"]
    attentions = cfg.num_enc_layers + 2 * cfg.num_dec_layers
    attn_per_step = (2 if cfg.remat else 1) * attentions
    step_ms = statistics.median(run["step_s"][3:]) * 1e3
    last5 = statistics.mean(losses[-5:])
    ok = (n_params == SEAMLESS_PARAMS and all(np.isfinite(losses))
          and len(losses) == SEAMLESS_STEPS and last5 < losses[0]
          and all(s["matmul"] > 0
                  and s["flash_attention_fwd"] == attn_per_step
                  for s in run["per_step"])
          and einsum_ops == 0 and degrades["runtime"] == 0)
    probe = run["probe"]
    emit("train_seamless", ok=bool(ok), arch=SEAMLESS_ARCH,
         d_model=cfg.d_model, enc_layers=cfg.num_enc_layers,
         dec_layers=cfg.num_dec_layers, heads=cfg.num_heads,
         head_dim=cfg.hd, d_ff=cfg.d_ff, vocab=cfg.vocab, params=n_params,
         params_expected=SEAMLESS_PARAMS, remat=cfg.remat,
         tnn_targets=list(cfg.tnn.targets), tnn_rank=cfg.tnn.rank,
         dtype=str(cfg.compute_dtype).split(".")[-1], batch=TRAIN_BATCH,
         enc_frames=TRAIN_SEQ, dec_tokens=TRAIN_SEQ, steps=SEAMLESS_STEPS,
         lr=SEAMLESS_LR, losses=losses, grad_norms=run["grad_norms"],
         first_loss=losses[0], last5_mean_loss=last5,
         step_ms_median_after_3=step_ms,
         dec_tok_per_s=TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
         first_step_s=run["step_s"][0], build_s=build_s,
         launches=launches, launches_per_step=run["per_step"],
         attention_per_step_expected=attn_per_step, degrades=degrades,
         einsum_ops_in_plans=einsum_ops,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         peak_activation_bytes=probe.peak_bytes if probe else None,
         peak_source=probe.source if probe else None)
    if not ok:
        raise AssertionError("train_seamless phase failed")
    return launches, model, cfg


def seamless_route_check(torch, fc, modality, steps_lib):
    """``route_check`` of ``seamless_parity``: in f32, the serve waves'
    first wave (BATCH requests of ENC_FRAMES frames and a PROMPT-token
    prompt) through ``make_prefill_step`` and MAX_NEW - 1 greedy
    ``make_decode_step`` calls, against teacher-forced ``forward`` over
    the prompt and those tokens: the greedy tokens equal ``forward``'s
    argmax at each position, and the last decode logits lie within 1e-4
    of ``forward``'s last row (of its scale)."""
    def check(model, cfg):
        enc, prompts = seamless_wave(torch, modality, cfg, 0)
        prefill = steps_lib.make_prefill_step(model, PROMPT + MAX_NEW)
        decode = steps_lib.make_decode_step(model)
        before = fc.LAUNCHES["flash_attention_fwd"]
        logits, cache = prefill(enc, prompts)
        toks = [logits.float().argmax(-1)]
        while len(toks) < MAX_NEW:
            logits, cache = decode(toks[-1], cache)
            toks.append(logits.float().argmax(-1))
        flash = fc.LAUNCHES["flash_attention_fwd"] - before
        seq = torch.stack(toks, dim=1)
        with torch.no_grad():
            full = model(enc, torch.cat([prompts, seq[:, :-1]], dim=1))
        forced = full[:, PROMPT - 1:].float().argmax(-1)
        last = full[:, -1].float()
        err = (logits.float() - last).abs().max().item()
        scale = last.abs().max().item()
        layers = cfg.num_dec_layers
        return {"equal": bool(torch.equal(seq, forced)) and err <= 1e-4 * scale
                and flash == cfg.num_enc_layers + 2 * layers
                + (MAX_NEW - 1) * layers,
                "greedy_equals_forced": bool(torch.equal(seq, forced)),
                "tokens_req0": seq[0].tolist(),
                "last_logits_max_abs_err": err, "logit_scale": scale,
                "tol": 1e-4 * scale, "attention_launches": flash}
    return check


def seamless_wave(torch, modality, cfg, wave: int):
    """Wave ``wave``'s BATCH requests: encoder frames (a generator seeded
    by the request id) and PROMPT-token prompts (``serve_requests``'s)."""
    import numpy as np

    from repro_torch.serving.engine import Request
    rids = range(wave * BATCH, (wave + 1) * BATCH)
    enc = torch.cat([modality.frame_embeddings(
        torch.Generator().manual_seed(1000 + rid), 1, ENC_FRAMES,
        cfg.d_model, cfg.compute_dtype, DEVICE) for rid in rids])
    reqs = serve_requests(cfg.vocab, Request)
    prompts = torch.as_tensor(np.stack([reqs[rid].prompt for rid in rids]),
                              device=DEVICE).long()
    return enc, prompts


def serve_seamless_phase(torch, fc, plan_compiler, modality, steps_lib,
                         model, cfg) -> dict:
    """``seamless_m4t_medium`` at full width and depth served through
    ``make_prefill_step`` / ``make_decode_step`` (the engine serves no
    encoder-decoder, in the reference neither): SEAMLESS_WAVES waves of
    BATCH requests, each ENC_FRAMES encoder frames and a PROMPT-token
    prompt, then MAX_NEW greedy tokens (the prefill's and MAX_NEW - 1
    decode steps').  Every request must complete, the attention kernel
    launch as the layers predict (a wave: the encoder's 12, the decoder
    prefill's 12 self- and 12 cross-attentions, then 12 cross-attentions
    a decode step), no runtime degrade.  Returns the run's launches."""
    torch.cuda.empty_cache()
    prefill = steps_lib.make_prefill_step(model, PROMPT + MAX_NEW)
    decode = steps_lib.make_decode_step(model)
    fc.reset_launches()
    plan_compiler.reset_degrade_counts()
    per_wave, decode_ms, prefill_ms, done = [], [], [], {}
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for w in range(SEAMLESS_WAVES):
        enc, prompts = seamless_wave(torch, modality, cfg, w)
        before = fc.LAUNCHES["flash_attention_fwd"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(enc, prompts)
        toks = [logits.float().argmax(-1)]
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        while len(toks) < MAX_NEW:
            t0 = time.perf_counter()
            logits, cache = decode(toks[-1], cache)
            toks.append(logits.float().argmax(-1))
            torch.cuda.synchronize()
            decode_ms.append((time.perf_counter() - t0) * 1e3)
        per_wave.append(fc.LAUNCHES["flash_attention_fwd"] - before)
        for i, t in enumerate(torch.stack(toks, dim=1).cpu().tolist()):
            done[w * BATCH + i] = t
    secs = time.perf_counter() - t_all
    launches = dict(fc.LAUNCHES)
    degrades = dict(plan_compiler.DEGRADE_COUNTS)
    L = cfg.num_dec_layers
    expected = cfg.num_enc_layers + 2 * L + (MAX_NEW - 1) * L
    tokens = sum(len(t) for t in done.values())
    ok = (len(done) == SEAMLESS_WAVES * BATCH
          and all(len(t) == MAX_NEW for t in done.values())
          and all(n == expected for n in per_wave)
          and launches["matmul"] > 0 and degrades["runtime"] == 0)
    emit("serve_seamless", ok=bool(ok), arch=SEAMLESS_ARCH,
         enc_layers=cfg.num_enc_layers, dec_layers=L,
         enc_frames=ENC_FRAMES, prompt=PROMPT, new_tokens=MAX_NEW,
         requests=len(done), tokens=tokens, seconds=secs,
         tok_per_s=tokens / secs, prefill_ms=prefill_ms,
         decode_step_ms_median=statistics.median(decode_ms),
         attention_launches_per_wave=per_wave,
         attention_launches_per_wave_expected=expected,
         tokens_req0=done[0], launches=launches, degrades=degrades,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    if not ok:
        raise AssertionError("serve_seamless phase failed")
    return launches


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

    from repro_torch import memory
    from repro_torch import telemetry as tm
    from repro_torch.analysis import train_profile
    from repro_torch.checkpoint import manager as ckpt_manager
    from repro_torch.checkpoint import store as ckpt_store
    from repro_torch.configs import base as cfgbase
    from repro_torch.core import plan_compiler, tensorized
    from repro_torch.kernels import build, fused_contraction as fc, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantized as qk
    from repro_torch.kernels import ssm_scan as sk
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import lm as lm_mod, modality, ssm
    from repro_torch.precision import QuantPolicy, quant
    from repro_torch.launch import train as train_cli
    from repro_torch.serving import kv_cache, profiles
    from repro_torch.serving.engine import Request, ServeEngine

    # -- 1. env ---------------------------------------------------------------
    smi = nvidia_smi()
    t0 = time.perf_counter()
    # Every nvcc starts now; the scan's library, the slowest to build and
    # first needed in phase 11, finishes behind phases 2-10.
    build.start_all()
    build_s = build.build_all(tuple(n for n in build.SOURCES
                                    if n != "ssm_scan"))
    emit("env", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], build_s=build_s,
         build_wall_s=time.perf_counter() - t0)
    filt = os.path.join(os.path.dirname(build.nvcc()), "cu++filt")
    demangler = filt if os.path.exists(filt) else None
    emit("ptxas", ok=True, kernels={
        name: ptxas_report(log, demangler)
        for name, log in build.BUILD_LOGS.items()})

    # -- 2./3. kernels at every main-path geometry ------------------------------
    arch = cfgbase.get(ARCH)
    cfg = arch.model()
    totals = {name: new_totals() for name in ALL_KERNELS}
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
    q_geo, fp8_einsum_ops = fp8_train_geometries(
        cfg, plan_compiler, profiles, tensorized, QuantPolicy)
    quant_kernel_phase(torch, fc, qk, ref, quant, QuantPolicy, q_geo, totals)
    emit("kernel_totals", ok=True, sums={
        name: {path: {k: (sorted(v) if isinstance(v, set) else v)
                      for k, v in t.items()}
               for path, t in totals[name].items() if isinstance(t, dict)}
        for name in ALL_KERNELS},
        timed_in={"bf16 paths": list(KERNELS),
                  "fp8_e4m3": list(QUANT_KERNELS)},
        train_geometries={"gemm": len(t_gemms), "chain": len(t_chains)},
        fp8_train_geometries={k: len(v) for k, v in q_geo.items()})

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
    launches["train"], bf16_last5, per_phase = train_phase(
        torch, fc, plan_compiler, train_cli, train_einsum_ops)

    # -- 7. training parity with the einsum executor ---------------------------
    train_parity_phase(torch, arch, steps_lib)

    # -- 7a. phase_paths=False: the kernels' autograd Functions --------------
    pp_gemms, pp_chains, pp_bwd, pp_other_chains = pp_off_geometries(
        cfg, fc, plan_compiler, profiles, tensorized)
    kernel_phase(torch, fc, ref, pp_gemms, pp_chains, totals,
                 path="pp_off_fwd", time_dtypes=("bfloat16",))
    kernel_phase(torch, fc, ref, sorted(pp_bwd), [], totals,
                 path="pp_off_bwd", phases=pp_bwd, time_dtypes=("bfloat16",))
    autograd_phase(torch, fc, ops, ref, pp_gemms,
                   sorted(set(pp_chains) | set(pp_other_chains)))

    # -- 7b. train through the FP plans, its f32 twin, the comparison --------
    launches["train_phase_paths_off"], pp_off = train_phase_paths_off_phase(
        torch, fc, plan_compiler, train_cli, arch, len(pp_chains), per_phase)
    phase_paths_twin_phase(torch, fc, arch, steps_lib)
    phase_paths_profile_phase(torch, train_profile, per_phase, pp_off)

    # -- 7c. checkpoints and resume; the memory probe and budget -------------
    checkpoint_phase(torch, train_cli, ckpt_store, ckpt_manager.host_copy)
    memory_phase(torch, train_cli, memory, arch, per_phase)

    # -- 9. fp8 training at full width through the precision kernels -----------
    launches["train_fp8"], _, _ = train_phase(
        torch, fc, plan_compiler, train_cli, fp8_einsum_ops,
        name="train_fp8", precision=FP8_POLICY, loss_scale=FP8_LOSS_SCALE,
        bf16_last5=bf16_last5)

    # -- 10. fp8 training parity with the einsum executor ----------------------
    train_fp8_parity_phase(torch, arch, steps_lib, QuantPolicy)

    # -- 11. the scan kernel, then GEMM/chain at rwkv6's plan geometries -------
    t0 = time.perf_counter()
    scan_build_s = build.build_all(("ssm_scan",))
    emit("ptxas", ok=True, build_s=scan_build_s,
         build_wait_s=time.perf_counter() - t0, kernels={
             "ssm_scan": ptxas_report(build.BUILD_LOGS.get("ssm_scan", ""),
                                      demangler)})
    r_arch = cfgbase.get(RWKV_ARCH)
    r_cfg = r_arch.model(r_arch.tnn_default)
    scan_phase(torch, sk, ref, ssm, r_cfg, totals)
    r_gemms, r_chains, r_einsum_ops = train_path_geometries(
        r_cfg, plan_compiler, profiles, tensorized)
    kernel_phase(torch, fc, ref, sorted(r_gemms), sorted(r_chains), totals,
                 path="train_rwkv6", phases={**r_gemms, **r_chains},
                 time_dtypes=("bfloat16",))
    emit("kernel_totals_rwkv6", ok=True,
         train_geometries={"gemm": len(r_gemms), "chain": len(r_chains),
                           "einsum_ops": r_einsum_ops},
         sums={name: {k: (sorted(v) if isinstance(v, set) else v)
                      for k, v in totals[name]["train_rwkv6"].items()}
               for name in ALL_KERNELS if "train_rwkv6" in totals[name]})

    # -- 12. rwkv6_7b training at full width and depth --------------------------
    launches["train_rwkv6"] = train_model_phase(
        torch, fc, plan_compiler, train_cli, r_einsum_ops,
        name="train_rwkv6", arch_id=RWKV_ARCH, steps=RWKV_STEPS, lr=RWKV_LR,
        num_layers=RWKV_TRAIN_LAYERS)

    # -- 13. the scan's final state through prefill -> decode -------------------
    state_phase(torch, fc, lm_mod, cfgbase, name="rwkv6_state",
                arch_id=RWKV_ARCH)

    # -- 14. the GEMM at rwkv6's geometries against einsum, in f32 --------------
    ssm_parity_phase(torch, fc, r_arch, steps_lib, name="rwkv6_parity")

    # -- 15. the kernels at zamba2_7b's main-path shapes --------------------------
    z_arch = cfgbase.get(ZAMBA_ARCH)
    z_cfg = z_arch.model(z_arch.tnn_one_card)
    z_einsum_ops = zamba2_kernel_phase(torch, fc, fa, sk, ref, plan_compiler,
                                       profiles, tensorized, z_cfg, totals)

    # -- 16. zamba2_7b training at full width and depth -------------------------
    launches["train_zamba2"] = train_model_phase(
        torch, fc, plan_compiler, train_cli, z_einsum_ops,
        name="train_zamba2", arch_id=ZAMBA_ARCH, steps=ZAMBA_STEPS,
        lr=ZAMBA_LR, tnn_cfg=z_arch.tnn_one_card,
        num_layers=ZAMBA_TRAIN_LAYERS)

    # -- 17. the hybrid's decode state through prefill -> decode ----------------
    state_phase(torch, fc, lm_mod, cfgbase, name="zamba2_state",
                arch_id=ZAMBA_ARCH)

    # -- 18. the GEMM at zamba2's geometries against einsum, in f32 -------------
    ssm_parity_phase(torch, fc, z_arch, steps_lib, name="zamba2_parity")

    # -- 19. zamba2_7b served at full width and depth ---------------------------
    launches["serve_zamba2"] = serve_zamba2_phase(
        torch, fc, plan_compiler, tm, steps_lib, profiles, z_arch,
        ServeEngine, Request)

    # -- 20. the kernels at qwen2_7b's main-path shapes -----------------------
    q_arch = cfgbase.get(QWEN_ARCH)
    q_cfg = q_arch.model(q_arch.tnn_default)
    q_einsum_ops = qwen2_kernel_phase(torch, fc, fa, ref, plan_compiler,
                                      profiles, tensorized, cfgbase, q_cfg,
                                      totals)

    # -- 21. qwen2_7b training at full width and depth ------------------------
    launches["train_qwen2"] = train_model_phase(
        torch, fc, plan_compiler, train_cli, q_einsum_ops,
        name="train_qwen2", arch_id=QWEN_ARCH, steps=QWEN_STEPS, lr=QWEN_LR,
        num_layers=QWEN_TRAIN_LAYERS)

    # -- 22. cuda against einsum at 2 layers; the f32 prefill route -----------
    train_parity_phase(torch, q_arch, steps_lib, name="qwen2_parity",
                       tnn=q_arch.tnn_default, num_layers=STATE_LAYERS,
                       routes=(ServeEngine, Request, fc))

    # -- 23. qwen2_7b served with a bf16 and an fp8 KV cache ------------------
    launches.update(serve_qwen2_phase(
        torch, fc, plan_compiler, tm, steps_lib, profiles, kv_cache,
        QuantPolicy, q_arch, ServeEngine, Request))

    # -- 24. the batched kernels at olmoe_1b_7b's expert geometries -----------
    o_arch = cfgbase.get(OLMOE_ARCH)
    o_cfg = o_arch.model(dataclasses.replace(o_arch.tnn_default,
                                             backend="cuda"))
    o_plans = olmoe_kernel_phase(torch, fc, fa, ref, plan_compiler,
                                 profiles, tensorized, o_cfg, totals)

    # -- 25. olmoe_1b_7b training at full width and depth ---------------------
    launches["train_olmoe"] = train_model_phase(
        torch, fc, plan_compiler, train_cli, o_plans["einsum_ops"],
        name="train_olmoe", arch_id=OLMOE_ARCH, steps=OLMOE_STEPS,
        lr=OLMOE_LR, batched_per_step=o_plans["per_step"])
    # ... and at the chain rank, 2 layers: the batched chain on the path
    launches["train_olmoe_rank8"] = train_model_phase(
        torch, fc, plan_compiler, train_cli, o_plans["einsum_ops"],
        name="train_olmoe_rank8", arch_id=OLMOE_ARCH,
        steps=OLMOE_CHAIN_STEPS, lr=OLMOE_LR,
        tnn_cfg=dataclasses.replace(o_arch.tnn_default,
                                    rank=OLMOE_CHAIN_RANK),
        num_layers=STATE_LAYERS, batched_per_step=o_plans["rank8_per_step"])

    # -- 26. cuda against einsum at 2 layers; routing; the f32 prefill route --
    train_parity_phase(torch, o_arch, steps_lib, name="olmoe_parity",
                       tnn=o_arch.tnn_default, num_layers=STATE_LAYERS,
                       routes=(ServeEngine, Request, fc), routing=True)

    # -- 27. olmoe_1b_7b served at full width and depth; its step profile ----
    launches["serve_olmoe"], o_model = serve_olmoe_phase(
        torch, fc, plan_compiler, tm, steps_lib, profiles, o_arch,
        ServeEngine, Request)
    o_prof = train_profile.profile("bf16", 1.0, OLMOE_ARCH, model=o_model,
                                   warmup=OLMOE_PROFILE_STEPS[0],
                                   steps=OLMOE_PROFILE_STEPS[1])
    del o_model
    emit("olmoe_profile", ok=o_prof["device_busy_ms_per_step"]
         != "not measured", **o_prof)

    # -- 27a. olmoe_1b_7b's quantized experts: the instance-batched B3-B6 ----
    of_plans = olmoe_fp8_kernel_phase(torch, fc, qk, ref, quant, QuantPolicy,
                                      o_cfg, plan_compiler, profiles,
                                      tensorized, totals)

    # -- 27b. fp8 training at full width; its profile; rank 8 (chains) -------
    launches["train_olmoe_fp8"], of_model = train_model_phase(
        torch, fc, plan_compiler, train_cli, 0, name="train_olmoe_fp8",
        arch_id=OLMOE_ARCH, steps=OLMOE_STEPS, lr=OLMOE_FP8_LR,
        batched_per_step=of_plans["per_step"], num_layers=OLMOE_FP8_LAYERS,
        precision=FP8_POLICY, loss_scale=FP8_LOSS_SCALE, keep_model=True)
    of_prof = train_profile.profile(FP8_POLICY, FP8_LOSS_SCALE, OLMOE_ARCH,
                                    model=of_model,
                                    warmup=OLMOE_PROFILE_STEPS[0],
                                    steps=OLMOE_PROFILE_STEPS[1])
    del of_model
    emit("train_olmoe_fp8_profile", ok=of_prof["device_busy_ms_per_step"]
         != "not measured", layers=OLMOE_FP8_LAYERS, **of_prof)
    launches["train_olmoe_fp8_rank8"] = train_model_phase(
        torch, fc, plan_compiler, train_cli, 0,
        name="train_olmoe_fp8_rank8", arch_id=OLMOE_ARCH,
        steps=OLMOE_CHAIN_STEPS, lr=OLMOE_LR,
        tnn_cfg=dataclasses.replace(o_arch.tnn_default,
                                    rank=OLMOE_CHAIN_RANK),
        num_layers=STATE_LAYERS, batched_per_step=of_plans["rank8_per_step"],
        precision=FP8_POLICY, loss_scale=FP8_LOSS_SCALE)

    # -- 27c. fp8: cuda against einsum at 2 layers, f32 ------------------------
    train_fp8_parity_phase(
        torch, o_arch, steps_lib, QuantPolicy, name="olmoe_fp8_parity",
        tnn=o_arch.tnn_default, num_layers=STATE_LAYERS,
        exact_inputs=[f"layers.0.mlp.experts.{p}.quant_amax"
                      for p in ("gate", "up")], amax_metric="leaf")

    # -- 28. the kernels at seamless_m4t_medium's main-path shapes ------------
    s_arch = cfgbase.get(SEAMLESS_ARCH)
    s_cfg = s_arch.model(dataclasses.replace(s_arch.tnn_default,
                                             backend="cuda"))
    s_einsum_ops = seamless_kernel_phase(torch, fc, fa, ref, plan_compiler,
                                         profiles, tensorized, cfgbase, s_cfg,
                                         totals)

    # -- 29. seamless_m4t_medium training at full width and depth -------------
    launches["train_seamless"], s_model, s_cfg = train_seamless_phase(
        torch, fc, plan_compiler, memory, modality, steps_lib, s_arch,
        s_einsum_ops)

    # -- 30. ... then served: prefill and greedy decode, two waves ------------
    launches["serve_seamless"] = serve_seamless_phase(
        torch, fc, plan_compiler, modality, steps_lib, s_model, s_cfg)
    s_prof = train_profile.profile("bf16", 1.0, SEAMLESS_ARCH, model=s_model,
                                   warmup=OLMOE_PROFILE_STEPS[0],
                                   steps=OLMOE_PROFILE_STEPS[1])
    del s_model
    emit("seamless_profile", ok=s_prof["device_busy_ms_per_step"]
         != "not measured", **s_prof)

    # -- 31. cuda against einsum at 2 + 2 layers; the f32 decode route -------
    train_parity_phase(
        torch, s_arch, steps_lib, name="seamless_parity",
        tnn=s_arch.tnn_default, num_layers=STATE_LAYERS,
        make_batch=seamless_batches(torch, modality, s_cfg.vocab),
        route_check=seamless_route_check(torch, fc, modality, steps_lib))

    # -- the kernel line ---------------------------------------------------------
    kernels = []
    for name in ALL_KERNELS:
        t = totals[name]
        sums = [t[p] for p in RUNS if p in t]
        by = set().union(*(s_["bound_by"] for s_ in sums))
        lib = [s_["library_ms"] for s_ in sums
               if s_["library_ms"] is not None]
        unfused = [s_["unfused_ms"] for s_ in sums
                   if s_["unfused_ms"] is not None]
        bwd = (sum(launches[r]["matmul_bwd"] for r in RUNS)
               if name == "matmul" else 0)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(launches[r][name] for r in RUNS) + bwd,
            **{f"launches_{r}_run": launches[r][name] for r in RUNS},
            **({"backward_launches": bwd,
                "backward_reduce_launches": sum(
                    launches[r]["matmul_bwd_reduce"] for r in RUNS),
                "backward_launches_per_phase_paths_off_train_step":
                    launches["train_phase_paths_off"]["matmul_bwd"]
                    / TRAIN_STEPS}
               if name == "matmul" else {}),
            "launches_per_phase_paths_off_train_step":
                launches["train_phase_paths_off"][name] / TRAIN_STEPS,
            "phase_paths_off_sums": {
                p: {k: (sorted(v) if isinstance(v, set) else v)
                    for k, v in t[p].items()}
                for p in PP_OFF_PATHS if p in t},
            **({"splitk_reduce_launches": sum(launches[r][name + "_reduce"]
                                              for r in RUNS)}
               if name + "_reduce" in launches["serve"] else {}),
            **({"amax_launches": sum(launches[r][name + "_amax"]
                                     for r in RUNS)}
               if name + "_amax" in launches["serve"] else {}),
            "launches_per_train_step": launches["train"][name] / TRAIN_STEPS,
            "launches_per_fp8_train_step":
                launches["train_fp8"][name] / TRAIN_STEPS,
            "launches_per_rwkv6_train_step":
                launches["train_rwkv6"][name] / RWKV_STEPS,
            "launches_per_zamba2_train_step":
                launches["train_zamba2"][name] / ZAMBA_STEPS,
            "launches_per_qwen2_train_step":
                launches["train_qwen2"][name] / QWEN_STEPS,
            "launches_per_olmoe_train_step":
                launches["train_olmoe"][name] / OLMOE_STEPS,
            "launches_per_olmoe_fp8_train_step":
                launches["train_olmoe_fp8"][name] / OLMOE_STEPS,
            "launches_per_seamless_train_step":
                launches["train_seamless"][name] / SEAMLESS_STEPS,
            "max_abs_err": t["max_abs_err"],
            "ms": sum(s_["ms"] for s_ in sums),
            "plain_ms": sum(s_["plain_ms"] for s_ in sums),
            "bound_ms": sum(s_["bound_ms"] for s_ in sums),
            "bound_by": "bytes" if by == {"bytes"} else "operations",
            "library_ms": sum(lib) if lib else None,
            "unfused_ms": sum(unfused) if unfused else None,
            "library_shapes": sum(s_["library_shapes"] for s_ in sums),
            "ms_on_library_shapes": sum(s_["ms_on_library_shapes"]
                                        for s_ in sums),
            "shapes_timed": sum(s_["shapes"] for s_ in sums)})
    emit("phase_seconds", ok=True, seconds=dict(PHASE_SECONDS),
         total_s=time.perf_counter() - _CLOCK["start"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
