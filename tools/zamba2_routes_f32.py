#!/usr/bin/env python3
"""``chip_smoke.py``'s ``serve_zamba2`` phase in f32, on one CUDA card.

    python3 tools/zamba2_routes_f32.py

``zamba2_7b`` at full width and depth (81 layers, its one-card TNN
config, 374,829,056 parameters), f32 compute, ``cuda`` backend, through
``ServeEngine`` at the serve defaults (the sequential ``decode_step``
route), against a hand-rolled ``decode_step`` loop (gated, as in
``chip_smoke.py``) and against the full-sequence route, ``prefill`` then
``decode_step`` (reported as ``prefill_route_leading_tokens_equal``: how
many of request 0's 16 greedy tokens the two routes share).  In bf16 the
routes share 4 of 16; in f32, roundoff alone should not part them.
Prints the phase's JSON line (``serve_zamba2_f32``) and the card's name
and power limit.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as cs
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import telemetry as tm
    from repro_torch.configs import base as cfgbase
    from repro_torch.core import plan_compiler
    from repro_torch.kernels import build, fused_contraction as fc
    from repro_torch.launch import steps as steps_lib
    from repro_torch.serving import profiles
    from repro_torch.serving.engine import Request, ServeEngine

    build.build_all()
    cs.serve_zamba2_phase(torch, fc, plan_compiler, tm, steps_lib, profiles,
                          cfgbase.get(cs.ZAMBA_ARCH), ServeEngine, Request,
                          name="serve_zamba2_f32",
                          compute_dtype=torch.float32)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
