"""The tensor-core chain kernel's launch rule against its alternatives.

    PYTHONPATH=src python -m repro_torch.analysis.chain_probe

At each chain geometry of the ATIS training paths (:data:`GEOMETRIES`:
the bf16 WG chains and the fp8 chains, as ``chip_smoke.py`` enumerates
them and ``tests/test_torch_chain_config.py`` pins them), times
``chain_tc_kernel`` on random operands at the configuration
:func:`~repro_torch.kernels.fused_contraction.chain_config` picks and at
each band in :data:`BANDS` crossed with each warp slice of 1 to
``CHAIN_MAX_WARP_STEPS`` k-steps: a CUDA graph of :data:`INNER` calls
replayed between CUDA events, the median of :data:`REPS` replays, warm
L2 (as ``chip_smoke.py`` times).  Prints one JSON line per geometry with
the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from repro_torch.kernels import fused_contraction as fc

#: (operand type, m0, link shapes): the ATIS WG chains in bf16, the
#: fp8-train chains in e4m3
GEOMETRIES = (
    (torch.bfloat16, 768, ((768, 8), (64, 8))),
    (torch.bfloat16, 768, ((3072, 8), (64, 8))),
    (torch.bfloat16, 3072, ((768, 8), (96, 8))),
    (torch.float8_e4m3fn, 96, ((64, 8), (64, 8))),
    (torch.float8_e4m3fn, 768, ((768, 8), (64, 8))),
    (torch.float8_e4m3fn, 3072, ((768, 8), (96, 8))),
    (torch.float8_e4m3fn, 12288, ((192, 8), (128, 8))),
    (torch.float8_e4m3fn, 12288, ((256, 8), (96, 8))),
)
BANDS = (1, 2, 4)
INNER, REPS = 20, 25


def device_ms(fn) -> float:
    """Median device ms of one ``fn()`` call (graph replays, warm L2)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(INNER):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / INNER)
    return statistics.median(times)


def probe(dtype, m0: int, shapes, gen) -> dict:
    """The chosen configuration's time and every variant's at one
    geometry; a variant the kernel refuses is recorded as its error."""
    x = torch.randn(m0, shapes[0][0], generator=gen, device="cuda").to(dtype)
    ws = [torch.randn(s, generator=gen, device="cuda").to(dtype)
          for s in shapes]
    scales = None
    if dtype.itemsize == 1:
        scales = (torch.ones(m0, 1, device="cuda"),
                  *[torch.ones(1, 1, device="cuda")] * (len(ws) - 2),
                  torch.ones(1, shapes[-1][1], device="cuda"))
    chosen = fc.chain_config_for(x, ws)
    step = 32 // dtype.itemsize
    variants = {}
    orig = fc.chain_config_for
    try:
        for band in BANDS:
            for steps in range(1, fc.CHAIN_MAX_WARP_STEPS + 1):
                cfg = chosen._replace(band=band, warp_k=steps * step)
                fc.chain_config_for = lambda *a, cfg=cfg: cfg
                key = f"band{band}_steps{steps}"
                try:
                    variants[key] = device_ms(
                        lambda: fc.chain_n_cuda(x, ws, scales=scales))
                except RuntimeError as err:   # the kernel refused it
                    variants[key] = str(err).splitlines()[0]
    finally:
        fc.chain_config_for = orig
    return {"dtype": str(dtype).split(".")[-1], "m0": m0,
            "links": [list(s) for s in shapes],
            "chosen": {"band": chosen.band,
                       "steps": chosen.warp_k // step,
                       "ms": device_ms(
                           lambda: fc.chain_n_cuda(x, ws, scales=scales))},
            "variants_ms": variants}


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("chain_probe: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, m0, shapes in GEOMETRIES:
        print(json.dumps({"phase": "chain_probe", "card": smi,
                          **probe(dtype, m0, shapes, gen)}), flush=True)


if __name__ == "__main__":
    main()
