"""Peak-memory probe: the card's allocator peak, or a modeled fallback.

Port of ``src/repro/memory/probe.py``.  Two sources, one result type:

* **measured** — on a CUDA device, :func:`measure` synchronises, resets
  the allocator's peak (``torch.cuda.reset_peak_memory_stats``), runs
  the callable, synchronises again and reads
  ``torch.cuda.max_memory_allocated``: the high-water mark of the call,
  net of what was allocated before it.  The reset makes every call
  attributable, so where the reference returns None when an earlier,
  larger workload set the mark, this never does on a card.

* **modeled** — the CPU has no allocator statistics, so there (and only
  there) the probe falls back to deterministic accounting: for a
  contraction plan, :func:`repro_torch.core.perf_model.plan_peak_elems`
  priced at the operand width; for a training step, the planner's stash
  report (:func:`repro_torch.memory.planner.stash_report`).  The same
  config always probes to the same byte count, the reference's.

Every result carries its ``source``, so a modeled number is never passed
off as a measurement.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.core import perf_model
from repro_torch.core.tnetwork import ContractionPlan
from repro_torch.memory.planner import stash_report
from repro_torch.memory.stash import STORE, StashPolicy


@dataclass(frozen=True)
class ProbeResult:
    peak_bytes: int
    source: str                  # "measured:<device name>" | "modeled"
    detail: dict = field(default_factory=dict)

    @property
    def measured(self) -> bool:
        return self.source.startswith("measured")


def _device(device) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def device_memory_stats(device=None) -> dict | None:
    """The CUDA caching allocator's stats of ``device`` (default: the
    current card, if there is one), or None for the CPU, which keeps
    none."""
    d = _device(device)
    if d.type != "cuda":
        return None
    return torch.cuda.memory_stats(d)


def measure(fn: Callable, *args, device=None) -> ProbeResult | None:
    """Run ``fn(*args)`` and report the device peak over the call, net of
    the bytes allocated before it; None on the CPU (callers then fall back
    to a modeled probe: :func:`probe_plan`, :func:`probe_training`).  On a
    CUDA device it always measures."""
    d = _device(device)
    if d.type != "cuda":
        return None
    torch.cuda.synchronize(d)
    resident = torch.cuda.memory_allocated(d)
    torch.cuda.reset_peak_memory_stats(d)
    fn(*args)
    torch.cuda.synchronize(d)
    peak = torch.cuda.max_memory_allocated(d)
    return ProbeResult(peak_bytes=max(0, peak - resident),
                       source=f"measured:{torch.cuda.get_device_name(d)}",
                       detail={"resident_before": resident,
                               "max_memory_allocated": peak})


def probe_plan(plan: ContractionPlan, *, dtype_bytes: int | None = None,
               policy=None, mesh=None, run: Callable | None = None,
               device=None) -> ProbeResult:
    """Peak footprint of executing one contraction plan: measured around
    ``run`` (a zero-argument callable executing the plan) on a card,
    otherwise the modeled live-tensor peak at ``dtype_bytes`` width
    (default: the policy's storage width, else bf16).  ``mesh`` (a
    :class:`~repro_torch.core.perf_model.MeshSpec`) models the per-shard
    view."""
    if run is not None:
        got = measure(run, device=device)
        if got is not None:
            return got
    if dtype_bytes is None:
        dtype_bytes = (policy.dtype_bytes
                       if policy is not None and policy.quantized else 2)
    elems = perf_model.plan_peak_elems(perf_model.localize_plan(plan, mesh))
    return ProbeResult(peak_bytes=elems * dtype_bytes, source="modeled",
                       detail={"elems": elems, "dtype_bytes": dtype_bytes})


def probe_training(cfg, global_batch: int, seq_len: int,
                   microbatches: int = 1, stash: StashPolicy = STORE,
                   run: Callable | None = None, shards: int = 1,
                   device=None) -> ProbeResult:
    """Peak activation memory of one training step of ``cfg``, per
    device: measured around ``run()`` on a card; on the CPU (or without
    ``run``) the planner's stash report.  ``shards`` is the data-parallel
    factor (:func:`repro_torch.memory.planner.stash_report`)."""
    if run is not None:
        got = measure(run, device=device)
        if got is not None:
            return got
    report = stash_report(cfg, global_batch, seq_len, microbatches, stash,
                          shards)
    return ProbeResult(peak_bytes=report.peak_bytes, source="modeled",
                       detail={"layer_bytes": report.layer_bytes,
                               "microbatches": report.microbatches,
                               "shards": report.detail["shards"],
                               "stash": stash.tag()})
