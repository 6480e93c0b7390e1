"""Memory-aware execution planning (port of ``src/repro/memory/``).

* :mod:`.stash` — :class:`StashPolicy` (``store | recompute |
  quantized``): what a tensorized layer keeps from forward to backward.
* :mod:`.planner` — deterministic activation-stash accounting
  (:func:`stash_report`) and budget fitting (:func:`plan_microbatches`,
  :func:`parse_budget`).
* :mod:`.probe` — the card's measured peak, with the modeled fallback on
  the CPU.

The per-plan half of the model (the live-tensor peak of one contraction
schedule) is :func:`repro_torch.core.perf_model.peak_bytes` and enters
CSSE as ``SearchOptions.memory_budget``.
"""

from repro_torch.memory.planner import (
    MemoryReport, StashSite, format_bytes, parse_budget, plan_microbatches,
    stash_report, tnn_stash_sites,
)
from repro_torch.memory.probe import (
    ProbeResult, device_memory_stats, measure, probe_plan, probe_training,
)
from repro_torch.memory.stash import STORE, StashPolicy

__all__ = [
    "MemoryReport", "ProbeResult", "STORE", "StashPolicy", "StashSite",
    "device_memory_stats", "format_bytes", "measure", "parse_budget",
    "plan_microbatches", "probe_plan", "probe_training", "stash_report",
    "tnn_stash_sites",
]
