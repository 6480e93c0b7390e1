"""Roofline helpers (part-port of ``src/repro/analysis/roofline.py``).

Only :func:`ring_allreduce_bytes` is needed so far: the perf model's
collective term prices a sharded contraction's deferred all-reduce with
it.  The whole-model roofline report is queued in ROADMAP.md.
"""

from __future__ import annotations


def ring_allreduce_bytes(payload_bytes: int, num_devices: int) -> int:
    """Per-device bytes of a ring all-reduce over ``num_devices``:
    reduce-scatter + all-gather each move ``(n-1)/n`` of the payload."""
    if num_devices <= 1:
        return 0
    return 2 * (num_devices - 1) * payload_bytes // num_devices
