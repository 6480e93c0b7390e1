"""KV-cache byte accounting for the serving engine's admission control.

Part-port of ``src/repro/serving/kv_cache.py``: :func:`slot_bytes` for a
cache stored in the compute dtype (bf16 on the serving path).  The
quantized KV store (fp8/int8 with running per-layer scales) and
``model_slot_bytes`` for SSM/hybrid models are queued in ROADMAP.md.
Bytes are modeled from shapes, not measured from the allocator, which
keeps admission deterministic across devices.
"""

from __future__ import annotations


def slot_bytes(cfg, max_len: int) -> dict[str, int]:
    """Modeled device bytes one batch slot's KV cache occupies:
    ``2 * L * max_len * KV * hd`` elements at the compute dtype's width."""
    c = cfg
    elems = 2 * c.num_layers * max_len * c.num_kv_heads * c.hd
    width = c.compute_dtype.itemsize
    return {"payload": elems * width, "meta": 0, "total": elems * width}
