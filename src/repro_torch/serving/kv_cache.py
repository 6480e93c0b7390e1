"""KV-cache byte accounting for the serving engine's admission control.

Part-port of ``src/repro/serving/kv_cache.py``: :func:`slot_bytes` for a
cache stored in the compute dtype (bf16 on the serving path), and
:func:`model_slot_bytes` for any model (the SSM and hybrid ones
included).  The quantized KV store (fp8/int8 with running per-layer
scales) is queued in ROADMAP.md.  Bytes are modeled from shapes, not
measured from the allocator, which keeps admission deterministic across
devices.
"""

from __future__ import annotations

import torch


def slot_bytes(cfg, max_len: int) -> dict[str, int]:
    """Modeled device bytes one batch slot's KV cache occupies:
    ``2 * L * max_len * KV * hd`` elements at the compute dtype's width."""
    c = cfg
    elems = 2 * c.num_layers * max_len * c.num_kv_heads * c.hd
    width = c.compute_dtype.itemsize
    return {"payload": elems * width, "meta": 0, "total": elems * width}


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, tuple):
        for t in tree:
            yield from _leaves(t)


def model_slot_bytes(model, max_len: int) -> int:
    """Per-slot cache bytes for any model: the bytes of every tensor of
    ``model.init_cache(1, max_len)`` (the reference prices the same
    shapes abstractly)."""
    return sum(t.numel() * t.element_size()
               for t in _leaves(model.init_cache(1, max_len)))
