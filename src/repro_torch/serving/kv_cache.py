"""Quantized KV-cache storage and byte accounting for the serving engine.

Port of ``src/repro/serving/kv_cache.py``.  Decode streams the whole K/V
cache once a tick, so its storage dtype sets both a slot's device
footprint (what admission prices) and the decode's bytes.
:func:`quantize_kv` stores the stacked ``[L, B, T, KV, hd]`` buffers in
a :class:`~repro_torch.precision.policy.QuantPolicy` dtype (fp8_e4m3,
fp8_e5m2 or int8: half of bf16) with one f32 scale per layer per
tensor; the engine converts at the tick boundary: dequantize, model
step, requantize.

Scales come from a running per-layer amax that only grows (``new =
max(old, amax(tick))``).  While it is unchanged, dequantize then
requantize is bit-stable (values land back on their lattice points), so
repeated ticks do not random-walk the cache; a tick that grows it
re-grids once, within one quantization step.

The reference writes this in plain jnp (no Pallas kernel), so torch ops
stand in here on either device.  The cast is the reference's: ``x / scale``
as a true divide by the f32 scale tensor (``compute_scale``), clipped to
``±qmax``, rounded for int8, then cast.

:func:`slot_bytes` and :func:`model_slot_bytes` are modeled from shapes
and dtypes, not measured from the allocator, which keeps admission
deterministic across devices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.precision.policy import QuantPolicy, compute_scale


class QuantKV(NamedTuple):
    """Quantized stacked K/V buffers and their running per-layer amax:
    ``qk``/``qv`` ``[L, B, T, KV, hd]`` in the policy's storage dtype,
    ``k_amax``/``v_amax`` ``[L]`` f32, monotone over the batch's life."""

    qk: torch.Tensor
    qv: torch.Tensor
    k_amax: torch.Tensor
    v_amax: torch.Tensor


def _layer_amax(x: torch.Tensor) -> torch.Tensor:
    """Per-layer amax of a stacked ``[L, ...]`` buffer -> ``[L]`` f32."""
    return x.float().abs().amax(dim=tuple(range(1, x.dim())))


def _layer_scales(amax: torch.Tensor, policy: QuantPolicy, ndim: int
                  ) -> torch.Tensor:
    """``[L]`` scales shaped to broadcast against a ``[L, ...]`` buffer."""
    scale = compute_scale(amax, policy.qmax, policy.margin)
    return scale.reshape((-1,) + (1,) * (ndim - 1))


def quantize_kv(k: torch.Tensor, v: torch.Tensor, policy: QuantPolicy,
                prev: QuantKV | None = None) -> QuantKV:
    """Quantize stacked K/V buffers with running per-layer scales;
    ``prev`` (the previous tick's :class:`QuantKV`) carries the amax
    forward, which is what keeps the scales monotone."""
    if not policy.quantized:
        raise ValueError("quantize_kv() with a bf16 (no-op) policy")
    k_amax, v_amax = _layer_amax(k), _layer_amax(v)
    if prev is not None:
        k_amax = torch.maximum(prev.k_amax, k_amax)
        v_amax = torch.maximum(prev.v_amax, v_amax)

    def cast(x, amax):
        y = x.float() / _layer_scales(amax, policy, x.dim())
        y = torch.clamp(y, -policy.qmax, policy.qmax)
        if policy.dtype == "int8":
            y = torch.round(y)
        return y.to(policy.operand_dtype)

    return QuantKV(qk=cast(k, k_amax), qv=cast(v, v_amax),
                   k_amax=k_amax, v_amax=v_amax)


def dequantize_kv(qkv: QuantKV, policy: QuantPolicy,
                  dtype: torch.dtype = torch.bfloat16
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Back to the compute dtype: ``(k, v)``, each ``[L, B, T, KV, hd]``."""
    k = qkv.qk.float() * _layer_scales(qkv.k_amax, policy, qkv.qk.dim())
    v = qkv.qv.float() * _layer_scales(qkv.v_amax, policy, qkv.qv.dim())
    return k.to(dtype), v.to(dtype)


# ---------------------------------------------------------------------------
# Byte accounting (modeled; what admission control prices)
# ---------------------------------------------------------------------------


def slot_bytes(cfg, max_len: int,
               policy: QuantPolicy | None = None) -> dict[str, int]:
    """Modeled device bytes one batch slot's KV cache occupies:
    ``payload`` the K+V tokens (``2 * L * max_len * KV * hd`` elements at
    the storage dtype, half of bf16's under fp8/int8), ``meta`` the
    per-layer f32 amaxes a quantized cache adds (none for bf16)."""
    c = cfg
    elems = 2 * c.num_layers * max_len * c.num_kv_heads * c.hd
    if policy is not None and policy.quantized:
        width = policy.dtype_bytes
        meta = 2 * c.num_layers * 4          # k_amax + v_amax, f32 each
    else:
        width = c.compute_dtype.itemsize
        meta = 0
    return {"payload": elems * width, "meta": meta,
            "total": elems * width + meta}


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
