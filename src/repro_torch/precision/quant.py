"""Quantize / dequantize reference ops and the quantized-tensor container.

Port of ``src/repro/precision/quant.py``.  These are the semantics of the
precision subsystem, in plain torch ops, used by the einsum executor
(``contraction.execute(..., policy=...)``), by the plan compiler's
quantized dispatch on the CPU and for the pieces that get no kernel
(1-D input nodes, the tile-to-tensor collapse), and as the oracle the
quantize / dequantize / requantize kernels
(:mod:`repro_torch.kernels.quantized`) are held to.  On the card the plan
compiler requantizes every op's result through the requantize kernel,
not through :func:`quantize`.

A :class:`QTensor` is storage dtype + scale: ``x ≈ q.float() * scale``
with ``scale`` an f32 scalar (per tensor) or a ``[G]`` vector of
leading-axis row-group scales (``granularity="tile"``).  Contracted axes
never carry varying scales, which is what lets the GEMM kernels apply
scales as an output epilogue.  fp8 and int8 tensors take no arithmetic in
torch (no fp8 ``abs``/``matmul`` on the CPU): every op here upcasts to
f32 first.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from repro_torch import telemetry as tm
from repro_torch.precision.policy import (
    QuantPolicy, amax_of, compute_scale, tile_amax,
)


def _observe_saturation(x: torch.Tensor, scale: torch.Tensor,
                        policy: QuantPolicy) -> None:
    """Count delayed-scaling saturation: a caller's (history-derived)
    scale too small for this step's values means :func:`_cast` is about
    to clip.  Reads two values on the host, so it runs only while
    telemetry is on."""
    if not tm.enabled():
        return
    limit = float(scale.float().amax()) * policy.qmax
    amax = float(amax_of(x))
    if amax > limit:
        tm.inc("quant.amax_saturation")
        tm.event("quant.amax_saturation", amax=amax, limit=limit,
                 dtype=policy.dtype)


def expand_row_scales(scale: torch.Tensor, rows: int) -> torch.Tensor:
    """``[rows, 1]`` f32 per-row scales from a scalar or ``[G]`` group
    vector — the one form every kernel takes.  Group vectors repeat over
    contiguous row blocks."""
    scale = torch.as_tensor(scale, dtype=torch.float32)
    if scale.dim() == 0:
        return scale.reshape(1, 1).expand(rows, 1).contiguous()
    return scale.repeat_interleave(rows // scale.shape[0]).reshape(rows, 1)


@dataclass(frozen=True)
class QTensor:
    """A quantized tensor plus its dequantization scale(s)."""

    q: torch.Tensor              # policy.operand_dtype, original shape
    scale: torch.Tensor          # f32 scalar, or [G] leading-axis groups

    @property
    def per_tensor(self) -> bool:
        return self.scale.dim() == 0

    def row_scales(self) -> torch.Tensor:
        """Scale per leading-axis row, shape ``[rows, 1]`` (f32)."""
        return expand_row_scales(self.scale,
                                 self.q.shape[0] if self.q.dim() else 1)


def _expand(scale: torch.Tensor, shape) -> torch.Tensor:
    """Broadcast a scale against a tensor: a scalar as is; a ``[G]``
    group vector repeated over its leading-axis row groups."""
    if scale.dim() == 0:
        return scale
    reps = shape[0] // scale.shape[0]
    return scale.repeat_interleave(reps).reshape(
        (shape[0],) + (1,) * (len(shape) - 1))


def _cast(x: torch.Tensor, scale: torch.Tensor,
          policy: QuantPolicy) -> torch.Tensor:
    """Scale, saturate to the representable range, cast.  int8 rounds
    half to even (``torch.round``, as ``jnp.round``); fp8 rounding is the
    cast itself (nearest even)."""
    y = x.float() / _expand(scale, x.shape)
    y = torch.clamp(y, -policy.qmax, policy.qmax)
    if policy.dtype == "int8":
        y = torch.round(y)
    return y.to(policy.operand_dtype)


def quantize(x: torch.Tensor, policy: QuantPolicy,
             scale: torch.Tensor | None = None) -> QTensor:
    """Quantize per ``policy``; ``scale`` overrides the just-in-time
    amax-derived scale (delayed scaling)."""
    if not policy.quantized:
        raise ValueError("quantize() called with a bf16 (no-op) policy")
    if scale is None:
        if policy.granularity == "tile" and x.dim() >= 1:
            amax = tile_amax(x, policy.tile_rows)
        else:
            amax = amax_of(x)
        scale = compute_scale(amax, policy.qmax, policy.margin)
    else:
        scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
        _observe_saturation(x, scale, policy)
    return QTensor(q=_cast(x, scale, policy), scale=scale)


def dequantize(t: QTensor, dtype=torch.float32) -> torch.Tensor:
    """``q * scale`` back to a real dtype (f32 by default)."""
    return (t.q.float() * _expand(t.scale, t.q.shape)).to(dtype)


def requantize_per_tensor(t: QTensor, policy: QuantPolicy) -> QTensor:
    """Collapse tile scales to one per-tensor scale (dequantize, then
    quantize), for a layout change that would move the row groups."""
    if t.per_tensor:
        return t
    return quantize(dequantize(t), replace(policy, granularity="tensor"))


def quantize_nodes(tensors, policy: QuantPolicy,
                   scales=None) -> list[QTensor]:
    """Quantize every plan input node; ``scales[i]`` (when given and not
    None) is that node's delayed per-tensor scale."""
    return [quantize(x, policy, scale=None if scales is None else scales[i])
            for i, x in enumerate(tensors)]
