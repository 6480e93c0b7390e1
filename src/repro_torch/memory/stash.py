"""Stash policies — what a tensorized layer keeps from forward to backward.

Part-port of ``src/repro/memory/stash.py``: the :class:`StashPolicy`
dataclass and :data:`STORE`, which enter every execution-policy cache
signature, and the residual pack/unpack functions :func:`stash` /
:func:`unstash` / :func:`stashed_amax` the tensorized layer's backward
reads.  ``store`` and ``recompute`` keep the activation as is
(``recompute`` is realised by the model's per-layer
``torch.utils.checkpoint``, which drops the residual and re-runs the
forward).  ``quantized`` keeps an fp8/int8 payload, its f32 scale and the
f32 amax of the activation; under a quantized execution policy whose
delayed scale it pins, it is lossless: the WG phase would have quantized
the activation with the same scale anyway.  :meth:`StashPolicy.stash_bytes`
and :meth:`StashPolicy.meta_bytes` are the byte accounting the planner
(:mod:`repro_torch.memory.planner`) sums.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.precision import quant
from repro_torch.precision.policy import (
    ALIASES, DTYPES, QuantPolicy, compute_scale, lead_amax,
)

MODES = ("store", "recompute", "quantized")


@dataclass(frozen=True)
class StashPolicy:
    """How a tensorized layer stores its activation residual."""

    mode: str = "store"            # store | recompute | quantized
    dtype: str = "fp8_e4m3"        # quantized mode: stash storage dtype

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown stash mode {self.mode!r}; "
                             f"expected one of {MODES}")
        if self.dtype not in DTYPES or self.dtype == "bf16":
            raise ValueError(
                f"unknown stash dtype {self.dtype!r}; expected one of "
                f"{sorted(d for d in DTYPES if d != 'bf16')}")

    @property
    def quantized(self) -> bool:
        return self.mode == "quantized"

    @property
    def quant_policy(self) -> QuantPolicy:
        """The per-tensor quantization policy backing a quantized stash."""
        return QuantPolicy(dtype=self.dtype, granularity="tensor")

    def stash_bytes(self, elems: int, compute_dtype) -> int:
        """Activation-payload bytes this policy keeps for an
        ``elems``-element activation: none under ``recompute`` (the
        planner counts the layer input at the checkpoint boundary), the
        stash dtype's width under ``quantized`` (its f32 scale and amax
        are :meth:`meta_bytes`), the compute dtype's under ``store``."""
        if self.mode == "recompute":
            return 0
        if self.mode == "quantized":
            return elems * DTYPES[self.dtype][1]
        return elems * compute_dtype.itemsize

    def meta_bytes(self) -> int:
        """Per-stash scalar metadata (f32 scale + amax under quantized)."""
        return 8 if self.mode == "quantized" else 0

    def tag(self) -> str:
        return self.mode if not self.quantized else f"quantized:{self.dtype}"

    @classmethod
    def parse(cls, name: str) -> "StashPolicy":
        """``store`` / ``recompute`` / ``quantized[:fp8_e4m3|int8|...]``."""
        name = name.strip().lower()
        dtype = "fp8_e4m3"
        if ":" in name:
            name, dtype = name.split(":", 1)
            dtype = ALIASES.get(dtype, dtype)
        return cls(mode=name, dtype=dtype)


#: default policy — the activation stored as is
STORE = StashPolicy()


def stash(x: torch.Tensor, policy: StashPolicy,
          scale: torch.Tensor | None = None, lead: int = 0) -> tuple:
    """Pack ``x`` into this policy's residual ``(payload, scale, amax)``:
    ``scale`` and ``amax`` are f32 scalars under ``quantized`` and None
    otherwise.  ``scale`` (delayed scaling) pins the quantization scale,
    so the backward's re-quantization reproduces the forward's bits.
    ``lead``: the first ``lead`` axes index instances (a MoE's (expert,
    group) instances), each stashed with its own amax and scale (shape
    ``x.shape[:lead]``), as the reference's stash under ``jax.vmap``."""
    if not policy.quantized:
        return (x, None, None)
    amax = lead_amax(x, lead)
    if scale is None:
        scale = compute_scale(amax, policy.quant_policy.qmax)
    qt = quant.quantize(x, policy.quant_policy, scale=scale, lead=lead)
    return (qt.q, qt.scale, amax)


def unstash(res: tuple, policy: StashPolicy, dtype=None,
            lead: int = 0) -> torch.Tensor:
    """Reconstruct the activation from a :func:`stash` residual
    (dequantized to ``dtype``, f32 by default, under ``quantized``)."""
    payload, scale, _ = res
    if not policy.quantized:
        return payload
    return quant.dequantize(quant.QTensor(q=payload, scale=scale,
                                          lead=lead),
                            dtype or torch.float32)


def stashed_amax(res: tuple, x_hat: torch.Tensor,
                 lead: int = 0) -> torch.Tensor:
    """The amax for history updates: the exact forward amax when
    stashed, else the amax of the reconstructed activation (one per
    instance of its ``lead`` axes)."""
    amax = res[2]
    return amax if amax is not None else lead_amax(x_hat, lead)
