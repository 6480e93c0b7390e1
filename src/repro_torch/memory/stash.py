"""Stash policies — what a tensorized layer keeps from forward to backward.

Part-port of ``src/repro/memory/stash.py``: the :class:`StashPolicy`
dataclass and :data:`STORE`, which enter every execution-policy cache
signature, and the residual pack/unpack pair :func:`stash` /
:func:`unstash` the tensorized layer's backward reads, for the
non-quantized policies.  ``store`` and ``recompute`` keep the activation
as is (``recompute`` is realised by the model's per-layer
``torch.utils.checkpoint``, which drops the residual and re-runs the
forward).  A quantized stash needs the precision slice (ROADMAP.md, queue
A item 3) and raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.precision.policy import ALIASES, DTYPES

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


def _refuse_quantized(policy: StashPolicy) -> None:
    if policy.quantized:
        raise NotImplementedError(
            f"stash policy {policy.tag()!r} needs the quantized stash, "
            "which is not ported yet (ROADMAP.md, queue A item 3: "
            "precision)")


def stash(x: torch.Tensor, policy: StashPolicy) -> tuple:
    """Pack ``x`` into this policy's residual: ``(payload, scale,
    amax)``, with ``scale`` and ``amax`` None for the non-quantized
    policies (the reference's structure)."""
    _refuse_quantized(policy)
    return (x, None, None)


def unstash(res: tuple, policy: StashPolicy, dtype=None) -> torch.Tensor:
    """Reconstruct the activation from a :func:`stash` residual."""
    _refuse_quantized(policy)
    return res[0]
