"""Quantization policies — the dtype axis of the contraction subsystem.

Part-port of ``src/repro/precision/policy.py``: the :class:`QuantPolicy`
dataclass and :data:`AMAX_KEY`, which the planning stack keys on.  The
serving path runs bf16 only; the scale math, the quantized execution and
the quantized KV cache belong to the precision slice (ROADMAP.md,
queue A), so a quantized policy is accepted here and refused by the
executors that cannot run it yet.
"""

from __future__ import annotations

from dataclasses import dataclass

#: params-dict key of a quantized layer's delayed-scaling amax history
AMAX_KEY = "quant_amax"

#: dtype name -> storage bytes
DTYPES = {"bf16": 2, "fp8_e4m3": 1, "fp8_e5m2": 1, "int8": 1}

#: user-facing aliases accepted by ``QuantPolicy.parse``
ALIASES = {"fp8": "fp8_e4m3", "e4m3": "fp8_e4m3", "e5m2": "fp8_e5m2"}


@dataclass(frozen=True)
class QuantPolicy:
    """How one contraction executes below bf16.  Hashable and cheap to
    carry through ``SearchOptions`` / ``TNNConfig`` / lru_cache keys."""

    dtype: str = "bf16"            # bf16 | fp8_e4m3 | fp8_e5m2 | int8
    granularity: str = "tensor"    # tensor | tile (lhs row groups)
    tile_rows: int = 128           # rows per scale group under "tile"
    amax_history_len: int = 16     # delayed-scaling window
    margin: float = 1.0            # scale headroom multiplier

    def __post_init__(self):
        if self.dtype not in DTYPES:
            raise ValueError(f"unknown quant dtype {self.dtype!r}")
        if self.granularity not in ("tensor", "tile"):
            raise ValueError(f"unknown granularity {self.granularity!r}")
        if self.tile_rows <= 0 or self.amax_history_len <= 0:
            raise ValueError("tile_rows and amax_history_len must be > 0")

    @property
    def quantized(self) -> bool:
        return self.dtype != "bf16"

    @property
    def dtype_bytes(self) -> int:
        return DTYPES[self.dtype]

    def signature_payload(self) -> tuple:
        """Hash-stable tuple for disk-cache signatures."""
        return (self.dtype, self.granularity, self.tile_rows,
                self.amax_history_len, self.margin)

    @classmethod
    def parse(cls, name: str) -> "QuantPolicy":
        """``fp8`` / ``fp8_e5m2:tile`` / ``int8`` / ``bf16`` -> policy."""
        name = name.strip().lower()
        gran = "tensor"
        if ":" in name:
            name, gran = name.split(":", 1)
        name = ALIASES.get(name, name)
        if name not in DTYPES:
            raise ValueError(
                f"unknown precision {name!r}; expected one of "
                f"{sorted(DTYPES) + sorted(ALIASES)} (+ optional ':tile')")
        return cls(dtype=name, granularity=gran)
