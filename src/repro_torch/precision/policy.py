"""Quantization policies — the dtype axis of the contraction subsystem.

Port of ``src/repro/precision/policy.py``.  A :class:`QuantPolicy` names
what the contraction executor stores and streams: ``bf16`` (a no-op
policy), ``fp8_e4m3`` / ``fp8_e5m2`` (``torch.float8_e4m3fn`` /
``torch.float8_e5m2``, amax range 448 / 57344) or ``int8`` (symmetric).
Accumulation is always f32; the policy only changes the operand and
storage dtype.

Scaling granularity: ``tensor`` (one f32 scale per tensor) or ``tile``
(one scale per group of ``tile_rows`` leading-axis rows; the rhs of a
contraction stays per tensor).  Scales come from amax:
``scale = amax * margin / qmax``.  Training uses delayed scaling: the
scale comes from a rolling amax history (:func:`scale_from_history`)
carried through ``TensorizedLinear``'s autograd Function.  All scale math
runs in f32 on the tensor's device and never reads a value on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

#: params-dict key of a quantized layer's delayed-scaling amax history
AMAX_KEY = "quant_amax"

#: dtype name -> (torch dtype, storage bytes, qmax = largest |x|)
DTYPES = {
    "bf16": (torch.bfloat16, 2, None),
    "fp8_e4m3": (torch.float8_e4m3fn, 1, 448.0),
    "fp8_e5m2": (torch.float8_e5m2, 1, 57344.0),
    "int8": (torch.int8, 1, 127.0),
}

#: user-facing aliases accepted by ``QuantPolicy.parse`` / --tnn-precision
ALIASES = {"fp8": "fp8_e4m3", "e4m3": "fp8_e4m3", "e5m2": "fp8_e5m2"}

_EPS = 1e-12


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
    def operand_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype][0]

    @property
    def dtype_bytes(self) -> int:
        return DTYPES[self.dtype][1]

    @property
    def qmax(self) -> float:
        q = DTYPES[self.dtype][2]
        if q is None:
            raise ValueError("bf16 policy has no quantization range")
        return q

    @property
    def tag(self) -> str:
        """Canonical cache-key string, e.g. ``fp8_e4m3/tensor``."""
        if not self.quantized:
            return ""
        return f"{self.dtype}/{self.granularity}"

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

    @classmethod
    def from_tag(cls, tag: str) -> "QuantPolicy":
        """Inverse of :attr:`tag` (scale parameters at their defaults)."""
        dtype, gran = tag.split("/", 1)
        return cls(dtype=dtype, granularity=gran)


# ---------------------------------------------------------------------------
# Scale math (reference ops, kernels' callers and the autograd state)
# ---------------------------------------------------------------------------


def _f32(x, like: torch.Tensor | None = None) -> torch.Tensor:
    device = like.device if like is not None else None
    return torch.as_tensor(x, dtype=torch.float32, device=device)


#: ``qmax`` as an f32 tensor per (value, device), made on first use
_DIVISORS: dict[tuple[float, torch.device], torch.Tensor] = {}


def _divisor(qmax: float, like: torch.Tensor) -> torch.Tensor:
    key = (float(qmax), like.device)
    if key not in _DIVISORS:
        _DIVISORS[key] = _f32(qmax, like)
    return _DIVISORS[key]


def compute_scale(amax, qmax: float, margin: float = 1.0) -> torch.Tensor:
    """f32 dequantization scale for a tensor (or tile) with given amax:
    ``q = x / scale`` maps ``[-amax, amax]`` onto ``±qmax / margin``; the
    epsilon floor keeps all-zero tensors finite.  ``qmax`` divides as an
    f32 tensor on amax's device, the reference's true divide: torch
    computes a CUDA tensor over a Python number as a multiply by its
    reciprocal.  The divisor is made once per device, so a call copies
    nothing from the host (and can be captured in a CUDA graph)."""
    amax = _f32(amax)
    return torch.clamp(amax, min=_EPS) * margin / _divisor(qmax, amax)


def amax_of(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor amax in f32 (the delayed-scaling statistic)."""
    return x.float().abs().amax()


def tile_amax(x: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """amax per group of ``tile_rows`` leading-axis rows -> shape ``[G]``.
    A leading dim that does not divide into whole groups collapses to one
    group (per-tensor)."""
    rows = x.shape[0]
    g = rows // tile_rows if rows % tile_rows == 0 and rows >= tile_rows else 1
    return x.float().abs().reshape(g, -1).amax(dim=1)


def update_history(hist: torch.Tensor, amax) -> torch.Tensor:
    """Roll the amax window: the newest observation enters at slot 0."""
    amax = _f32(amax, hist).reshape(1)
    return torch.cat([amax, hist[:-1]], dim=0)


def scale_from_history(hist: torch.Tensor, current_amax, qmax: float,
                       margin: float = 1.0) -> torch.Tensor:
    """Delayed scale: max over the history window, bootstrapping from the
    current tensor's amax while the history is still all-zero."""
    h = hist.amax()
    amax = torch.where(h > 0, h, _f32(current_amax, hist))
    return compute_scale(amax, qmax, margin)
