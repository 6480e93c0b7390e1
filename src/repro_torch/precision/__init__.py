"""Precision policies (part-port of ``src/repro/precision/``)."""

from repro_torch.precision.policy import AMAX_KEY, QuantPolicy

__all__ = ["AMAX_KEY", "QuantPolicy"]
