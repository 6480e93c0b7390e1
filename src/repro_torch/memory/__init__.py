"""Memory policies and budgets (part-port of ``src/repro/memory/``)."""

from repro_torch.memory.planner import format_bytes, parse_budget
from repro_torch.memory.stash import STORE, StashPolicy

__all__ = ["STORE", "StashPolicy", "format_bytes", "parse_budget"]
