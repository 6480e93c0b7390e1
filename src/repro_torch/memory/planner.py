"""Memory-budget parsing and formatting.

Part-port of ``src/repro/memory/planner.py``: :func:`parse_budget` and
:func:`format_bytes`, which the serving engine's admission control uses.
The activation-stash planner serves training and arrives with that slice
(ROADMAP.md, queue A).
"""

from __future__ import annotations

import re

_UNITS = {"b": 1, "kb": 2 ** 10, "mb": 2 ** 20, "gb": 2 ** 30,
          "kib": 2 ** 10, "mib": 2 ** 20, "gib": 2 ** 30}


def parse_budget(value) -> int | None:
    """``"64MB"`` / ``"1.5gb"`` / ``4096`` / ``None`` -> bytes (binary
    units: 1MB == 2**20)."""
    if value is None:
        return None
    if isinstance(value, (int, float)):
        return int(value)
    m = re.fullmatch(r"\s*([0-9.]+)\s*([a-zA-Z]*)\s*", str(value))
    if not m:
        raise ValueError(f"cannot parse memory budget {value!r}")
    num, unit = float(m.group(1)), m.group(2).lower() or "b"
    if unit not in _UNITS:
        raise ValueError(f"unknown memory unit {unit!r} in {value!r} "
                         f"(expected one of {sorted(_UNITS)})")
    return int(num * _UNITS[unit])


def format_bytes(n: int) -> str:
    for unit, width in (("GB", 2 ** 30), ("MB", 2 ** 20), ("KB", 2 ** 10)):
        if n >= width:
            return f"{n / width:.2f}{unit}"
    return f"{n}B"
