"""Analysis helpers (part-port of ``src/repro/analysis/``)."""
