"""Model definitions (port of ``src/repro/models/``, serving path)."""
