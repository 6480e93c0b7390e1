"""Training data (port of ``src/repro/data/``)."""
