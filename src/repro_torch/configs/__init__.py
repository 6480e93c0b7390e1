"""Architecture configs (port of ``src/repro/configs/``)."""
